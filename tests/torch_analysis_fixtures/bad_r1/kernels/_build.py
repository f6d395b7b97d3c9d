def on_cpu(*tensors):
    return True
