def bag(x):
    return x
