"""Softmax attention forward (the LM substrate): the plain PyTorch version
(`ref`), the Hopper CUDA flash kernel (`csrc/flash_attention.cu`) and its
dispatching wrapper (`ops`)."""
