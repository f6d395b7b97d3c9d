"""Common-neighbour existence per edge (the Lemma-4 triangle test): the
plain PyTorch version (`ref`), the Hopper CUDA kernel
(`csrc/common_neighbor.cu`) and its dispatching wrapper (`ops`)."""
