"""Bitset AND+popcount set algebra: plain PyTorch versions (`ref`), the
Hopper CUDA kernels (`csrc/bitset_ops.cu`, built by `build`) and the one
dispatch point the engine calls (`ops`)."""
