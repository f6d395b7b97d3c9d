"""Message-passing aggregation (the GNN substrate): the plain PyTorch
versions (`ref`), the Hopper CUDA kernel for the batched dense form
(`csrc/segment_spmm.cu`) and the dispatching wrapper (`ops`)."""
