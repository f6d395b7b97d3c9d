"""EmbeddingBag (multi-hot gather + bag reduce, the recsys substrate): the
plain PyTorch version (`ref`), the Hopper CUDA kernel
(`csrc/embedding_bag.cu`) and its dispatching wrapper (`ops`)."""
