"""PyTorch/CUDA port of the reduction-accelerated MCE system.

Mirrors the reference JAX package `repro` module for module
(`repro_torch.core.engine.loop` answers to `repro.core.engine.loop`) and
never imports it or JAX. Entry point: `repro_torch.core.engine.run(g)`,
which runs on the CUDA device unless given `device="cpu"`.
"""
