"""Layered bitset Bron–Kerbosch MCE engine in PyTorch (DESIGN.md §2).

The port of `repro.core.engine`, split into the same swappable layers:

* `prepare`    — fixed-shape containers + one-shot materializing API
* `pipeline`   — staged streaming ingest (reduce → order → stage → pack),
                 yielding `RootBucket`s incrementally (`PrepStream`)
* `frames`     — frame/stack layout, config, counter carry
* `reductions` — dynamic degree-0/1/|P|−1 lemmas as pure frame functions
* `pivot`      — pivot/branch-selection strategies behind one interface
* `loop`       — the per-root DFS loop over a bucket's root batch +
                 single-host `run()`

All bitset set algebra dispatches through
`repro_torch.kernels.bitset_ops.ops` (the Hopper CUDA kernels on a CUDA
tensor, plain PyTorch on a CPU tensor).
"""
from repro_torch.core.engine.frames import (BACKENDS,  # noqa: F401
                                            PORTED_BACKENDS, EngineConfig,
                                            Frame, FrameStack)
from repro_torch.core.engine.loop import (MCEResult, dfs_step,  # noqa: F401
                                          enter_call, run, run_bucket,
                                          run_root)
from repro_torch.core.engine.pipeline import PrepStream, RootSpec  # noqa: F401
from repro_torch.core.engine.prepare import (PreparedMCE,  # noqa: F401
                                             RootBucket, estimate_costs,
                                             prepare)
