"""Layered bitset Bron–Kerbosch MCE engine in PyTorch (DESIGN.md §2).

The port of `repro.core.engine`, split into the same swappable layers:

* `prepare`    — fixed-shape containers + one-shot materializing API
* `pipeline`   — staged streaming ingest (reduce → order → stage → pack),
                 yielding `RootBucket`s incrementally (`PrepStream`)
* `frames`     — frame/stack layout, config, counter carry
* `reductions` — dynamic degree-0/1/|P|−1 lemmas as pure frame functions
* `pivot`      — pivot/branch-selection strategies behind one interface
* `loop`       — the per-root DFS loop over a bucket's root batch, the
                 persistent lane engine (refill, steal, stream spans,
                 stack windows) + single-host `run()`

All bitset set algebra dispatches through
`repro_torch.kernels.bitset_ops.ops` (the Hopper CUDA kernels on a CUDA
tensor, plain PyTorch on a CPU tensor).
"""
from repro_torch.core.engine.frames import (BACKENDS,  # noqa: F401
                                            EngineConfig, Frame, FrameStack,
                                            PIVOT_BACKENDS)
from repro_torch.core.engine.loop import (MCEResult,  # noqa: F401
                                          choose_engine, dfs_step,
                                          enter_call, root_cost_skew, run,
                                          run_bucket, run_bucket_persistent,
                                          run_root, run_root_windowed,
                                          run_stream_persistent)
from repro_torch.core.engine.pipeline import PrepStream, RootSpec  # noqa: F401
from repro_torch.core.engine.prepare import (PreparedMCE,  # noqa: F401
                                             RootBucket, estimate_costs,
                                             prepare)
