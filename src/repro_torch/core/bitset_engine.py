"""Compatibility shim — the engine lives in `repro_torch.core.engine`.

The port of the reference's `repro.core.bitset_engine`: the engine is
split into layered modules (DESIGN.md §2): `engine.prepare` (host-side
packing/bucketing), `engine.frames` (frame/stack layout + config),
`engine.reductions` (dynamic-reduction lemmas), `engine.pivot` (pivot
strategies), and `engine.loop` (the DFS loops + `run()`); all bitset set
algebra dispatches through `repro_torch.kernels.bitset_ops.ops`.

This module only re-exports the public API under the reference's names,
so code written against the old import path keeps working. New code
should import from `repro_torch.core.engine` directly.
"""
from repro_torch.core.engine.frames import (EngineConfig, Frame,  # noqa: F401
                                            FrameStack)
from repro_torch.core.engine.loop import (MCEResult, enter_call,  # noqa: F401
                                          run, run_bucket, run_root)
from repro_torch.core.engine.pipeline import PrepStream  # noqa: F401
from repro_torch.core.engine.prepare import (PreparedMCE,  # noqa: F401
                                             RootBucket, _unpack_bits_np,
                                             prepare)

# Historical alias (pre-layering underscore name; same signature). The old
# `_enter` is NOT aliased: its signature changed (RootContext replaces the
# A/x_rows/eye/eye_x positionals) — use engine.loop.enter_call.
_run_root = run_root
