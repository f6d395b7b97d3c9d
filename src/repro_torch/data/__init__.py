"""Data pipeline: deterministic synthetic streams, the port's own copy of
the reference's `repro.data` (numpy only).

Host-side prefetch workers produce fixed-shape numpy batches; the training
loop moves them to the device. Everything is deterministic in (seed, step)
so an elastic restart replays the exact stream from the checkpoint cursor.
"""
from repro_torch.data.prefetch import Prefetcher  # noqa: F401
from repro_torch.data.tokens import TokenStream, synth_tokens  # noqa: F401
