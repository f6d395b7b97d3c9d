"""Host-side MCE preparation: containers + the one-shot `prepare()` API.

The actual work — reductions, ordering, staging, packing — lives in the
staged streaming pipeline (`engine.pipeline.PrepStream`, DESIGN.md §6);
this module keeps the fixed-shape containers the device side consumes
and the legacy materializing entry point. Pure numpy (only the reduce
stage's degree-0/1 peel of a large graph runs on the torch device); the
device side consumes packed buckets via `engine.loop`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.pack import popcount_sum

WORD = 32


@dataclasses.dataclass
class RootBucket:
    """Fixed-shape batch of root subproblems sharing one padding."""

    u_pad: int                      # padded universe size (multiple of 32)
    x_pad: int                      # padded X0 row count
    a: np.ndarray                   # (R, U, W) uint32 induced adjacency
    p0: np.ndarray                  # (R, W) uint32 initial candidate bitset
    x_rows: np.ndarray              # (R, XC, W) uint32 X0 row bitsets
    x_alive0: np.ndarray            # (R, XC) bool
    roots: np.ndarray               # (R,) int64 original vertex ids
    rsz0: np.ndarray                # (R,) int32 |R| at entry (>1 for split roots)
    bases: List[tuple]              # per-root base clique vertices
    universes: List[np.ndarray]     # per-root local->global id maps
    cost_order: Optional[np.ndarray] = None   # driver memo: canonical
    # cost-descending root order — cached so service-style replays of a
    # cached bucket skip the O(packed bytes) cost rescan
    cost_skew: Optional[float] = None  # driver memo: max/mean of the real
    # (unpadded) root costs — the engine="auto" signal, cached with
    # cost_order for the same replay reason
    n_pad: int = 0                  # trailing no-op pad roots (remainder
    # flushes padded to pow2 fractions of stream_roots; each contributes
    # exactly one engine call and nothing else — callers subtract)

    @property
    def num_roots(self) -> int:
        return len(self.roots)


def estimate_costs(bucket: RootBucket) -> np.ndarray:
    """Per-root cost proxy: |P| * (1 + mean induced degree)^2.

    The BK subtree size grows with local density; this proxy ranks hub-like
    roots above sparse ones, which is all static balancing needs. Popcounts
    go through the uint8 LUT (`graph.pack.popcount_sum`) — the previous
    `np.unpackbits(bucket.a.view(np.uint8))` materialized 32× the bucket's
    bytes just to sum bits."""
    p_sizes = np.array([len(u) for u in bucket.universes], dtype=np.float64)
    pc = popcount_sum(bucket.a, axis=(1, 2)).astype(np.float64)
    mean_deg = pc / np.maximum(p_sizes, 1)
    return p_sizes * (1.0 + mean_deg) ** 2


@dataclasses.dataclass
class PreparedMCE:
    buckets: List[RootBucket]
    pre_reported: List[frozenset]
    n: int
    degeneracy: int
    order: np.ndarray
    rank: np.ndarray


def _unpack_bits_np(bits: np.ndarray) -> np.ndarray:
    out = []
    for wi, word in enumerate(bits):
        word = int(word)
        while word:
            low = word & -word
            out.append(wi * WORD + low.bit_length() - 1)
            word ^= low
    return np.array(out, dtype=np.int64)


def prepare(g: CSRGraph, *, global_red: bool = True, x_red: bool = True,
            bucket_sizes: Sequence[int] = (32, 64, 128, 256, 512, 1024),
            max_x_rows: int = 8192,
            split_threshold: Optional[int] = None,
            device=None) -> PreparedMCE:
    """Host preprocessing: reductions, ordering, bitset packing, bucketing.

    One-shot wrapper over the streaming pipeline with no mid-stream
    flushes (`stream_roots=0`), which reproduces the legacy layout: one
    `RootBucket` per bucket size, roots in degeneracy order. Roots whose
    |P| exceeds the largest bucket — or whose X rows exceed `max_x_rows`
    — are auto-split one pivot-pruned BK level at a time (recursively)
    instead of raising, so any graph runs without hand-tuning.

    split_threshold: straggler mitigation by over-decomposition — roots
    with |P| > threshold are expanded ONE BK level on the host
    (pivot-pruned branching, exactly Algorithm 2's first level) into
    per-branch subproblems. The search tree is re-dealt at a finer grain
    so one pathological hub cannot stall its whole shard (DESIGN.md §5).

    device: torch device of the reduce stage's device peel (see
    `PrepStream`).
    """
    from repro_torch.core.engine.pipeline import PrepStream

    return PrepStream(g, global_red=global_red, x_red=x_red,
                      bucket_sizes=bucket_sizes, max_x_rows=max_x_rows,
                      split_threshold=split_threshold, stream_roots=0,
                      cache=False, device=device).materialize()
