"""Vectorized host-side bitset packing — the ingest hot path.

`prepare()` used to pack every adjacency bitset row with a per-vertex
`np.isin` python loop: O(Σ|P| + Σ|X|) numpy calls per graph, each on a
tiny array, so the device idled behind the host on large graphs. This
module packs a whole bucket of subproblems with a constant number of
vectorized passes:

* universes become one sorted `(subproblem, vertex) → local-rank` key
  table (rank remap);
* CSR adjacency for every member is gathered with the ranges trick
  (`_ranges`), no per-vertex slicing;
* membership of each gathered neighbor in its subproblem's universe is a
  single `searchsorted` sort-merge join;
* rows materialize with one `np.bitwise_or.at` scatter.

A uint8 popcount LUT (`popcount_sum`) serves the driver's cost model
without the 32× `np.unpackbits` memory blowup.

Layering: this module sits in the graph layer — it may import numpy and
`graph.csr` siblings only, never `repro_torch.core`/`repro_torch.kernels`.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

WORD = 32
_U1 = np.uint32(1)
_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def popcount_sum(a: np.ndarray, axis=None) -> np.ndarray:
    """Popcount of a uint32 array summed over `axis` (LUT, no unpackbits).

    `axis` indexes the dims of `a`; the trailing word axis is viewed as
    4 bytes, so summing over the last axis of `a` sums the bytes too.
    Peak extra memory is 1× `a.nbytes` (the uint8 LUT gather), vs 32×
    for ``np.unpackbits(a.view(np.uint8))``.
    """
    a = np.ascontiguousarray(a, dtype=np.uint32)
    per_byte = _POP8[a.view(np.uint8).reshape(a.shape[:-1] + (-1,))]
    return per_byte.sum(axis=axis, dtype=np.int64)


def pack_bits(ids: np.ndarray, words: int) -> np.ndarray:
    """Single bitset: set bit `i` for every i in `ids` (local indices)."""
    out = np.zeros(words, dtype=np.uint32)
    if len(ids):
        ids = np.asarray(ids, dtype=np.int64)
        np.bitwise_or.at(out, ids // WORD,
                         _U1 << (ids % WORD).astype(np.uint32))
    return out


def _ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenated [s, s+c) index ranges (CSR multi-row gather trick)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    shift = starts.astype(np.int64) - np.concatenate(
        ([0], np.cumsum(counts)[:-1]))
    return np.arange(total, dtype=np.int64) + np.repeat(shift, counts)


def prefix_bits(u_sizes: np.ndarray, words: int) -> np.ndarray:
    """(R, words) bitsets with the first u_sizes[k] bits set (vectorized)."""
    u_sizes = np.asarray(u_sizes, dtype=np.int64)
    full = u_sizes // WORD
    rem = u_sizes % WORD
    wi = np.arange(words, dtype=np.int64)[None, :]
    partial = ((np.int64(1) << rem) - 1).astype(np.uint32)[:, None]
    p = np.where(wi < full[:, None], np.uint32(0xFFFFFFFF), np.uint32(0))
    return np.where(wi == full[:, None], partial, p).astype(np.uint32)


def pack_bucket(indptr: np.ndarray, indices: np.ndarray, n: int,
                p_lists: Sequence[np.ndarray],
                x_lists: Sequence[np.ndarray],
                bucket: int) -> Tuple[np.ndarray, np.ndarray,
                                      np.ndarray, np.ndarray]:
    """Pack a bucket of (P, X) subproblems into fixed-shape bitset tensors.

    p_lists[k]/x_lists[k] are global vertex ids in local (rank) order; the
    local index of `p_lists[k][j]` is `j`. Returns `(a, p0, x_rows,
    x_alive)` with shapes `(R, bucket, W)`, `(R, W)`, `(R, XC, W)`,
    `(R, XC)` where `XC` is the pow2 pad of the max per-subproblem count
    of X rows that intersect the universe (all-zero rows are dropped,
    matching the legacy per-row packer bit for bit).
    """
    r = len(p_lists)
    words = bucket // WORD
    if r == 0:
        return (np.zeros((0, bucket, words), np.uint32),
                np.zeros((0, words), np.uint32),
                np.zeros((0, 1, words), np.uint32),
                np.zeros((0, 1), bool))
    u_sizes = np.fromiter((len(p) for p in p_lists), np.int64, count=r)
    uni = np.concatenate([np.asarray(p, np.int64) for p in p_lists])
    u_off = np.concatenate(([0], np.cumsum(u_sizes)))
    uni_sub = np.repeat(np.arange(r, dtype=np.int64), u_sizes)
    uni_loc = np.arange(len(uni), dtype=np.int64) - u_off[uni_sub]

    keys = uni_sub * n + uni                 # unique: (sub, vertex) pairs
    ks = np.argsort(keys)
    keys_s, loc_s = keys[ks], uni_loc[ks]

    def rows_for(members: np.ndarray, sub_of: np.ndarray) -> np.ndarray:
        """(len(members), words) rows: N(member) ∩ universe(sub_of)."""
        starts = indptr[members]
        counts = (indptr[members + 1] - starts).astype(np.int64)
        nbr = indices[_ranges(starts, counts)].astype(np.int64)
        own = np.repeat(np.arange(len(members), dtype=np.int64), counts)
        q = sub_of[own] * n + nbr
        pos = np.minimum(np.searchsorted(keys_s, q), len(keys_s) - 1)
        hit = keys_s[pos] == q
        own, lidx = own[hit], loc_s[pos[hit]]
        out = np.zeros(len(members) * words, np.uint32)
        np.bitwise_or.at(out, own * words + lidx // WORD,
                         _U1 << (lidx % WORD).astype(np.uint32))
        return out.reshape(len(members), words)

    a = np.zeros((r, bucket, words), np.uint32)
    a[uni_sub, uni_loc] = rows_for(uni, uni_sub)
    p0 = prefix_bits(u_sizes, words)

    x_sizes = np.fromiter((len(x) for x in x_lists), np.int64, count=r)
    if int(x_sizes.sum()) == 0:
        return a, p0, np.zeros((r, 1, words), np.uint32), np.zeros((r, 1), bool)
    xs = np.concatenate([np.asarray(x, np.int64) for x in x_lists if len(x)])
    x_sub = np.repeat(np.arange(r, dtype=np.int64), x_sizes)
    x_off = np.concatenate(([0], np.cumsum(x_sizes)))
    raw = rows_for(xs, x_sub)
    keep = raw.any(axis=1)                   # drop rows disjoint from P
    kept_per_sub = np.zeros(r, np.int64)
    np.add.at(kept_per_sub, x_sub[keep], 1)
    xc_raw = max(int(kept_per_sub.max()), 1)
    xc = 1 << (xc_raw - 1).bit_length()      # pow2 pad: bounded recompiles
    cum = np.cumsum(keep.astype(np.int64))
    pre = np.concatenate(([0], cum))
    new_pos = cum - 1 - pre[x_off[x_sub]]    # kept-row rank within its sub
    x_rows = np.zeros((r, xc, words), np.uint32)
    x_alive = np.zeros((r, xc), bool)
    x_rows[x_sub[keep], new_pos[keep]] = raw[keep]
    x_alive[x_sub[keep], new_pos[keep]] = True
    return a, p0, x_rows, x_alive
