"""Vertex orderings: exact degeneracy order and core numbers (host).

The exact order uses the O(n+m) bucket-queue algorithm (Matula & Beck).
Host numpy code, the same as the reference package's `graph.order`; the
reference's round-based device peel (`kcore_peel_jax`) has no caller on
the engine's path and is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph


def degeneracy_order(g: CSRGraph) -> Tuple[np.ndarray, np.ndarray, int]:
    """Exact degeneracy order (Matula–Beck bucket queue, O(n+m)).

    Returns (order, rank, degeneracy): order[i] = i-th vertex peeled;
    rank[v] = position of v in order; degeneracy = max residual degree seen.
    """
    n = g.n
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, 0
    deg = g.degrees().astype(np.int64).copy()
    max_deg = int(deg.max())
    # counting sort of vertices by degree — a stable argsort fills the
    # degree buckets in increasing-vertex order, exactly like the classic
    # per-vertex insertion loop but vectorized
    bin_start = np.zeros(max_deg + 2, dtype=np.int64)
    np.add.at(bin_start, deg + 1, 1)
    bin_start = np.cumsum(bin_start)
    vert = np.argsort(deg, kind="stable")
    pos = np.empty(n, dtype=np.int64)
    pos[vert] = np.arange(n)
    bin_ = bin_start[:-1].copy()           # bucket front pointers

    dptr = g.indptr.tolist()
    dind = g.indices.tolist()
    degeneracy = 0
    deg_list = deg.tolist()
    pos_list = pos.tolist()
    bin_list = bin_.tolist()
    vert_list = vert.tolist()
    for i in range(n):
        v = vert_list[i]
        dv = deg_list[v]
        if dv > degeneracy:
            degeneracy = dv
        for u in dind[dptr[v]:dptr[v + 1]]:
            du = deg_list[u]
            if du > dv:
                pu = pos_list[u]
                pw = bin_list[du]
                w = vert_list[pw]
                if u != w:
                    vert_list[pu] = w
                    vert_list[pw] = u
                    pos_list[u] = pw
                    pos_list[w] = pu
                bin_list[du] = pw + 1
                deg_list[u] = du - 1
    order = np.asarray(vert_list, dtype=np.int64)
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    return order, rank, degeneracy


def core_numbers(g: CSRGraph) -> np.ndarray:
    """Host core numbers: core[v] = max k s.t. v is in a k-core."""
    n = g.n
    deg = g.degrees().astype(np.int64).copy()
    core = np.zeros(n, dtype=np.int64)
    removed = np.zeros(n, dtype=bool)
    import heapq

    heap = [(int(d), v) for v, d in enumerate(deg)]
    heapq.heapify(heap)
    k = 0
    while heap:
        d, v = heapq.heappop(heap)
        if removed[v] or d != deg[v]:
            continue
        removed[v] = True
        k = max(k, int(d))
        core[v] = k
        for u in g.neighbors(v):
            if not removed[u]:
                deg[u] -= 1
                heapq.heappush(heap, (int(deg[u]), u))
    return core
