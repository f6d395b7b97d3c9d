"""Vertex orderings: exact degeneracy order (host) and parallel k-core
peel (torch device).

The exact order uses the O(n+m) bucket-queue algorithm (Matula & Beck),
host numpy code, the same as the reference package's `graph.order`. The
torch version (`kcore_peel_torch`, the reference's `kcore_peel_jax`)
performs *round-based* peeling: each round removes every vertex whose
residual degree is ≤ the current core level k. Vertices removed in round
order (ties by vertex id) still satisfy the BKdegen invariant |N⁺(v)| ≤ λ,
because at removal time a vertex's residual degree (which upper bounds
its later neighbors, including same-round ones ordered after it) is ≤ k
≤ λ. Like the reference's, it has no caller on the engine's path.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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


def _peel_rounds(src: torch.Tensor, dst: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """Round-based peel on the tensors' device. Returns the peel-round id
    per vertex (int32).

    `src`/`dst`: (2m,) directed edge endpoints (int64). Each round
    recomputes the residual degrees with one O(m) `index_add_` segment
    sum; whether any vertex is alive, and whether any peels at level k,
    are read on the host once per round."""
    dev = src.device
    k, rnd = 0, 0
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    out_round = torch.full((n,), torch.iinfo(torch.int32).max,
                           dtype=torch.int32, device=dev)
    while bool(alive.any()):
        deg = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, src, (alive[dst] & alive[src]).to(torch.int32))
        peel = alive & (deg <= k)
        if not bool(peel.any()):
            k += 1              # nothing peels at level k: raise k
            continue
        out_round = torch.where(peel, rnd, out_round)
        alive = alive & ~peel
        rnd += 1
    return out_round


def kcore_peel_torch(g: CSRGraph, device="cuda") -> np.ndarray:
    """Round-based peel order on a torch device. Returns rank (position)
    per vertex, as the reference's `kcore_peel_jax`.

    Ties within a round broken by vertex id. The resulting order satisfies
    the |N⁺(v)| ≤ λ invariant (see module docstring). `device` defaults to
    "cuda" (torch raises where there is none); pass "cpu" for the host."""
    if g.n == 0:
        return np.zeros(0, dtype=np.int64)
    src = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees())
    rounds = _peel_rounds(
        torch.from_numpy(src).to(device),
        torch.from_numpy(g.indices.astype(np.int64)).to(device),
        g.n).cpu().numpy()
    order = np.lexsort((np.arange(g.n), rounds))
    rank = np.empty(g.n, dtype=np.int64)
    rank[order] = np.arange(g.n)
    return rank
