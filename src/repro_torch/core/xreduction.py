"""Maximality-check reduction (paper §6, Algorithm 8) — shared host logic.

Computes, for every root v in degeneracy order, the pruned forbidden set
X'(v) ⊆ N⁻(v) using the ignoreId array, extended with *witness pointers* and
per-root chain resolution.

Why witnesses: Algorithm 8 as printed prunes x whenever ignoreId[x] < i, but
neighbourhood dominations can be cyclic in dense graphs (x dominated by y, y
by z, z by x — all three would be pruned, losing every maximality witness and
emitting non-maximal cliques). We store who dominates whom and, per root,
prune x only if its witness chain terminates at a kept vertex; a cycle
(mutually equal P-neighbourhoods) keeps exactly its min-rank member. This
preserves Lemma 9 exactly — validated against brute force in tests.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set

import numpy as np


def x_prune_roots(adj: Sequence[Set[int]], order: np.ndarray,
                  rank: np.ndarray) -> List[Set[int]]:
    """Return kept_X[i] (set of vertices) for each root position i."""
    n = len(adj)
    ignore_id = np.full(n, n, dtype=np.int64)
    ignore_wit = np.full(n, -1, dtype=np.int64)
    kept: List[Set[int]] = []
    # N⁺(u) depends on u alone; memoize it instead of rebuilding the set for
    # every (root, u) incidence (that rebuild was O(Σ_v Σ_{u∈P(v)} deg(u)),
    # the dominant term of host prep on hub-heavy graphs)
    nup_cache: Dict[int, Set[int]] = {}

    def nu_plus_of(u: int) -> Set[int]:
        s = nup_cache.get(u)
        if s is None:
            ru = rank[u]
            s = {w for w in adj[u] if rank[w] > ru}
            nup_cache[u] = s
        return s

    for i in range(n):
        v = int(order[i])
        if not adj[v]:
            kept.append(set())
            continue
        P = {u for u in adj[v] if rank[u] > i}
        X_full = {u for u in adj[v] if rank[u] < i}
        kept.append(resolve_keeps(X_full, i, ignore_id, ignore_wit, rank))
        for u in P:
            nu_plus = nu_plus_of(u)
            if (P - {u}) <= nu_plus:
                if rank[u] < ignore_id[v]:
                    ignore_id[v] = rank[u]
                    ignore_wit[v] = u
            elif nu_plus <= P:
                if i < ignore_id[u]:
                    ignore_id[u] = i
                    ignore_wit[u] = v
    return kept


def resolve_keeps(X_full: Set[int], i: int, ignore_id: np.ndarray,
                  ignore_wit: np.ndarray, rank: np.ndarray) -> Set[int]:
    """Subset of X_full kept at root rank i (witness-chain resolution)."""
    memo: Dict[int, bool] = {}

    def walk(u: int) -> bool:
        path: List[int] = []
        on_path: Set[int] = set()
        cur = u
        while True:
            if cur in memo or ignore_id[cur] >= i:
                if cur not in memo:
                    memo[cur] = True
                for x in path:
                    memo[x] = False
                break
            if cur in on_path:
                cyc = path[path.index(cur):]
                keep_v = min(cyc, key=lambda x: rank[x])
                for x in path:
                    memo[x] = x == keep_v
                break
            path.append(cur)
            on_path.add(cur)
            cur = int(ignore_wit[cur])
        return memo[u]

    return {x for x in X_full if walk(x)}
