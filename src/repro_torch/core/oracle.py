"""Reference (oracle) implementations of BK-family MCE and the paper's RMCE.

Pure-Python set-based code. This is the ground truth for:
  * correctness tests of the bitset engine (exact clique-set equality),
  * the paper's counter-based experiments (recursive calls, vertex visits,
    forbidden-set reduction ratios) where instrumentation fidelity matters
    more than wall-time.

Convention (paper Lemma 1): maximal cliques have >= 2 vertices; isolated
vertices are never reported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.order import degeneracy_order


@dataclasses.dataclass
class MCEStats:
    recursive_calls: int = 0
    cliques: int = 0
    vertex_visits: Dict[int, int] = dataclasses.field(default_factory=dict)
    # forbidden-set reduction metrics (root level, paper Fig 10)
    sum_x_before: int = 0
    sum_x_after: int = 0
    subproblems_with_x_reduction: int = 0
    root_subproblems: int = 0
    # global reduction metrics (paper Fig 8)
    deleted_vertices: int = 0
    deleted_edges: int = 0
    pre_reported: int = 0

    def visit(self, vertices) -> None:
        for v in vertices:
            self.vertex_visits[v] = self.vertex_visits.get(v, 0) + 1


def _adj_sets(g: CSRGraph) -> List[Set[int]]:
    return [set(g.neighbors(v).tolist()) for v in range(g.n)]


# --------------------------------------------------------------------------
# Plain BK backends (baselines the paper enhances)
# --------------------------------------------------------------------------

def bk_pivot(g: CSRGraph, stats: Optional[MCEStats] = None,
             collect: bool = True) -> List[FrozenSet[int]]:
    """Tomita-style BK with max-|N(u) ∩ P| pivot, natural top-level call."""
    adj = _adj_sets(g)
    stats = stats if stats is not None else MCEStats()
    out: List[FrozenSet[int]] = []

    def rec(R: Set[int], P: Set[int], X: Set[int]) -> None:
        stats.recursive_calls += 1
        stats.visit(P)
        stats.visit(X)
        if not P and not X:
            if len(R) >= 2:
                stats.cliques += 1
                if collect:
                    out.append(frozenset(R))
            return
        pivot = max(P | X, key=lambda u: len(adj[u] & P))
        for v in list(P - adj[pivot]):
            rec(R | {v}, P & adj[v], X & adj[v])
            P.discard(v)
            X.add(v)

    rec(set(), set(range(g.n)), set())
    return out


def bk_degen(g: CSRGraph, stats: Optional[MCEStats] = None,
             collect: bool = True, backend: str = "pivot") -> List[FrozenSet[int]]:
    """BKdegen [Eppstein et al.]: degeneracy-order roots + BK backend."""
    return _bk_degen_impl(g, stats, collect, backend,
                          global_red=False, dynamic_red=False, x_red=False)


def rmce(g: CSRGraph, stats: Optional[MCEStats] = None, collect: bool = True,
         backend: str = "pivot", global_red: bool = True,
         dynamic_red: bool = True, x_red: bool = True) -> List[FrozenSet[int]]:
    """The paper's RMCE: global + dynamic + maximality-check reductions
    around a BK backend ('pivot' | 'rcd' | 'revised')."""
    return _bk_degen_impl(g, stats, collect, backend,
                          global_red=global_red, dynamic_red=dynamic_red, x_red=x_red)


# --------------------------------------------------------------------------
# Shared degeneracy-rooted driver with optional reductions
# --------------------------------------------------------------------------

def _bk_degen_impl(g: CSRGraph, stats, collect, backend,
                   global_red: bool, dynamic_red: bool, x_red: bool):
    stats = stats if stats is not None else MCEStats()
    out: List[FrozenSet[int]] = []

    if global_red:
        from repro_torch.core.global_reduction import global_reduce_host

        red = global_reduce_host(g)
        g_work = red.graph
        stats.deleted_vertices += red.num_deleted_vertices
        stats.deleted_edges += red.num_deleted_edges
        stats.pre_reported += len(red.reported)
        stats.cliques += len(red.reported)
        if collect:
            out.extend(red.reported)
    else:
        g_work = g

    adj = _adj_sets(g_work)
    order, rank, _ = degeneracy_order(g_work)
    # maximality-check reduction (paper Algorithm 8 + witness chains, see
    # repro_torch.core.xreduction for why plain ignoreId over-prunes)
    kept_x = None
    if x_red:
        from repro_torch.core.xreduction import x_prune_roots

        kept_x = x_prune_roots(adj, order, rank)

    def maybe_dynamic(R: Set[int], P: Set[int], X: Set[int]):
        """Paper Algorithm 7. Mutates copies; returns (R, P, X) or None if
        the subproblem is exhausted by reduction."""
        if not dynamic_red:
            return R, P, X
        marked = set()
        for x in X:
            marked |= adj[x] & P
        degP = {u: len(adj[u] & P) for u in P}  # u ∉ N(u), no self correction
        removed: Set[int] = set()
        # NOTE on soundness: a vertex removed from P *with* an advance report
        # is adjacent to all of R, so the residual R (or R ∪ {partner}) must
        # never surface from the bare (P=∅, X=∅) leaf. We therefore move such
        # vertices into X — the classic BK "visited" semantics with the
        # recursive call replaced by an O(1) report; the usual X ∩ N(·)
        # updates then retire them exactly when they stop extending R.
        # Marked degree-zero vertices are dropped outright (paper Lemma 5(2));
        # the current X ≠ ∅ already blocks the only at-risk leaf.
        to_x: Set[int] = set()
        # dynamic degree-zero (Lemma 5)
        for u in P:
            if degP[u] == 0:
                removed.add(u)
                if u not in marked:
                    _report(R | {u})
                    to_x.add(u)
        # relaxed dynamic degree-one (Lemma 7)
        for u in P:
            if u in removed or degP[u] != 1:
                continue
            (v,) = adj[u] & P
            if v in removed:
                continue
            if u not in marked or v not in marked:
                _report(R | {u, v})
                removed.add(u)
                to_x.add(u)
                if degP.get(v, -1) == 1:
                    removed.add(v)
                    to_x.add(v)
        P = P - removed
        X = X | to_x
        # dynamic degree-(|P|-1) (Lemma 8)
        if P:
            full = {u for u in P if len(adj[u] & P) >= len(P) - 1}
            if full:
                R = R | full
                P = P - full
                for u in full:
                    X = X & adj[u]
        return R, P, X

    def _report(clique: Set[int]) -> None:
        if len(clique) >= 2:
            stats.cliques += 1
            if collect:
                out.append(frozenset(clique))

    def rec_pivot(R: Set[int], P: Set[int], X: Set[int], revised: bool) -> None:
        stats.recursive_calls += 1
        stats.visit(P)
        stats.visit(X)
        R, P, X = maybe_dynamic(R, P, X)
        if not P:
            if not X:
                _report(R)
            return
        pool = P if revised else (P | X)
        pivot = max(pool, key=lambda u: (len(adj[u] & P), -rank[u]))
        for v in sorted(P - adj[pivot], key=lambda u: rank[u]):
            rec_pivot(R | {v}, P & adj[v], X & adj[v], revised)
            P.discard(v)
            X.add(v)

    def rec_rcd(R: Set[int], P: Set[int], X: Set[int]) -> None:
        stats.recursive_calls += 1
        stats.visit(P)
        stats.visit(X)
        R, P, X = maybe_dynamic(R, P, X)
        if not P:
            if not X:
                _report(R)
            return
        # top-down: remove min-degree vertices until P is a clique
        P = set(P)
        X = set(X)
        while True:
            degP = {u: len(adj[u] & P) for u in P}
            if all(d == len(P) - 1 for d in degP.values()):
                break
            v = min(P, key=lambda u: (degP[u], rank[u]))
            rec_rcd(R | {v}, P & adj[v], X & adj[v])
            P.discard(v)
            X.add(v)
        if not any(P <= adj[x] for x in X):
            _report(R | P)

    for i in range(g_work.n):
        v = int(order[i])
        if global_red and not adj[v]:
            continue  # vertex deleted by global reduction: no root subproblem
        P = {u for u in adj[v] if rank[u] > i}
        X_full = {u for u in adj[v] if rank[u] < i}
        stats.root_subproblems += 1
        stats.sum_x_before += len(X_full)
        if x_red:
            X = set(kept_x[i])
            if len(X) < len(X_full):
                stats.subproblems_with_x_reduction += 1
        else:
            X = X_full
        stats.sum_x_after += len(X)
        if backend == "rcd":
            rec_rcd({v}, P, X)
        else:
            rec_pivot({v}, P, X, revised=(backend == "revised"))
    return out


def maximal_cliques_brute(g: CSRGraph) -> Set[FrozenSet[int]]:
    """Exponential brute force over all vertex subsets (tiny graphs only)."""
    from itertools import combinations

    adj = _adj_sets(g)
    cliques: Set[FrozenSet[int]] = set()
    n = g.n
    assert n <= 16, "brute force capped at n=16"
    subsets = []
    for k in range(2, n + 1):
        for comb in combinations(range(n), k):
            if all(b in adj[a] for a, b in combinations(comb, 2)):
                subsets.append(set(comb))
    for s in subsets:
        if not any(s < t for t in map(set, subsets)):
            cliques.add(frozenset(s))
    return cliques
