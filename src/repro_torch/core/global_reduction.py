"""Global reduction (paper §4): low-degree vertex + non-triangle edge reduction.

Two implementations:

* `global_reduce_host` — numpy/python cascade queue, exact Algorithm 5 + 6
  semantics run to fixpoint (edge deletions re-enqueue new low-degree
  vertices, per the paper's Figure 3 discussion). This is the ingest-stage
  path a production deployment uses, and the path that *enumerates* the
  advance-reported cliques.
* `global_reduce_torch` — fixed-shape, mask-based device path (counting
  mode): returns alive masks for the round-based degree-0/1 peel, on the
  torch device the caller names. `peel_low_degree` takes it for large
  graphs and rebuilds the advance reports on the host.

Both preserve the paper's invariant  mc(G) = mc(G') + α(ΔV, ΔE).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph, from_edge_list


class CliqueReports(Sequence):
    """Lazy, concatenable sequence of advance-reported cliques.

    The vectorized pre-passes report 10^5+ 2-cliques on hub-heavy graphs;
    materializing a frozenset per edge costs ~3µs each — more than the
    entire vectorized sweep. Segments therefore stay as (k, 2) edge
    arrays (or already-built frozenset lists) and rows become frozensets
    only when someone actually enumerates. The counting-mode driver only
    ever calls `len()`, which is O(#segments)."""

    __slots__ = ("_segs",)

    def __init__(self, segments=()):
        self._segs = [s for s in segments if len(s)]

    def __len__(self):
        return sum(len(s) for s in self._segs)

    def __iter__(self):
        for s in self._segs:
            if isinstance(s, np.ndarray):
                for pair in s.tolist():
                    yield frozenset(pair)
            else:
                yield from s

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if i < 0:
            raise IndexError(i)
        for s in self._segs:
            if i < len(s):
                return frozenset(s[i].tolist()) \
                    if isinstance(s, np.ndarray) else s[i]
            i -= len(s)
        raise IndexError(i)

    def __add__(self, other):
        segs = list(self._segs)
        segs += other._segs if isinstance(other, CliqueReports) else [list(other)]
        return CliqueReports(segs)

    def __radd__(self, other):
        if isinstance(other, (list, CliqueReports)):
            return CliqueReports([list(other)] + self._segs)
        return NotImplemented


@dataclasses.dataclass
class GlobalReduction:
    graph: CSRGraph                      # reduced graph G' (original vertex ids)
    reported: List[FrozenSet[int]]       # α(ΔV, ΔE): maximal cliques reported in advance
    num_deleted_vertices: int
    num_deleted_edges: int


def _common_neighbor_exists(adj: dict, u: int, v: int, exclude: int = -1) -> int:
    """Return a common neighbor of u, v other than `exclude`, or -1."""
    a, b = adj[u], adj[v]
    if len(a) > len(b):
        a, b = b, a
    for w in a:
        if w != exclude and w in b:
            return w
    return -1


def global_reduce_host(g: CSRGraph, vertex_rule: bool = True,
                       edge_rule: bool = True) -> GlobalReduction:
    """Cascaded global reduction to fixpoint (Algorithms 5 + 6).

    Only vertices with at least one edge enter the cascade: isolated
    vertices are removed by Lemma 1 with no report and no edge effects,
    and the returned deletion counters are recomputed from the output
    graph anyway — on pre-peeled residual graphs this skips the bulk of
    the queue."""
    idx_list = g.indices.tolist()
    ptr = g.indptr
    active = np.nonzero(np.diff(ptr) > 0)[0]
    adj = {int(v): set(idx_list[ptr[v]:ptr[v + 1]]) for v in active}
    reported: List[FrozenSet[int]] = []
    deleted_v = 0
    deleted_e = 0
    alive = np.ones(g.n, dtype=bool)

    def kill_edge(a: int, b: int) -> None:
        nonlocal deleted_e
        adj[a].discard(b)
        adj[b].discard(a)
        deleted_e += 1

    def kill_vertex(v: int) -> None:
        nonlocal deleted_v, deleted_e
        for u in list(adj[v]):
            adj[u].discard(v)
            deleted_e += 1
        adj[v].clear()
        alive[v] = False
        deleted_v += 1

    if vertex_rule:
        queue = [v for v in adj if len(adj[v]) <= 2]
        in_q = set(queue)
        qi = 0
        while qi < len(queue):
            v = queue[qi]
            qi += 1
            in_q.discard(v)
            if not alive[v]:
                continue
            d = len(adj[v])
            if d > 2:
                continue
            neighbors = list(adj[v])
            if d == 0:
                # Lemma 1: no report (singletons are not cliques)
                alive[v] = False
                deleted_v += 1
            elif d == 1:
                # Lemma 2
                (u,) = neighbors
                reported.append(frozenset((v, u)))
                kill_vertex(v)
                if alive[u] and len(adj[u]) <= 2 and u not in in_q:
                    queue.append(u); in_q.add(u)
            else:
                # Lemma 3
                u, w = neighbors
                if w in adj[u]:
                    reported.append(frozenset((v, u, w)))
                    # delete v and its two edges; if u,w have no other common
                    # neighbor, edge (u,w) must go too (case 2)
                    other = _common_neighbor_exists(adj, u, w, exclude=v)
                    kill_vertex(v)
                    if other < 0:
                        kill_edge(u, w)
                else:
                    reported.append(frozenset((v, u)))
                    reported.append(frozenset((v, w)))
                    kill_vertex(v)
                for t in (u, w):
                    if alive[t] and len(adj[t]) <= 2 and t not in in_q:
                        queue.append(t); in_q.add(t)

    if edge_rule:
        # Non-triangle edge reduction (Algorithm 6), cascading back into
        # vertex reduction for newly created low-degree vertices.
        visited = set()
        edge_stack = [(u, v) for u in adj if alive[u]
                      for v in adj[u] if u < v]
        for (u, v) in edge_stack:
            if v not in adj[u]:
                continue
            key = (u, v)
            if key in visited:
                continue
            w = _common_neighbor_exists(adj, u, v)
            if w < 0:
                reported.append(frozenset((u, v)))
                kill_edge(u, v)
                # cascade into vertex rule
                if vertex_rule:
                    sub_q = [t for t in (u, v) if alive[t] and len(adj[t]) <= 2]
                    while sub_q:
                        t = sub_q.pop()
                        if not alive[t] or len(adj[t]) > 2:
                            continue
                        nbs = list(adj[t])
                        if len(nbs) == 0:
                            alive[t] = False; deleted_v += 1
                        elif len(nbs) == 1:
                            reported.append(frozenset((t, nbs[0])))
                            kill_vertex(t)
                            sub_q.extend(x for x in nbs if alive[x] and len(adj[x]) <= 2)
                        else:
                            a, b = nbs
                            if b in adj[a]:
                                reported.append(frozenset((t, a, b)))
                                other = _common_neighbor_exists(adj, a, b, exclude=t)
                                kill_vertex(t)
                                if other < 0:
                                    kill_edge(a, b)
                            else:
                                reported.append(frozenset((t, a)))
                                reported.append(frozenset((t, b)))
                                kill_vertex(t)
                            sub_q.extend(x for x in nbs if alive[x] and len(adj[x]) <= 2)
            else:
                visited.add((min(u, v), max(u, v)))
                visited.add((min(u, w), max(u, w)))
                visited.add((min(v, w), max(v, w)))

    edges = [(u, v) for u in adj if alive[u] for v in adj[u] if u < v]
    g2 = from_edge_list(g.n, np.array(edges, dtype=np.int64) if edges else np.zeros((0, 2), np.int64))
    # a vertex counts as deleted once it has no remaining edges (it can never
    # appear in a clique of the reduced search)
    return GlobalReduction(
        graph=g2,
        reported=reported,
        num_deleted_vertices=int(np.sum(g2.degrees() == 0)),
        num_deleted_edges=g.m - g2.m,
    )


# --------------------------------------------------------------------------
# Device path (counting mode, fixed shapes)
# --------------------------------------------------------------------------

def global_reduce_torch(src: torch.Tensor, dst: torch.Tensor, n: int,
                        max_rounds: int = 64
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low-degree peel on device: returns (vertex_alive, edge_alive) masks.

    Counting-mode global reduction restricted to the degree-0/1 cascade (the
    degree-2 and edge rules need clique reporting, which the host path owns;
    on device they run inside the bitset engine as dynamic reductions, which
    subsume them at the root level). src/dst are the directed edge lists
    (int64 tensors on the device the peel runs on).

    Each round removes every alive vertex of degree <= 1 and costs one O(m)
    `index_add_` for the new degrees. The loop condition is read on the
    host once per round (one device sync each); at most `max_rounds` rounds
    run, as in the reference's `lax.while_loop`.
    """
    dev = src.device

    def degrees(alive_e):
        return torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, src, alive_e.to(torch.int32))

    alive_v = torch.ones(n, dtype=torch.bool, device=dev)
    alive_e = torch.ones(src.shape, dtype=torch.bool, device=dev)
    deg = degrees(alive_e)
    for _ in range(max_rounds):
        low = alive_v & (deg <= 1)
        if not bool(low.any()):
            break
        alive_v = alive_v & ~low
        alive_e = alive_e & alive_v[src] & alive_v[dst]
        deg = degrees(alive_e)
    return alive_v, alive_e


def _peel_rounds_np(g: CSRGraph, max_rounds: int = 64) -> np.ndarray:
    """Host mirror of `global_reduce_torch`'s round-based deg≤1 peel.

    Identical round semantics (all degree-≤1 vertices removed per round,
    same `max_rounds` early-exit) so small-graph ingest skips the device
    round trip yet produces bit-identical alive masks.
    """
    src = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees())
    dst = g.indices.astype(np.int64)
    alive_v = np.ones(g.n, dtype=bool)
    alive_e = np.ones(len(src), dtype=bool)
    deg = np.bincount(src, minlength=g.n)
    for _ in range(max_rounds):
        low = alive_v & (deg <= 1)
        if not low.any():
            break
        alive_v &= ~low
        alive_e &= alive_v[src] & alive_v[dst]
        deg = np.bincount(src[alive_e], minlength=g.n)
    return alive_v


def peel_low_degree(g: CSRGraph, use_device: Optional[bool] = None,
                    device=None) -> Tuple[CSRGraph, CliqueReports]:
    """Degree-0/1 peel pre-pass for the ingest pipeline.

    Runs the round-based deg≤1 cascade — on device via `global_reduce_torch`
    for large graphs, or its host mirror for small ones — then reconstructs
    the advance reports exactly on the host: in a degree-≤1 cascade every
    edge incident to a peeled vertex is removed at a degree-1 event, and
    Lemma 2 reports that edge as a maximal 2-clique (degree-0 removals
    remove no edges and report nothing). Each undirected edge is reported
    once, which also covers the mutual degree-1 pair that a naive
    per-removal replay would double-report.

    Returns `(residual, reports)` where `residual` keeps the original
    vertex ids (peeled vertices become isolated). The cascade may stop at
    `max_rounds` on pathological path-like graphs; any leftover low-degree
    vertices simply flow into the host cascade downstream, so correctness
    never depends on the peel running to fixpoint. The device path runs on
    `device` (None means "cuda"; it never falls back to the host mirror).
    """
    if g.n == 0 or g.m == 0 or not np.any(g.degrees() == 1):
        # deg-0 removals touch no edges and report nothing, so a graph
        # without degree-1 vertices peels to itself
        return g, CliqueReports()
    if use_device is None:
        use_device = (g.n + 2 * g.m) >= 200_000
    if use_device:
        src = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees())
        dev = torch.device("cuda" if device is None else device)
        av, _ = global_reduce_torch(
            torch.from_numpy(src).to(dev),
            torch.from_numpy(g.indices.astype(np.int64)).to(dev), g.n)
        alive = av.cpu().numpy()
    else:
        alive = _peel_rounds_np(g)
    if alive.all():
        return g, CliqueReports()
    edges = g.edges().astype(np.int64)
    touched = ~alive[edges[:, 0]] | ~alive[edges[:, 1]]
    reports = CliqueReports([edges[touched]])
    residual = from_edge_list(g.n, edges[~touched])
    return residual, reports


def _triangle_edge_mask(g: CSRGraph) -> np.ndarray:
    """Per-undirected-edge mask: does the edge sit in at least one triangle?

    Vectorized edge-iterator: for each edge expand the smaller-degree
    endpoint's adjacency and membership-test the (other, w) pairs against
    the directed CSR key array with one `searchsorted` — O(Σ_e min deg)
    work, no per-edge python."""
    from repro_torch.graph.pack import _ranges

    e = g.edges().astype(np.int64)
    if len(e) == 0:
        return np.zeros(0, dtype=bool)
    n = g.n
    deg = g.degrees()
    swap = deg[e[:, 0]] > deg[e[:, 1]]
    a = np.where(swap, e[:, 1], e[:, 0])
    b = np.where(swap, e[:, 0], e[:, 1])
    counts = deg[a]                              # ≥1: every endpoint has deg>0
    kt = np.int32 if n * n < (1 << 31) else np.int64
    w = g.indices[_ranges(g.indptr[a], counts)]
    q = np.repeat(b.astype(kt), counts) * kt(n) + w.astype(kt)
    dk = (np.repeat(np.arange(n, dtype=kt), deg) * kt(n)
          + g.indices.astype(kt))                # CSR order — already sorted
    if n * n <= (1 << 29):
        # dense edge-membership bitmap (≤64MB): two gathers per query
        # instead of a binary search per query
        bm = np.zeros((n * n + 7) >> 3, dtype=np.uint8)
        np.bitwise_or.at(bm, dk >> 3, np.uint8(1) << (dk & 7).astype(np.uint8))
        hit = (bm[q >> 3] >> (q & 7).astype(np.uint8)) & np.uint8(1) != 0
    else:
        pos = np.minimum(np.searchsorted(dk, q), len(dk) - 1)
        hit = dk[pos] == q
    # per-edge any() over each contiguous neighbor segment (w == a never
    # hits: u*n+u keys do not exist in a simple graph)
    offs = np.cumsum(counts) - counts
    return np.logical_or.reduceat(hit, offs)


def _batch_lemma3(g: CSRGraph) -> Tuple[CSRGraph, List[np.ndarray], bool]:
    """One conflict-free batch of Lemma-3 degree-2 eliminations.

    Selects a maximal-by-claim set of degree-2 vertices whose *closed*
    neighborhoods are pairwise disjoint (min-claim matching: every
    candidate v stamps {v, u, w} with `np.minimum.at`; v survives iff it
    owns all three cells). Disjoint closed neighborhoods make the batch
    equal to SOME sequential order of Lemma 3 applications: deleting one
    selected vertex — or its case-2 edge (u, w), whose endpoints v owns
    exclusively — cannot change another selected vertex's neighborhood
    or its (u', w') common-neighbor witness set (a degree-2 witness
    adjacent to both u' and w' would itself have claimed them).

    Returns (reduced graph, report segments, changed).
    """
    deg = g.degrees()
    cand = np.nonzero(deg == 2)[0].astype(np.int64)
    if len(cand) == 0:
        return g, [], False
    u = g.indices[g.indptr[cand]].astype(np.int64)
    w = g.indices[g.indptr[cand] + 1].astype(np.int64)
    claim = np.full(g.n, g.n, dtype=np.int64)
    np.minimum.at(claim, cand, cand)
    np.minimum.at(claim, u, cand)
    np.minimum.at(claim, w, cand)
    sel = (claim[cand] == cand) & (claim[u] == cand) & (claim[w] == cand)
    if not sel.any():
        return g, [], False
    v_s, u_s, w_s = cand[sel], u[sel], w[sel]

    from repro_torch.graph.pack import _ranges

    n = g.n
    kt = np.int32 if n * n < (1 << 31) else np.int64
    dk = (np.repeat(np.arange(n, dtype=kt), deg) * kt(n)
          + g.indices.astype(kt))              # directed keys, CSR-sorted
    q = u_s.astype(kt) * kt(n) + w_s.astype(kt)
    pos = np.minimum(np.searchsorted(dk, q), max(len(dk) - 1, 0))
    adj_uw = dk[pos] == q                      # is (u, w) an edge?

    segments: List[np.ndarray] = []
    if (~adj_uw).any():
        # case: u, w non-adjacent -> two maximal 2-cliques {v,u}, {v,w}
        v_n, u_n, w_n = v_s[~adj_uw], u_s[~adj_uw], w_s[~adj_uw]
        segments.append(np.concatenate([np.stack([v_n, u_n], 1),
                                        np.stack([v_n, w_n], 1)]))
    doomed_uw = np.zeros((0, 2), dtype=np.int64)
    if adj_uw.any():
        # case: triangle {v,u,w} is maximal; edge (u,w) dies too unless
        # some OTHER common neighbor keeps it in a second triangle
        v_a, u_a, w_a = v_s[adj_uw], u_s[adj_uw], w_s[adj_uw]
        segments.append(np.stack([v_a, u_a, w_a], 1))
        swap = deg[u_a] > deg[w_a]
        a = np.where(swap, w_a, u_a)           # expand the smaller side
        b = np.where(swap, u_a, w_a)
        counts = deg[a]                        # >= 2: adjacent to v and b
        nb = g.indices[_ranges(g.indptr[a], counts)]
        qq = np.repeat(b.astype(kt), counts) * kt(n) + nb.astype(kt)
        pos = np.minimum(np.searchsorted(dk, qq), max(len(dk) - 1, 0))
        hit = (dk[pos] == qq).astype(np.int64)
        offs = np.cumsum(counts) - counts
        ncom = np.add.reduceat(hit, offs)      # v itself counts once
        lone = ncom < 2
        if lone.any():
            doomed_uw = np.stack([np.minimum(u_a, w_a),
                                  np.maximum(u_a, w_a)], 1)[lone]

    e = g.edges().astype(np.int64)
    in_v = np.zeros(n, dtype=bool)
    in_v[v_s] = True
    drop = in_v[e[:, 0]] | in_v[e[:, 1]]
    if len(doomed_uw):
        ek = np.minimum(e[:, 0], e[:, 1]) * n + np.maximum(e[:, 0], e[:, 1])
        drop |= np.isin(ek, doomed_uw[:, 0] * n + doomed_uw[:, 1])
    g2 = from_edge_list(n, e[~drop])
    return g2, segments, True


def reduce_prepass(g: CSRGraph, max_rounds: int = 16, device=None
                   ) -> Tuple[CSRGraph, CliqueReports]:
    """Vectorized global-reduction pre-pass for the ingest pipeline.

    Alternates the deg-0/1 peel (`peel_low_degree`) with a conflict-free
    *batch* Lemma-3 round (`_batch_lemma3`) and a *batch* non-triangle
    edge sweep (Lemma 4) until fixpoint, so the python cascade in
    `global_reduce_host` only ever sees the stubborn core — on hub-heavy
    graphs this is >90% of the vertex+edge rules' work done in a handful
    of numpy passes.

    Batch validity: every edge of a triangle shares a neighbor with the
    other two, so no triangle edge is Lemma-4-removable and no removable
    edge witnesses a triangle — removing all currently non-triangle
    edges at once equals SOME sequential order of Lemma 4 applications.
    Edges that only *become* non-triangle after vertex deletions are
    caught by the next round's peel+sweep or by the host cascade.
    `device` is where the peel's device path runs (`peel_low_degree`).
    """
    segments: List[np.ndarray] = []
    for _ in range(max_rounds):
        g2, r = peel_low_degree(g, device=device)
        changed = g2 is not g
        g = g2
        segments += r._segs
        if g.m == 0:
            break
        g, segs3, ch3 = _batch_lemma3(g)
        segments += segs3
        changed |= ch3
        if g.m == 0:
            break
        tri = _triangle_edge_mask(g)
        if not tri.all():
            e = g.edges().astype(np.int64)
            segments.append(e[~tri])
            g = from_edge_list(g.n, e[tri])
            changed = True
        if not changed:
            break
    return g, CliqueReports(segments)
