"""Synthetic graph generators matched to the paper's dataset regimes.

The paper benchmarks 18 SNAP / Network Repository graphs. This container is
offline, so the benchmark suite generates synthetic stand-ins from the same
structural families:

- `grid_road`        — road-network analogue (inf-road-usa, roadNet-CA):
                       sparse, degeneracy ~2-3, fully removed by global
                       reduction (paper Fig 8).
- `random_geometric` — delaunay-ish proximity graph (sc-delaunay_n23):
                       min degree > 2, untouched by global reduction.
- `barabasi_albert`  — power-law social/web analogue (as-skitter, web-Google).
- `erdos_renyi`      — uniform random control.
- `caveman`          — community graph with many overlapping cliques.
- `kronecker`        — scale-free RMAT-style graph (soc-/com- analogues).
- `moon_moser`       — worst-case 3^(n/3) maximal cliques (correctness
                       stress; K_{3,3,...,3} complete multipartite).
- `complete_graph`   — K_n sanity.
All generators are deterministic given `seed`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, from_edge_list


def erdos_renyi(n: int, p: float, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(n, k=1)
    mask = rng.random(len(iu)) < p
    return from_edge_list(n, np.stack([iu[mask], ju[mask]], axis=1))


def barabasi_albert(n: int, m_attach: int = 4, seed: int = 0) -> CSRGraph:
    """Preferential attachment; repeated-target sampling (fast, numpy)."""
    rng = np.random.default_rng(seed)
    m_attach = max(1, min(m_attach, n - 1))
    targets = list(range(m_attach))
    edges = []
    repeated = []  # endpoint multiset for preferential attachment
    for v in range(m_attach, n):
        chosen = set()
        while len(chosen) < m_attach:
            if repeated and rng.random() < 0.9:
                cand = repeated[rng.integers(len(repeated))]
            else:
                cand = int(rng.integers(v))
            if cand != v:
                chosen.add(int(cand))
        for t in chosen:
            edges.append((v, t))
            repeated.extend([v, t])
        targets.append(v)
    return from_edge_list(n, np.array(edges, dtype=np.int64))


def random_geometric(n: int, radius: float | None = None, seed: int = 0) -> CSRGraph:
    """2-D random geometric graph (delaunay-like locality, high clustering)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    if radius is None:
        radius = float(np.sqrt(8.0 / max(n, 1)))  # avg degree ~ 8*pi/4
    # grid-bucketed neighbor search to stay O(n)
    cell = radius
    gx = (pts[:, 0] / cell).astype(np.int64)
    gy = (pts[:, 1] / cell).astype(np.int64)
    buckets: dict = {}
    for i, (a, b) in enumerate(zip(gx.tolist(), gy.tolist())):
        buckets.setdefault((a, b), []).append(i)
    edges = []
    r2 = radius * radius
    for (a, b), members in buckets.items():
        neigh = []
        for da in (-1, 0, 1):
            for db in (-1, 0, 1):
                neigh.extend(buckets.get((a + da, b + db), []))
        neigh = np.array(neigh)
        for i in members:
            d2 = np.sum((pts[neigh] - pts[i]) ** 2, axis=1)
            for j in neigh[(d2 < r2) & (neigh > i)]:
                edges.append((i, int(j)))
    return from_edge_list(n, np.array(edges, dtype=np.int64) if edges else np.zeros((0, 2)))


def grid_road(side: int, drop_frac: float = 0.1, seed: int = 0) -> CSRGraph:
    """Road-network analogue: 2-D lattice with random edge dropout.

    Degeneracy ≤ 2 ⇒ fully removed by the paper's global reduction, matching
    inf-road-usa / roadNet-CA behaviour in Fig 8.
    """
    rng = np.random.default_rng(seed)
    n = side * side
    idx = np.arange(n).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    edges = np.concatenate([right, down])
    keep = rng.random(len(edges)) >= drop_frac
    return from_edge_list(n, edges[keep])


def caveman(n_cliques: int, clique_size: int, rewire: float = 0.1, seed: int = 0) -> CSRGraph:
    """Connected caveman-style community graph (many maximal cliques)."""
    rng = np.random.default_rng(seed)
    n = n_cliques * clique_size
    edges = []
    for c in range(n_cliques):
        base = c * clique_size
        for i in range(clique_size):
            for j in range(i + 1, clique_size):
                edges.append((base + i, base + j))
        # ring link to next cave
        edges.append((base, ((c + 1) % n_cliques) * clique_size))
    edges = np.array(edges, dtype=np.int64)
    flip = rng.random(len(edges)) < rewire
    edges[flip, 1] = rng.integers(0, n, size=flip.sum())
    return from_edge_list(n, edges)


def kronecker(scale: int, edge_factor: int = 8, seed: int = 0,
              a: float = 0.57, b: float = 0.19, c: float = 0.19) -> CSRGraph:
    """RMAT/Kronecker generator (Graph500-style), scale = log2(n)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        go_right = (r > a) & (r <= a + b)
        go_down = (r > a + b) & (r <= a + b + c)
        go_diag = r > a + b + c
        src += ((go_down | go_diag).astype(np.int64)) << bit
        dst += ((go_right | go_diag).astype(np.int64)) << bit
    return from_edge_list(n, np.stack([src, dst], axis=1))


def moon_moser(k: int) -> CSRGraph:
    """Complete multipartite K_{3,3,...,3} with k parts: 3^k maximal cliques."""
    n = 3 * k
    part = np.arange(n) // 3
    iu, ju = np.triu_indices(n, k=1)
    mask = part[iu] != part[ju]
    return from_edge_list(n, np.stack([iu[mask], ju[mask]], axis=1))


def complete_graph(n: int) -> CSRGraph:
    iu, ju = np.triu_indices(n, k=1)
    return from_edge_list(n, np.stack([iu, ju], axis=1))
