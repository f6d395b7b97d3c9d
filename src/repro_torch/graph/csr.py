"""CSR graph structure (undirected, simple) used across the framework.

The canonical host representation is numpy CSR with sorted adjacency lists.
Device code receives bitset derivatives built by `repro_torch.core`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Undirected simple graph in CSR form.

    indptr:  (n+1,) int64 — row offsets.
    indices: (m*2,) int32 — concatenated sorted adjacency lists (both
             directions stored; m counts undirected edges).
    """

    indptr: np.ndarray
    indices: np.ndarray

    # ---- basic accessors -------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def m(self) -> int:
        return int(len(self.indices) // 2)

    def degree(self, v: int | None = None):
        degs = np.diff(self.indptr)
        return degs if v is None else int(degs[v])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        nb = self.neighbors(u)
        i = np.searchsorted(nb, v)
        return bool(i < len(nb) and nb[i] == v)

    def edges(self) -> np.ndarray:
        """(m, 2) array of undirected edges with u < v."""
        src = np.repeat(np.arange(self.n, dtype=np.int64), self.degrees())
        dst = self.indices.astype(np.int64)
        keep = src < dst
        return np.stack([src[keep], dst[keep]], axis=1).astype(np.int32)

    def edge_index(self) -> np.ndarray:
        """(2, 2m) directed COO edge index (GNN convention, both directions)."""
        src = np.repeat(np.arange(self.n, dtype=np.int64), self.degrees())
        return np.stack([src.astype(np.int32), self.indices.astype(np.int32)])

    # ---- invariants ------------------------------------------------------
    def validate(self) -> None:
        assert self.indptr[0] == 0 and self.indptr[-1] == len(self.indices)
        assert np.all(np.diff(self.indptr) >= 0)
        for v in range(self.n):
            nb = self.neighbors(v)
            assert np.all(np.diff(nb) > 0), f"adjacency of {v} not sorted/unique"
            assert not np.any(nb == v), f"self loop at {v}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CSRGraph(n={self.n}, m={self.m})"


def from_edge_list(n: int, edges: Iterable[Tuple[int, int]] | np.ndarray) -> CSRGraph:
    """Build a CSRGraph from an iterable of undirected edges.

    Deduplicates, drops self loops, symmetrizes, sorts adjacency lists.
    """
    e = np.asarray(list(edges) if not isinstance(edges, np.ndarray) else edges, dtype=np.int64)
    if e.size == 0:
        return CSRGraph(np.zeros(n + 1, dtype=np.int64), np.zeros(0, dtype=np.int32))
    e = e.reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]  # no self loops
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    key = lo * n + hi
    _, uniq = np.unique(key, return_index=True)
    lo, hi = lo[uniq], hi[uniq]
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRGraph(indptr, dst.astype(np.int32))


def induced_subgraph(g: CSRGraph, keep: np.ndarray) -> Tuple[CSRGraph, np.ndarray]:
    """Induced subgraph on `keep` (bool mask or vertex ids).

    Returns (subgraph, old_ids) where old_ids[i] is the original id of new
    vertex i.
    """
    if keep.dtype == bool:
        old_ids = np.nonzero(keep)[0]
    else:
        old_ids = np.sort(np.asarray(keep, dtype=np.int64))
    remap = -np.ones(g.n, dtype=np.int64)
    remap[old_ids] = np.arange(len(old_ids))
    edges = g.edges()
    a, b = remap[edges[:, 0]], remap[edges[:, 1]]
    sel = (a >= 0) & (b >= 0)
    sub = from_edge_list(len(old_ids), np.stack([a[sel], b[sel]], axis=1))
    return sub, old_ids


def remove_edges(g: CSRGraph, drop: np.ndarray) -> CSRGraph:
    """Remove an (k, 2) array of undirected edges from g."""
    if len(drop) == 0:
        return g
    edges = g.edges().astype(np.int64)
    dl = np.minimum(drop[:, 0], drop[:, 1]).astype(np.int64)
    dh = np.maximum(drop[:, 0], drop[:, 1]).astype(np.int64)
    dropset = set((dl * g.n + dh).tolist())
    key = edges[:, 0] * g.n + edges[:, 1]
    keep = np.array([k not in dropset for k in key.tolist()], dtype=bool)
    return from_edge_list(g.n, edges[keep])
