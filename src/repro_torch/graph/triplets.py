"""Host-side triplet index construction for directional GNNs (DimeNet):
the port's copy of the reference's `repro.graph.triplets` (numpy only).

A triplet (k→j, j→i) pairs every incoming edge of j with every outgoing edge
of j (k ≠ i). Counts explode on dense graphs (Σ_j d(j)²), so a per-edge cap
bounds the fixed shape: for each edge (j→i), at most `cap` incoming edges of
j are paired (nearest-sorted order — matches molecular practice where the
cutoff graph bounds the neighbour count anyway).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def build_triplets(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                   cap_per_edge: int = 16) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (trip_kj, trip_ji, mask): indices into the edge list.

    trip_kj[t] = edge id of (k→j); trip_ji[t] = edge id of (j→i)."""
    e = len(src)
    order = np.argsort(dst, kind="stable")
    sorted_dst = dst[order]
    starts = np.searchsorted(sorted_dst, np.arange(n_nodes), side="left")
    ends = np.searchsorted(sorted_dst, np.arange(n_nodes), side="right")
    kj_list, ji_list = [], []
    for ji in range(e):
        j = src[ji]
        i = dst[ji]
        incoming = order[starts[j]:ends[j]]          # edges (k→j)
        incoming = incoming[src[incoming] != i][:cap_per_edge]
        kj_list.append(incoming)
        ji_list.append(np.full(len(incoming), ji, dtype=np.int64))
    if kj_list:
        kj = np.concatenate(kj_list).astype(np.int32)
        ji = np.concatenate(ji_list).astype(np.int32)
    else:
        kj = np.zeros(0, np.int32)
        ji = np.zeros(0, np.int32)
    mask = np.ones(len(kj), dtype=bool)
    return kj, ji, mask


def triplet_budget(n_edges: int, cap_per_edge: int = 16) -> int:
    return n_edges * cap_per_edge
