"""Dispatching wrapper: edge-parallel triangle test over a padded-CSR graph.

Dispatch is by the device of the tensors handed in, and by nothing else:
a CPU tensor takes the plain version in `ref`; a CUDA tensor launches the
hand-written Hopper kernel `csrc/common_neighbor.cu` (built at first use by
the port's build helper) or raises. `LAUNCHES["has_common_neighbor"]`
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels._build import (CudaLibrary, Launches, on_cpu,
                                        raise_on, stream)
from repro_torch.kernels.common_neighbor import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "common_neighbor.cu"
_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary(SOURCE, {
    "common_neighbor_has_common": [_p, _p, _p, _ll, _i, _p]})
LAUNCHES = Launches({"has_common_neighbor": 0})


def has_common_neighbor(adj_u: torch.Tensor,
                        adj_v: torch.Tensor) -> torch.Tensor:
    """(E, D) x (E, D) int32 rows padded with -1 -> (E,) bool: do the two
    rows share a value >= 0? No order of the entries is assumed: -1 may
    sit anywhere in a row."""
    if on_cpu(adj_u, adj_v):
        return ref.has_common_neighbor(adj_u, adj_v)
    if adj_u.dim() != 2 or adj_u.shape != adj_v.shape:
        raise ValueError(f"has_common_neighbor: rows must be two (E, D) "
                         f"tensors, got {tuple(adj_u.shape)} and "
                         f"{tuple(adj_v.shape)}")
    for t in (adj_u, adj_v):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("has_common_neighbor: rows must be contiguous "
                             "int32")
    e, d = adj_u.shape
    out = torch.empty(e, dtype=torch.bool, device=adj_u.device)
    if e:
        raise_on("has_common_neighbor",
                 LIBRARY.load().common_neighbor_has_common(
                     adj_u.data_ptr(), adj_v.data_ptr(), out.data_ptr(), e,
                     d, stream()))
        LAUNCHES["has_common_neighbor"] += 1
    return out


def edge_common_neighbor(padded_adj: torch.Tensor,
                         edges: torch.Tensor) -> torch.Tensor:
    """padded_adj: (N, D) int32 neighbours padded with -1; edges: (E, 2)
    integer. Returns (E,) bool — does the edge close a triangle.

    The gathers stay torch indexing (the reference leaves them to XLA);
    the pairwise test is the kernel. Self-matches are impossible (simple
    graph: u is not in N(u))."""
    edges = edges.long()
    return has_common_neighbor(padded_adj[edges[:, 0]],
                               padded_adj[edges[:, 1]])


def pad_adjacency(indptr: np.ndarray, indices: np.ndarray,
                  max_deg: int) -> np.ndarray:
    """Host helper: CSR -> (N, max_deg) int32 padded with -1."""
    n = len(indptr) - 1
    out = -np.ones((n, max_deg), dtype=np.int32)
    for v in range(n):
        row = indices[indptr[v]:indptr[v + 1]]
        out[v, :len(row)] = row
    return out
