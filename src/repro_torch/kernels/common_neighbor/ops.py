"""Dispatching wrapper: edge-parallel triangle test over a padded-CSR graph.

Dispatch is by the device of the tensors handed in, and by nothing else:
a CPU tensor takes the plain version in `ref`; a CUDA tensor launches the
hand-written Hopper kernels of `csrc/common_neighbor.cu` (built at first
use by the port's build helper) or raises. `LAUNCHES["has_common_neighbor"]`
counts their launches: two a `has_common_neighbor` call, three an
`edge_common_neighbor` call.
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
    "common_neighbor_has_common": [_p, _p, _p, _ll, _i, _p, _p, _p],
    "common_neighbor_count_real": [_p, _ll, _i, _p, _p, _p],
    "common_neighbor_edges": [_p, _p, _ll, _i, _p, _i, _ll, _ll, _p, _ll,
                              _p, _p, _p]})
LAUNCHES = Launches({"has_common_neighbor": 0})

def _check_table(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name}: rows must be a 2-D tensor, got "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous int32")


def has_common_neighbor(adj_u: torch.Tensor, adj_v: torch.Tensor
                        ) -> torch.Tensor:
    """(E, D) x (E, D) int32 rows -> (E,) bool: do the two rows share a
    value >= 0? Every negative entry is padding, and it may sit anywhere in
    a row. On the card two launches: a group of lanes an edge stages one
    tile of adj_u's row and sweeps adj_v's, then a block an edge finishes
    the edges that tile did not decide."""
    if on_cpu(adj_u, adj_v):
        return ref.has_common_neighbor(adj_u, adj_v)
    if adj_u.shape != adj_v.shape:
        raise ValueError(f"has_common_neighbor: rows must be two (E, D) "
                         f"tensors, got {tuple(adj_u.shape)} and "
                         f"{tuple(adj_v.shape)}")
    for t in (adj_u, adj_v):
        _check_table("has_common_neighbor", t)
    e, d = adj_u.shape
    dev = adj_u.device
    out = torch.empty(e, dtype=torch.bool, device=dev)
    if e:
        queue = _queue(e, dev)
        queued = torch.empty(1, dtype=torch.int32, device=dev)
        raise_on("has_common_neighbor",
                 LIBRARY.load().common_neighbor_has_common(
                     adj_u.data_ptr(), adj_v.data_ptr(), out.data_ptr(), e,
                     d, queue.data_ptr(), queued.data_ptr(), stream()))
        LAUNCHES["has_common_neighbor"] += 2
    return out


def _queue(e: int, dev: torch.device) -> torch.Tensor:
    """Room for the kernels' queue of up to `e` edges (16 bytes each)."""
    return torch.empty((e, 4), dtype=torch.int32, device=dev)


def _check_ids(edges: torch.Tensor, n: int) -> None:
    if edges.numel() and (int(edges.min()) < 0 or int(edges.max()) >= n):
        raise ValueError(f"edge_common_neighbor: edge ids must lie in "
                         f"[0, {n})")


def edge_common_neighbor(padded_adj: torch.Tensor, edges: torch.Tensor
                         ) -> torch.Tensor:
    """padded_adj: (N, D) int32 neighbours, any negative entry padding
    (anywhere in a row); edges: (E, 2) int32 or int64 ids. Returns (E,)
    bool — does the edge close a triangle.

    Ids must lie in [0, N): any other id raises ValueError, on the CPU
    before any work and on the card after the launches (the call then
    waits for them: it reads a status word back), which never read through
    such an id. On the card the call is three launches and writes no (E,
    D) tensor: one counts each table row's real entries, the next two test
    each edge on the table's rows where they lie, staging the row with
    fewer real entries (the same device code as `has_common_neighbor`: a
    group of lanes an edge, then a block an edge for the edges one tile of
    a group did not decide). On the CPU the rows are gathered and the plain
    version tests them. Self-matches are impossible (simple graph: u is
    not in N(u))."""
    if padded_adj.dim() != 2 or edges.dim() != 2 or edges.shape[1] != 2:
        raise ValueError(f"edge_common_neighbor: a (N, D) table and (E, 2) "
                         f"edges, got {tuple(padded_adj.shape)} and "
                         f"{tuple(edges.shape)}")
    n, d = padded_adj.shape
    if on_cpu(padded_adj, edges):
        _check_ids(edges, n)
        edges = edges.long()
        return ref.has_common_neighbor(padded_adj[edges[:, 0]],
                                       padded_adj[edges[:, 1]])
    _check_table("edge_common_neighbor", padded_adj)
    if edges.dtype not in (torch.int32, torch.int64):
        raise ValueError("edge_common_neighbor: edge ids must be int32 or "
                         "int64")
    e = edges.shape[0]
    dev = padded_adj.device
    out = torch.empty(e, dtype=torch.bool, device=dev)
    if e == 0:
        return out
    if n == 0:
        raise ValueError("edge_common_neighbor: edge ids must lie in [0, 0)")
    real = torch.empty(n, dtype=torch.int32, device=dev)
    status = torch.empty(2, dtype=torch.int32, device=dev)   # bad ids, queued
    queue = _queue(e, dev)
    lib = LIBRARY.load()
    raise_on("edge_common_neighbor",
             lib.common_neighbor_count_real(padded_adj.data_ptr(), n, d,
                                            real.data_ptr(),
                                            status.data_ptr(), stream()))
    LAUNCHES["has_common_neighbor"] += 1
    raise_on("edge_common_neighbor", lib.common_neighbor_edges(
        padded_adj.data_ptr(), real.data_ptr(), n, d, edges.data_ptr(),
        int(edges.dtype == torch.int64), edges.stride(0), edges.stride(1),
        out.data_ptr(), e, queue.data_ptr(), status.data_ptr(), stream()))
    LAUNCHES["has_common_neighbor"] += 2
    if int(status[0]):
        raise ValueError(f"edge_common_neighbor: edge ids must lie in "
                         f"[0, {n})")
    return out


def pad_adjacency(indptr: np.ndarray, indices: np.ndarray,
                  max_deg: int) -> np.ndarray:
    """Host helper: CSR -> (N, max_deg) int32 padded with -1."""
    n = len(indptr) - 1
    out = -np.ones((n, max_deg), dtype=np.int32)
    for v in range(n):
        row = indices[indptr[v]:indptr[v + 1]]
        out[v, :len(row)] = row
    return out
