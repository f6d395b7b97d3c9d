"""Dispatching wrapper for message-passing aggregation.

`dense_spmm` dispatches by the device of the tensors handed in, and by
nothing else: a CPU tensor takes the plain version in `ref`; a CUDA tensor
launches the hand-written Hopper kernel `csrc/segment_spmm.cu` (built at
first use by the port's build helper) or raises. Both take float32: other
floating inputs are cast first, as in the reference.
`LAUNCHES["dense_spmm"]` counts the kernel's launches.

`segment_spmm` is plain PyTorch on every device: the reference has no
Pallas kernel for the sparse form either (gather + scatter-add is left to
the framework), so there is nothing here to port into a kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._build import (CudaLibrary, Launches, on_cpu,
                                        raise_on, stream)
from repro_torch.kernels.segment_spmm import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_spmm.cu"
_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary(SOURCE, {"dense_spmm": [_p, _p, _p, _ll, _i, _i, _p],
                               "dense_spmm_path": [_p, _p, _ll, _i, _i]})
LAUNCHES = Launches({"dense_spmm": 0})


def segment_spmm(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 n_nodes: int,
                 edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse path: always the gather + scatter-add formulation."""
    return ref.segment_spmm(x, src, dst, n_nodes, edge_weight)


def dense_spmm(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[b] = adj[b] @ x[b] in float32: adj (B, N, N), x (B, N, F).
    Inputs of another floating type are cast to float32 first, as the
    reference's kernel does (`segment_spmm/kernel.py:53`)."""
    cpu = on_cpu(adj, x)
    if adj.dim() != 3 or x.dim() != 3 or adj.shape[1] != adj.shape[2] \
            or x.shape[:2] != adj.shape[:2]:
        raise ValueError(f"dense_spmm: adj must be (B, N, N) and x "
                         f"(B, N, F), got {tuple(adj.shape)} and "
                         f"{tuple(x.shape)}")
    adj = adj.to(torch.float32).contiguous()
    x = x.to(torch.float32).contiguous()
    if cpu:
        return ref.dense_spmm(adj, x)
    b, n, f = x.shape
    out = torch.empty(b, n, f, dtype=torch.float32, device=x.device)
    if b and n and f:
        raise_on("dense_spmm", LIBRARY.load().dense_spmm(
            adj.data_ptr(), x.data_ptr(), out.data_ptr(), b, n, f, stream()))
        LAUNCHES["dense_spmm"] += 1
    return out


def kernel_path(adj: torch.Tensor, x: torch.Tensor) -> dict:
    """How the CUDA kernel stages these float32 inputs (the library's
    `dense_spmm_path`): bulk copies on mbarriers or plain loads, one stage
    or the two-stage ring, float4 rows, rows a thread owns, and blocks per
    graph."""
    b, n, f = x.shape
    code = LIBRARY.load().dense_spmm_path(adj.data_ptr(), x.data_ptr(), b, n,
                                          f)
    return dict(bulk=bool(code & 1), ring=bool(code & 2),
                vec=bool(code & 4), rows_per_thread=(code >> 4) & 15,
                blocks_per_graph=code >> 8)


def densify_edges(src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                  graph_id: torch.Tensor, n_graphs: int,
                  nodes_per_graph: int,
                  edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Build (B, N, N) float32 dense adjacency from a batched edge list, on
    the device of the edges.

    src/dst are global node indices (graph g owns [g*N, (g+1)*N)); rows are
    destinations, columns sources — the ref.dense_spmm convention. Repeated
    edges add up."""
    local_s = (src - graph_id * nodes_per_graph).long()
    local_d = (dst - graph_id * nodes_per_graph).long()
    w = (torch.ones(src.shape, dtype=torch.float32, device=src.device)
         if edge_weight is None else edge_weight.to(torch.float32))
    adj = torch.zeros(n_graphs, nodes_per_graph, nodes_per_graph,
                      dtype=torch.float32, device=src.device)
    return adj.index_put_((graph_id.long(), local_d, local_s), w,
                          accumulate=True)
