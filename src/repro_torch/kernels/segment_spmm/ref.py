"""Plain PyTorch versions of sparse message-passing aggregation.

Two equivalent formulations:
  * `segment_spmm` — edge-list gather + scatter-add (index_add_), the
    sparse substrate;
  * `dense_spmm`   — batched dense adjacency product, equal on densifiable
    graphs; the form the CUDA kernel computes for the batched-small-graph
    regime (molecule shape).
"""
from __future__ import annotations

from typing import Optional

import torch


def segment_spmm(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 n_nodes: int,
                 edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[d] = sum over edges e with dst[e] = d of w[e] * x[src[e]].
    x: (N, F)."""
    msgs = x[src.long()]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    out = torch.zeros((n_nodes,) + tuple(x.shape[1:]), dtype=msgs.dtype,
                      device=x.device)
    return out.index_add_(0, dst.long(), msgs)


def dense_spmm(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """adj: (B, N, N) weights (adj[b, d, s]); x: (B, N, F) -> (B, N, F)."""
    return torch.einsum("bds,bsf->bdf", adj, x)
