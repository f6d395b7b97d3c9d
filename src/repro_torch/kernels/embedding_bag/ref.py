"""Plain PyTorch versions: EmbeddingBag (multi-hot gather + reduce) and
the gradient of its sum.

ids are padded with -1 (masked out). combiner: 'sum' | 'mean'. An id at or
above the vocabulary is out of contract; like the reference's gather
(`table[safe]` in JAX clamps), it reads the last row, and its gradient
goes to the last row.
"""
from __future__ import annotations

import torch


def _safe(ids: torch.Tensor, v: int):
    """(row each slot reads, its real-id mask)."""
    mask = ids >= 0
    return torch.where(mask, ids, 0).clamp(max=v - 1).long(), mask


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """table: (V, D); ids: (B, L) int32 padded with -1 -> (B, D)."""
    safe, mask = _safe(ids, table.shape[0])
    rows = table[safe] * mask[..., None]
    out = rows.sum(dim=1)
    if combiner == "mean":
        denom = mask.sum(dim=1, keepdim=True).clamp(min=1)
        out = out / denom
    return out


def embedding_bag_sum_bwd(grad_out: torch.Tensor, ids: torch.Tensor,
                          num_rows: int) -> torch.Tensor:
    """The table's gradient of the bag sum: (num_rows, D) float32, zero
    plus grad_out[b] added into row ids[b, l] for every id >= 0 (an id at
    or above num_rows into the last row), in slot order."""
    safe, mask = _safe(ids, num_rows)
    b, l = ids.shape
    d = grad_out.shape[1]
    src = grad_out.float()[:, None, :].expand(b, l, d) * mask[..., None]
    return torch.zeros(num_rows, d, dtype=torch.float32,
                       device=grad_out.device).index_add_(
        0, safe.reshape(-1), src.reshape(b * l, d))
