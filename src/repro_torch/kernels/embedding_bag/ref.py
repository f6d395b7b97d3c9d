"""Plain PyTorch version: EmbeddingBag (multi-hot gather + reduce).

ids are padded with -1 (masked out). combiner: 'sum' | 'mean'. An id at or
above the vocabulary is out of contract; like the reference's gather
(`table[safe]` in JAX clamps), it reads the last row.
"""
from __future__ import annotations

import torch


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """table: (V, D); ids: (B, L) int32 padded with -1 -> (B, D)."""
    mask = ids >= 0
    safe = torch.where(mask, ids, 0).clamp(max=table.shape[0] - 1).long()
    rows = table[safe] * mask[..., None]
    out = rows.sum(dim=1)
    if combiner == "mean":
        denom = mask.sum(dim=1, keepdim=True).clamp(min=1)
        out = out / denom
    return out
