"""Plain PyTorch version of the flash attention kernel."""
from __future__ import annotations

import math

import torch


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH, Sk, D). Full-softmax reference."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, -1e30)
    out = torch.einsum("bqk,bkd->bqd", _softmax(s), v.float())
    return out.to(q.dtype)


def _softmax(s: torch.Tensor) -> torch.Tensor:
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / torch.sum(e, dim=-1, keepdim=True)
