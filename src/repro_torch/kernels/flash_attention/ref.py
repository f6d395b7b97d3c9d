"""Plain PyTorch versions of the flash attention kernels: the forward and
its backward, each an explicit formula (the backward is written out, not
taken from autograd)."""
from __future__ import annotations

import math
from typing import Tuple

import torch


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled float32 scores q.k / sqrt(D), masked to -1e30 above the
    top-left diagonal when causal."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, -1e30)
    return s


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH, Sk, D). Full-softmax reference."""
    out = torch.einsum("bqk,bkd->bqd", _softmax(_scores(q, k, causal)),
                       v.float())
    return out.to(q.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of `flash_attention` at output gradient
    `do`, each in its input's type, computed in float32: P = softmax(S),
    dV = P^T dO, dP = dO V^T, D_i = rowsum(P * dP) (= rowsum(dO * O) of
    the unrounded output), dS = P * (dP - D_i), dQ = dS K / sqrt(D),
    dK = dS^T Q / sqrt(D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _softmax(_scores(q, k, causal))
    dof = do.float()
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _softmax(s: torch.Tensor) -> torch.Tensor:
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / torch.sum(e, dim=-1, keepdim=True)
