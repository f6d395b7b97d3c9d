"""Plain PyTorch versions of the flash attention kernels: the forward and
its backward, each an explicit formula (the backward is written out, not
taken from autograd)."""
from __future__ import annotations

import math
from typing import Tuple

import torch


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            q_offset: int = 0) -> torch.Tensor:
    """Scaled float32 scores q.k / sqrt(D), masked to -1e30 where k_pos >
    q_pos + q_offset when causal (the top-left diagonal at q_offset 0)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (q_offset + torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, -1e30)
    return s


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH, Sk, D). Full-softmax reference; q's rows
    start at q_offset among the keys."""
    out = torch.einsum("bqk,bkd->bqd",
                       _softmax(_scores(q, k, causal, q_offset)), v.float())
    return out.to(q.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of `flash_attention` at output gradient
    `do`, each in its input's type, computed in float32: P = softmax(S),
    dV = P^T dO, dP = dO V^T, D_i = rowsum(P * dP) (= rowsum(dO * O) of
    the unrounded output), dS = P * (dP - D_i), dQ = dS K / sqrt(D),
    dK = dS^T Q / sqrt(D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _softmax(_scores(q, k, causal, q_offset))
    dof = do.float()
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_rows(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, block: int = 128,
                             q_offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's first pass as its kernels compute it, online over key
    tiles of `block`: each query row's log-sum-exp of the scaled, masked
    scores (natural log) and delta = rowsum(P * dP) with dP = dO V^T, from
    running (m, l, t = sum 2^(x - m) dP) in float32 in the log2 domain
    (x = s * log2(e) / sqrt(D)). Both (BH, Sq) float32."""
    log2e = 1.0 / math.log(2.0)
    bh, sq, d = q.shape
    qf, dof = q.float(), do.float()
    m = torch.full((bh, sq), -1e30, device=q.device)
    l = torch.zeros(bh, sq, device=q.device)
    t = torch.zeros_like(l)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, k.shape[1], block):
        kt, vt = k[:, k0:k0 + block].float(), v[:, k0:k0 + block].float()
        x = torch.einsum("bqd,bkd->bqk", qf, kt) * (log2e / math.sqrt(d))
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[1], device=q.device)
            x = torch.where(qpos >= kpos[None, :], x, -1e30)
        dp = torch.einsum("bqd,bkd->bqk", dof, vt)
        m_new = torch.maximum(m, x.amax(dim=-1))
        p = torch.exp2(x - m_new[..., None])
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        t = t * alpha + (p * dp).sum(dim=-1)
        m = m_new
    return (m + torch.log2(l)) / log2e, t / l


def _softmax(s: torch.Tensor) -> torch.Tensor:
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / torch.sum(e, dim=-1, keepdim=True)
