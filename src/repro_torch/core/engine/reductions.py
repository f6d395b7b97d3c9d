"""Dynamic (per-call) reductions as pure functions on frames (DESIGN.md §4).

The paper's Lemmas 5 (degree-0), 7 (relaxed degree-1) and 8 (degree-|P|−1)
become bitset algebra over the frame: every degree vector is one fused
AND+popcount sweep through `bitset_ops.ops`, every report is a masked
multi-row append to the carry. No control flow — callers gate side-effects
with `enable` so the DFS body stays straight-line over the root batch.
All tensors carry the root batch R first (see `frames`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.engine import frames as fr
from repro_torch.kernels.bitset_ops import ops as bitops


class ReducedFrame(NamedTuple):
    """Post-reduction frame pieces + degree info reusable by pivot select."""
    P: torch.Tensor
    Xp: torch.Tensor
    xal: torch.Tensor
    Rb: torch.Tensor
    rsz: torch.Tensor
    degP2: torch.Tensor      # deg over the Lemma-5/7-reduced P (pre-Lemma-8)
    n_full: torch.Tensor     # |full| absorbed by Lemma 8


def dynamic_reduce(carry, cfg, ctx: fr.RootContext, P, Xp, xal, rsz, Rb,
                   enable, pre=None):
    """Apply Lemmas 5/7/8 to each root's call (R, P, X); report advance
    cliques.

    Returns (carry, ReducedFrame). All clique reports are gated by `enable`
    (R,); the frame outputs are well-defined garbage where enable is False
    (the caller's stack write lands in a dead slot).

    `pre` is the optional (degP, partner) pair from the fused frame-step
    kernel — the DFS body already swept A against this call's P to build
    it, so passing it here removes the first AND+popcount sweep and the
    Lemma-7 partner extraction from this function."""
    U, XC, W = ctx.u, ctx.xc, ctx.words
    A, eye = ctx.A, ctx.eye
    xal_mask = fr.bitset_to_mask(xal, XC)
    en = enable.unsqueeze(-1)

    if pre is None:
        degP = bitops.and_popcount_rows(A, P)          # (R, U)
        partner0 = fr.single_bit_index_rows(bitops.and_rows(A, P))
    else:
        degP, partner0 = pre
    in_p = fr.bitset_to_mask(P, U)
    xp_mask = fr.bitset_to_mask(Xp, U)
    marked_bits = fr.or_reduce(ctx.x_rows, xal_mask) | fr.or_reduce(A, xp_mask)
    marked = fr.bitset_to_mask(marked_bits, U)

    # dynamic degree-zero (Lemma 5)
    deg0 = in_p & (degP == 0)
    rep0 = deg0 & ~marked
    rows = Rb.unsqueeze(-2) | eye if cfg.out_cap else None
    carry = fr.report_multi(carry, cfg, rows,
                            (rsz + 1).unsqueeze(-1).expand(-1, U),
                            rep0 & en)
    Xp = Xp | fr.mask_to_bitset(rep0, W)

    # relaxed dynamic degree-one (Lemma 7)
    deg1 = in_p & (degP == 1)
    pclip = partner0.long().clamp(0, U - 1)   # partner valid where deg == 1
    partner_deg1 = deg1 & deg1.gather(-1, pclip)
    iota = torch.arange(U, device=P.device)
    mutual_skip = partner_deg1 & (pclip < iota)
    cond = deg1 & ~mutual_skip & (~marked | ~marked.gather(-1, pclip))
    rows = Rb.unsqueeze(-2) | eye | eye[pclip] if cfg.out_cap else None
    carry = fr.report_multi(carry, cfg, rows,
                            (rsz + 2).unsqueeze(-1).expand(-1, U),
                            cond & en)
    rem1 = cond | (partner_deg1 & cond.gather(-1, pclip))
    Xp = Xp | fr.mask_to_bitset(rem1, W)
    removed = deg0 | rem1
    P = P & ~fr.mask_to_bitset(removed, W)

    # dynamic degree-(|P|-1) (Lemma 8)
    degP2 = bitops.and_popcount_rows(A, P)
    in_p2 = fr.bitset_to_mask(P, U)
    psize = fr.popcount(P).unsqueeze(-1)
    full = in_p2 & (degP2 == psize - 1) & (psize > 0)
    any_full = full.any(-1)
    n_full = full.sum(-1, dtype=torch.int32)
    full_bits = fr.mask_to_bitset(full, W)
    common = fr.and_reduce(A, full)                      # C(S) over universe
    sub_ok = bitops.and_popcount_rows(ctx.not_x_rows, full_bits) == 0
    af = any_full.unsqueeze(-1)
    P, Xp, xal, Rb, rsz = (
        torch.where(af, P & ~full_bits, P),
        torch.where(af, Xp & common, Xp),
        torch.where(af, xal & fr.mask_to_bitset(sub_ok, ctx.xc_words), xal),
        torch.where(af, Rb | full_bits, Rb),
        torch.where(any_full, rsz + n_full, rsz),
    )
    return carry, ReducedFrame(P=P, Xp=Xp, xal=xal, Rb=Rb, rsz=rsz,
                               degP2=degP2, n_full=n_full)
