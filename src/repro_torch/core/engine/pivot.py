"""Pivot/branch-selection strategies behind one interface (DESIGN.md §2.4).

Backends ported so far:
  'pivot'   — Tomita max-|N(u) ∩ P| pivot over P ∪ X (universe + X0 rows)
  'revised' — same but the pool is restricted to P (paper's revised BK)

'rcd' and 'hybrid' are not ported yet (ROADMAP Queue 1 item 5); `run`
refuses them.

Every score sweep is a fused AND+popcount(+argmax) dispatch through
`bitset_ops.ops`; nothing here touches `ref` or the kernels directly.
All tensors carry the root batch R first (see `frames`).
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import frames as fr
from repro_torch.kernels.bitset_ops import ops as bitops


def branch_set(cfg, ctx: fr.RootContext, P, Xp, xal, red, deg=None):
    """Branch set B = P \\ N(pivot) for the 'pivot'/'revised' backends.

    `red` is the ReducedFrame from dynamic_reduce (None when dynamic
    reduction is off); its degP2/n_full replace the third AND+popcount
    sweep over A (§Perf; the reference's default `reuse_degrees=True`,
    the only setting the port has). With dynamic reduction off, `deg`
    (the fused frame-step degree vector over this very P) plays the same
    role — where + argmax over it matches and_popcount_argmax's scores
    and tie-breaking exactly. With neither (root entry without dynamic
    reduction) the fused pivot-select kernel scores the universe."""
    if cfg.backend not in fr.PORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {cfg.backend!r} is not ported yet (ROADMAP Queue 1 "
            f"item 5)")
    in_p = fr.bitset_to_mask(P, ctx.u)
    if cfg.backend == "revised":
        pool = in_p
    else:
        pool = in_p | fr.bitset_to_mask(Xp, ctx.u)

    if red is not None:
        # §Perf: every `full` vertex was adjacent to ALL of P', so deg over
        # the final P is exactly degP2 − n_full for surviving P members —
        # reuse instead of a third AND+popcount sweep of A.
        deg_vec = red.degP2 - red.n_full.unsqueeze(-1)
    elif deg is not None:
        deg_vec = deg
    else:
        deg_vec = None
    if deg_vec is not None:
        uni_scores = torch.where(pool, deg_vec, -1)
        best_u = uni_scores.argmax(-1)
        su = uni_scores.gather(-1, best_u.unsqueeze(-1)).squeeze(-1)
    else:
        best_u, su = bitops.and_popcount_argmax(ctx.A, P, pool)
    best_x, sx = bitops.and_popcount_argmax(ctx.x_rows, P,
                                            fr.bitset_to_mask(xal, ctx.xc))
    use_x = (sx > su).unsqueeze(-1)
    pivot_row = torch.where(use_x, ctx.x_rows[ctx.ar, best_x.long()],
                            ctx.A[ctx.ar, best_u.long()])
    return P & ~pivot_row
