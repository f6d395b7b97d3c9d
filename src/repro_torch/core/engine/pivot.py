"""Pivot/branch-selection strategies behind one interface (DESIGN.md §2.4).

Backends:
  'pivot'   — Tomita max-|N(u) ∩ P| pivot over P ∪ X (universe + X0 rows)
  'revised' — same but the pool is restricted to P (paper's revised BK)
  'rcd'     — top-down clique test + min-degree branching, selected per
              visit (no branch set is precomputed at call entry)
  'hybrid'  — 'pivot' plus the per-node checks of Wang et al. (PAPERS.md):
              early termination / X-domination pruning at call entry
              (`hybrid_early_term`) and a density-triggered switch to
              vertex branching (B = P) on near-clique nodes

Every score sweep is a fused AND+popcount(+argmax) dispatch through
`bitset_ops.ops` (the whole branch-set select is one, `pivot_select`, and
the rcd maximality test one, `rcd_dominated`);
nothing here touches `ref` or the kernels directly.
All tensors carry the root batch R first (see `frames`).
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import frames as fr
from repro_torch.kernels.bitset_ops import ops as bitops

# 'hybrid' branch selection: switch from pivot- to vertex-branching (B = P)
# when the induced density 2|E[P]| / (|P|·(|P|−1)) reaches
# cfg.hybrid_density (DESIGN.md §2.7); this is its default, the one value
# the reference's run() uses.
HYBRID_DENSITY = bitops.HYBRID_DENSITY


def branch_set(cfg, ctx: fr.RootContext, P, Xp, xal, red, deg=None):
    """Branch set B for the 'pivot'/'revised'/'hybrid' backends, in one
    launch (`ops.pivot_select`).

    B = P \\ N(pivot), the pivot the first best of the pool P ∪ Xp (P alone
    for 'revised') by degree in P, unless an alive X0 row scores strictly
    higher; 'hybrid' overrides to vertex branching (B = P) on nodes whose
    induced density reaches cfg.hybrid_density.

    `red` is the ReducedFrame from dynamic_reduce (None when dynamic
    reduction is off). With cfg.reuse_degrees (the default) its
    degP2/n_full replace the third AND+popcount sweep over A (§Perf):
    every `full` vertex was adjacent to ALL of P', so the degree over the
    final P is degP2 − n_full for the pool. With dynamic reduction off,
    `deg` (the fused frame-step degree vector over this very P) plays the
    same role. With neither, or with cfg.reuse_degrees=False (the paper's
    three sweeps: the reference then ignores both), the kernel sweeps A
    itself."""
    n_full = None
    if not cfg.reuse_degrees:
        deg = None
    elif red is not None:
        deg, n_full = red.degP2, red.n_full
    return bitops.pivot_select(ctx.A, ctx.x_rows, P, Xp, xal, deg, n_full,
                               revised=cfg.backend == "revised",
                               hybrid=cfg.backend == "hybrid",
                               density=cfg.hybrid_density)


def hybrid_early_term(carry, cfg, ctx: fr.RootContext, P, Xp, xal, Rb, rsz,
                      enable):
    """'hybrid' call-entry checks (Wang et al., PAPERS.md): one fused
    census over the adjacency and X0 rows (`bitops.hybrid_census`, which
    reads both where they lie and derives its row selectors from P, Xp
    and xal) decides, per root,

    * early termination — P induces a clique (every member is adjacent to
      the |P|−1 others), so R ∪ P is the subtree's ONLY maximal candidate:
      report it (unless dominated) and pop without recursing;
    * X-domination pruning — some forbidden x dominates P (P ⊆ N(x)), so
      every candidate R ∪ S with S ⊆ P below this node is extendable by x:
      pop silently.

    Returns (carry, stop), stop (R,) bool: True means don't push the
    frame. The report is gated by `enable`, so the persistent engine's
    refill claims and live-masked lane steps inherit the same gating as
    every other carry write."""
    n_full, n_dom, psize = bitops.hybrid_census(ctx.A, ctx.x_rows, P, Xp,
                                                xal)
    is_clique = (n_full == psize) & (psize > 0)
    dominated = n_dom > 0
    size = rsz + psize
    carry = fr.report_single(carry, cfg, Rb | P, size,
                             is_clique & ~dominated & (size >= 2) & enable)
    # psize == 0 makes domination vacuous (pc == 0 == |P| for every alive
    # x), but the empty-P frame is never pushed anyway — keep stop False
    # there so the leaf report stays the single authority.
    return carry, is_clique | (dominated & (psize > 0))


def rcd_select(ctx: fr.RootContext, P):
    """'rcd' per-visit branching: (has_branch, w), both (R,).

    P is a clique iff every member has degree |P|−1 inside P; otherwise
    branch on the first minimum-degree member (argmin returns the first
    minimum, as jnp.argmin; non-members score the reference's 1 << 30)."""
    degP = bitops.and_popcount_rows(ctx.A, P)
    in_p = fr.bitset_to_mask(P, ctx.u)
    psize = in_p.sum(-1, keepdim=True, dtype=torch.int32)
    is_clique = (~in_p | (degP == psize - 1)).all(-1)
    w = torch.where(in_p, degP, 1 << 30).argmin(-1)
    return ~is_clique, w.to(torch.int32)


def rcd_maximality_report(carry, cfg, ctx: fr.RootContext, P, Xp, xal, Rb,
                          rsz, has_branch):
    """'rcd' pop-path report: R ∪ P if no forbidden vertex dominates P.

    x blocks iff P ⊆ N(x) ⟺ popcount(P & ~N(x)) == 0 (paper Alg 3), over
    the alive X0 rows and the universe rows of Xp: one launch
    (`bitops.rcd_dominated`), which reads only those rows and takes their
    complement itself, and gives |P| beside."""
    blocked, psize = bitops.rcd_dominated(ctx.A, ctx.x_rows, P, Xp, xal)
    size = rsz + psize
    ok = ~blocked & (size >= 2) & (psize > 0) & ~has_branch
    return fr.report_single(carry, cfg, Rb | P, size, ok)
