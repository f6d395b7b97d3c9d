"""Plain PyTorch versions of the bitset AND+popcount kernels.

Bitsets keep the reference package's layout: W words of 32 bits per row,
bit i of a row in word i // 32 at position i % 32. The words are stored
as `torch.int32` and read bit for bit as unsigned (torch's `uint32` lacks
`~`, shifts, add/sub, `max` and `index_put`). With int32 storage `>>` is
arithmetic, so every shift that extracts bits masks after shifting, and
`1 << 31` is the bit pattern of INT_MIN.

Every function takes explicit leading batch dims (the engine passes the
bucket's root batch first: rows (R, K, W), masks (R, W)). These are the
CPU path of `ops` and the oracle the CUDA kernels are held against.
The word-level helpers they share with the engine live in `words`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.bitset_ops.words import (  # noqa: F401
    WORD, and_reduce, and_rows, bits_to_mask, first_bit_index, mask_to_bits,
    onehot, popcount, popcount_words)

# The 'hybrid' backend's switch to vertex branching (B = P): the induced
# density 2|E[P]| / (|P|·(|P|−1)) at which `pivot_select` takes it by
# default (the reference's `EngineConfig.hybrid_density` default).
HYBRID_DENSITY = 0.9


def and_popcount_rows(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """popcount(rows & mask) reduced over the word axis.

    rows: (..., K, W) int32, mask: (..., W) int32 -> (..., K) int32. This
    is `|N(u) ∩ P|` for every u at once."""
    return popcount_words(rows & mask.unsqueeze(-2))


def and_popcount_argmax(rows: torch.Tensor, mask: torch.Tensor,
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused pivot-select: argmax over popcount(rows & mask) scores.

    rows: (..., K, W) int32, mask: (..., W) int32, valid: (..., K) bool.
    Returns (idx, best), both (...,) int32: the index of the first
    best-scoring row and its score. Invalid rows score -1, so an
    all-invalid batch row gives (0, -1). torch.argmax returns the first
    maximal index, as jnp.argmax does."""
    scores = and_popcount_rows(rows, mask)
    if valid is not None:
        scores = torch.where(valid, scores, -1)
    idx = scores.argmax(-1)
    best = scores.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    return idx.to(torch.int32), best


def clique_counts(rows: torch.Tensor, mask: torch.Tensor, in_p: torch.Tensor,
                  in_x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused early-termination census of the 'hybrid' backend.

    rows: (..., K, W) int32, mask: (..., W) int32 (the candidate set P),
    in_p/in_x: (..., K) bool row selectors -> (n_full, n_dom), both
    (...,) int32, with pc[k] = popcount(rows[k] & mask):
      n_full = #{k : in_p[k] ∧ pc[k] == popcount(mask) − 1}
      n_dom  = #{k : in_x[k] ∧ pc[k] == popcount(mask)}
    With rows = adjacency stacked on X0 rows, P induces a clique iff
    n_full == |P|, and some forbidden vertex dominates P iff n_dom > 0."""
    pc = and_popcount_rows(rows, mask)
    msize = popcount_words(mask).unsqueeze(-1)
    n_full = (in_p & (pc == msize - 1)).sum(-1, dtype=torch.int32)
    n_dom = (in_x & (pc == msize)).sum(-1, dtype=torch.int32)
    return n_full, n_dom


def hybrid_census(a: torch.Tensor, x_rows: torch.Tensor, P: torch.Tensor,
                  Xp: torch.Tensor, x_alive: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 'hybrid' call-entry census on the engine's own operands:
    `clique_counts` over A stacked on the X0 rows, with the selectors the
    engine builds from the bitsets, and |P| beside it.

    a: (..., U, W), x_rows: (..., XC, W), P/Xp: (..., W) int32 words,
    x_alive: (..., XCW) int32 bits over the X0 rows -> (n_full, n_dom,
    psize), each (...,) int32. in_p is P's bits below U, False on the X0
    rows; in_x is Xp's bits below U, then x_alive's first XC bits; psize
    counts in_p. Exactly the composition of the reference's
    `pivot.hybrid_early_term` (`bitset_to_mask`, `concatenate`, `pad`,
    `clique_counts`)."""
    u, xc = a.shape[-2], x_rows.shape[-2]
    in_p = bits_to_mask(P, u)
    psize = in_p.sum(-1, dtype=torch.int32)
    in_x = torch.cat([bits_to_mask(Xp, u), bits_to_mask(x_alive, xc)], -1)
    n_full, n_dom = clique_counts(torch.cat([a, x_rows], -2), P,
                                  torch.nn.functional.pad(in_p, (0, xc)),
                                  in_x)
    return n_full, n_dom, psize


def lemma8_reduce(a: torch.Tensor, x_rows: torch.Tensor, P: torch.Tensor,
                  Xp: torch.Tensor, xal: torch.Tensor, Rb: torch.Tensor,
                  rsz: torch.Tensor):
    """The dynamic degree-(|P|−1) reduction (Lemma 8) of one call per root,
    on the engine's operands: exactly the Lemma-8 block of the reference's
    `reductions.dynamic_reduce` (two `and_popcount_rows` sweeps and the
    torch ops around them).

    a: (..., U, W), x_rows: (..., XC, W), P/Xp/Rb: (..., W), xal: (...,
    XCW) bits over the X0 rows, rsz: (...) int32. Returns (P, Xp, xal, Rb,
    rsz, degP2, n_full): degP2[u] = popcount(a[u] & P) over the P handed
    in, and full = {u ∈ P : degP2[u] = |P| − 1} (|P| > 0) of size n_full.
    Where full is not empty, P loses it, Rb gains it, rsz grows by n_full,
    Xp keeps the vertices adjacent to all of it, and xal keeps the alive
    X0 rows x < XC with full ⊆ N(x) and loses its bits past XC; elsewhere
    the frame is returned as it is."""
    u, w = a.shape[-2:]
    degP2 = and_popcount_rows(a, P)
    psize = popcount_words(P).unsqueeze(-1)
    full = bits_to_mask(P, u) & (degP2 == psize - 1) & (psize > 0)
    any_full = full.any(-1)
    n_full = full.sum(-1, dtype=torch.int32)
    full_bits = mask_to_bits(full, w)
    common = and_reduce(a, full)                     # C(S) over the universe
    sub_ok = and_popcount_rows(~x_rows, full_bits) == 0
    af = any_full.unsqueeze(-1)
    return (torch.where(af, P & ~full_bits, P),
            torch.where(af, Xp & common, Xp),
            torch.where(af, xal & mask_to_bits(sub_ok, xal.shape[-1]), xal),
            torch.where(af, Rb | full_bits, Rb),
            torch.where(any_full, rsz + n_full, rsz),
            degP2, n_full)


def _row_at(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows[..., idx[...], :]: (..., K, W), (...) -> (..., W)."""
    return rows.gather(-2, idx.long()[..., None, None].expand(
        idx.shape + (1, rows.shape[-1]))).squeeze(-2)


def pivot_select(a: torch.Tensor, x_rows: torch.Tensor, P: torch.Tensor,
                 Xp: torch.Tensor, xal: torch.Tensor,
                 deg: Optional[torch.Tensor] = None,
                 n_full: Optional[torch.Tensor] = None, *,
                 revised: bool = False, hybrid: bool = False,
                 density: float = HYBRID_DENSITY) -> torch.Tensor:
    """The branch set B of the pivot backends on the engine's operands:
    exactly the body of the reference's `pivot.branch_set`.

    a: (..., U, W), x_rows: (..., XC, W), P/Xp: (..., W), xal: (..., XCW)
    bits over the X0 rows; deg: (..., U) and n_full: (...) int32, or None.
    The universe scores are deg − n_full (both given), deg, or, with
    neither, popcount(a[u] & P); a pool row (P ∪ Xp, or P alone when
    `revised`) scores its degree, any other −1, and the first best wins.
    The first best alive X0 row (the bits of xal below XC) scores
    popcount(x & P) and is the pivot if it scores strictly higher (XC = 0:
    never). B = P & ~pivot_row; with `hybrid`, B = P where the scores of
    P's members below U sum to at least density·|P|·(|P| − 1), |P| the
    popcount of P's words, in float32 and in that order."""
    u, xc = a.shape[-2], x_rows.shape[-2]
    in_p = bits_to_mask(P, u)
    pool = in_p if revised else in_p | bits_to_mask(Xp, u)
    if deg is None:
        deg = and_popcount_rows(a, P)
    elif n_full is not None:
        deg = deg - n_full.unsqueeze(-1)
    scores = torch.where(pool, deg, -1)
    best_u = scores.argmax(-1)
    su = scores.gather(-1, best_u.unsqueeze(-1)).squeeze(-1)
    pivot_row = _row_at(a, best_u)
    if xc:
        best_x, sx = and_popcount_argmax(x_rows, P, bits_to_mask(xal, xc))
        pivot_row = torch.where((sx > su).unsqueeze(-1),
                                _row_at(x_rows, best_x), pivot_row)
    B = P & ~pivot_row
    if hybrid:
        # Σ_{v∈P} deg_P(v) = 2|E[P]|, so the trigger is sum_deg ≥
        # density·|P|·(|P|−1), in the reference's float32 expression and
        # order (counts stay below 2^24, exact in float32)
        psize = popcount_words(P)
        sum_deg = torch.where(in_p, deg, 0).sum(-1)
        dense = (sum_deg.to(torch.float32)
                 >= density * psize.to(torch.float32)
                 * (psize - 1).to(torch.float32))
        B = torch.where(dense.unsqueeze(-1), P, B)
    return B


def and_popcount_many(rows: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """One row matrix against a batch of masks.

    rows: (..., K, W) int32, masks: (..., M, W) int32 -> (..., M, K)
    int32 with out[m, k] = popcount(rows[k] & masks[m]): the X-subset
    maximality test `P ⊆ N(x)` for every forbidden row x is
    `and_popcount_many(P[..., None, :], ~x_rows)[..., 0] == 0`."""
    return popcount_words(rows.unsqueeze(-3) & masks.unsqueeze(-2))


def frame_step(rows: torch.Tensor, p: torch.Tensor, xp: torch.Tensor,
               wrow: torch.Tensor):
    """Fused BK frame step: child-set construction + degree/partner sweep.

    rows: (..., K, W) int32 adjacency, p/xp/wrow: (..., W) int32.
    Returns (childp, childxp, deg, partner):
      childp  = p  & wrow                      (..., W)  child candidate set
      childxp = xp & wrow                      (..., W)  child forbidden set
      deg[k]  = popcount(rows[k] & childp)     (..., K)  child degree vector
      partner[k] = Σ_words (32·w + lowest-set-bit-pos) over nonzero words of
      rows[k] & childp — the exact bit index when deg[k] == 1 (the Lemma-7
      partner), deterministic garbage otherwise.
    """
    childp = p & wrow
    childxp = xp & wrow
    anded = rows & childp.unsqueeze(-2)
    deg = popcount_words(anded)
    pos = popcount((anded & -anded) - 1)
    wi = WORD * torch.arange(anded.shape[-1], dtype=torch.int32,
                             device=rows.device)
    partner = torch.where(anded != 0, wi + pos, 0).sum(-1, dtype=torch.int32)
    return childp, childxp, deg, partner


def branch_step(a: torch.Tensor, x_rows: torch.Tensor, sP: torch.Tensor,
                sB: torch.Tensor, sXp: torch.Tensor, sRb: torch.Tensor,
                srsz: torch.Tensor, sxal: torch.Tensor, depth: torch.Tensor,
                live: torch.Tensor, w: Optional[torch.Tensor] = None):
    """The branch half of the engine's DFS step (its call entry apart) on
    the DFS stack itself: exactly the torch code of `loop.dfs_step` around
    its `frame_step`.

    a: (R, U, W), x_rows: (R, XC, W); the stack's buffers sP/sB/sXp/sRb
    (R, D, W), srsz (R, D), sxal (R, D, XCW); depth (R,), live (R,) bool;
    w (R,) int or None. Each root reads its slot d = max(depth, 0). With
    w None (the pivot family) has_branch = (B != 0) & live and w is B's
    first bit (32 for an empty B) clamped to U − 1; with w given ('rcd')
    has_branch = live. Returns (has_branch, childP, childXp, childxal,
    childRb, child_rsz, deg, partner): `frame_step` over a against P, Xp
    and wrow = a[w], the slot's alive X0 rows below XC adjacent to w, Rb ∪
    {w} and rsz + 1, whatever has_branch says. Where has_branch holds the
    slot is updated IN PLACE: P loses w, Xp gains it, and (w None) B
    loses it; elsewhere the slot keeps its values."""
    R, U, W = a.shape
    ar = torch.arange(R, device=a.device)
    d = depth.clamp(min=0)
    P, B, Xp, Rb, rsz, xal = (t[ar, d] for t in (sP, sB, sXp, sRb, srsz,
                                                  sxal))
    pivot_family = w is None
    if pivot_family:
        has_branch = (B != 0).any(-1) & live
        # an all-zero B gives 32, past U when U <= 32: clamp; every use is
        # masked by has_branch
        w = first_bit_index(B).clamp(max=U - 1)
    else:
        has_branch = live
        w = w.long()
    wbit = torch.where(torch.arange(W, device=a.device) == (w // WORD)
                       .unsqueeze(-1), onehot(a.device)[w % WORD]
                       .unsqueeze(-1), 0)
    childP, childXp, deg, partner = frame_step(a, P, Xp, a[ar, w])
    # X0 rows stay alive iff adjacent to w (bit w of their row)
    row_word = x_rows[ar, :, w // WORD]                         # (R, XC)
    adj_w = ((row_word >> (w % WORD).to(torch.int32).unsqueeze(-1)) & 1) != 0
    childxal = xal & mask_to_bits(adj_w, sxal.shape[-1])
    hb = has_branch.unsqueeze(-1)
    sP[ar, d] = torch.where(hb, P & ~wbit, P)
    sXp[ar, d] = torch.where(hb, Xp | wbit, Xp)
    if pivot_family:
        sB[ar, d] = torch.where(hb, B & ~wbit, B)
    return (has_branch, childP, childXp, childxal, Rb | wbit, rsz + 1, deg,
            partner)


def rcd_dominated(a: torch.Tensor, x_rows: torch.Tensor, P: torch.Tensor,
                  Xp: torch.Tensor, xal: torch.Tensor):
    """The 'rcd' maximality test on the engine's operands: exactly the
    reference's `pivot.rcd_maximality_report` up to its report, over the
    complement of the X0 rows stacked on the complement of a.

    a: (..., U, W), x_rows: (..., XC, W), P/Xp: (..., W), xal: (..., XCW)
    bits over the X0 rows -> (blocked (...) bool, psize (...) int32):
    blocked iff some alive X0 row (xal's bits below XC) or universe row of
    Xp (its bits below U) contains P (popcount(P & ~row) == 0; an empty P
    is contained in every row), psize = |P|, all of its words' bits."""
    u, xc = a.shape[-2], x_rows.shape[-2]
    sub = and_popcount_many(P.unsqueeze(-2),
                            torch.cat([~x_rows, ~a], -2))[..., 0]
    in_x = torch.cat([bits_to_mask(xal, xc), bits_to_mask(Xp, u)], -1)
    return (in_x & (sub == 0)).any(-1), popcount_words(P)


def dfs_step_window_lanes(a: torch.Tensor, x_rows: torch.Tensor,
                          alive0: torch.Tensor, winP: torch.Tensor,
                          winB: torch.Tensor, winXp: torch.Tensor,
                          winRb: torch.Tensor, winrsz: torch.Tensor,
                          dloc: torch.Tensor, steps: int):
    """Up to `steps` masked BK frame-steps per lane over a T-frame stack
    window (pivot backend, dynamic reduction off, counting only).

    a: (L, U, W) and x_rows: (L, XC, W) int32 words; alive0: (L, XC)
    0/1 root X0 alive mask; winP/winB/winXp/winRb: (L, T, W); winrsz:
    (L, T); dloc: (L,) window-local depth, < 0 for a dead lane. Returns
    the updated windows (new tensors; the inputs are not touched) and
    ctl (L, 8) int32 = [dloc', calls, branches, sum_px, cliques,
    steps_done, 0, 0].

    The per-frame X0 alive set does not ride in the window: it is a
    closed form of the frame's Rb, `alive[x] = alive0[x] ∧ Rb ⊆ N(x)`.
    A lane stops when it pops below the window (dloc' = −1) or when a
    branch step would push past the top slot (dloc' = T−1 with branches
    left); a dead lane returns unchanged with zero deltas. Lanes are
    independent: each step runs on every lane with its effects masked by
    that lane's own `act`, which is exact because a lane that does not
    act in a step is done for good."""
    L, T, W = winP.shape
    U, XC = a.shape[1], x_rows.shape[1]
    dev = a.device
    wP, wB, wXp, wRb = (t.clone() for t in (winP, winB, winXp, winRb))
    wrsz = winrsz.to(torch.int32).clone()
    lane = torch.arange(L, device=dev)
    iota_w = torch.arange(W, dtype=torch.int32, device=dev)
    iota_u = torch.arange(U, device=dev)
    bit = onehot(dev)
    alive0 = alive0 != 0
    dl = dloc.to(torch.int32).clone()
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    z = torch.zeros(L, dtype=torch.int32, device=dev)
    it, calls, branches, spx, clq = z.clone(), z.clone(), z.clone(), \
        z.clone(), z.clone()
    for _ in range(steps):
        if bool(done.all()):
            break
        d = dl.clamp(0, T - 1).long()
        fP, fB, fXp = wP[lane, d], wB[lane, d], wXp[lane, d]
        fRb, frsz = wRb[lane, d], wrsz[lane, d]
        has_branch = (fB != 0).any(-1)
        blocked = has_branch & (dl >= T - 1)
        act = ~done & ~blocked & (dl >= 0)
        done = done | blocked | (dl < 0)

        # lowest set bit of B, clamped to U−1 (an empty B gives U−1)
        pos = popcount((fB & -fB) - 1)
        first = torch.where(fB != 0, WORD * iota_w + pos, 1 << 30).amin(-1)
        w = first.clamp(0, U - 1).long()
        wbit = torch.where(iota_w == (w // WORD).unsqueeze(-1),
                           bit[w % WORD].unsqueeze(-1), 0)
        wrow = a[lane, w]
        childP = fP & wrow
        childXp = fXp & wrow
        childRb = fRb | wbit
        deg = and_popcount_rows(a, childP)                    # (L, U)
        pcx = and_popcount_rows(x_rows, childP)               # (L, XC)
        pc_rb = popcount_words(childRb)
        alive = alive0 & (and_popcount_rows(x_rows, childRb)
                          == pc_rb.unsqueeze(-1))

        en = act & has_branch
        en_i = en.to(torch.int32)
        branches = branches + en_i
        calls = calls + en_i
        pc_p = popcount_words(childP)
        pc_x = popcount_words(childXp)
        nal = alive.sum(-1, dtype=torch.int32)
        spx = spx + (pc_p + pc_x + nal) * en_i
        p_empty = pc_p == 0
        x_empty = (nal == 0) & (pc_x == 0)
        crsz = frsz + 1
        clq = clq + (p_empty & x_empty & (crsz >= 2) & en).to(torch.int32)
        push = ~p_empty & en

        # pivot over P ∪ X: first argmax of the pool's degrees against the
        # first argmax of the alive X0 rows'; the X row wins only if higher
        pool = (((childP | childXp)[:, iota_u // WORD]
                 >> (iota_u % WORD).to(torch.int32)) & 1) != 0
        su_s = torch.where(pool, deg, -1)
        best_u = su_s.argmax(-1)
        su = su_s.gather(-1, best_u.unsqueeze(-1)).squeeze(-1)
        sx_s = torch.where(alive, pcx, -1)
        best_x = sx_s.argmax(-1)
        sx = sx_s.gather(-1, best_x.unsqueeze(-1)).squeeze(-1)
        use_x = (sx > su).unsqueeze(-1)
        pivot_row = torch.where(use_x, x_rows[lane, best_x], a[lane, best_u])
        childB = childP & ~pivot_row

        # current frame: P \ w, X ∪ w, B \ w (identity when not branching)
        e = en.unsqueeze(-1)
        wP[lane, d] = torch.where(e, fP & ~wbit, fP)
        wXp[lane, d] = torch.where(e, fXp | wbit, fXp)
        wB[lane, d] = torch.where(e, fB & ~wbit, fB)
        # child frame at d+1, written only when descended into
        cd = (d + 1).clamp(0, T - 1)
        p = push.unsqueeze(-1)
        wP[lane, cd] = torch.where(p, childP, wP[lane, cd])
        wB[lane, cd] = torch.where(p, childB, wB[lane, cd])
        wXp[lane, cd] = torch.where(p, childXp, wXp[lane, cd])
        wRb[lane, cd] = torch.where(p, childRb, wRb[lane, cd])
        wrsz[lane, cd] = torch.where(push, crsz, wrsz[lane, cd])

        dl = torch.where(act, torch.where(has_branch,
                                          torch.where(push, dl + 1, dl),
                                          dl - 1), dl)
        it = it + act.to(torch.int32)
    ctl = torch.stack([dl, calls, branches, spx, clq, it, z, z], -1)
    return wP, wB, wXp, wRb, wrsz, ctl


def dfs_step_window(a, x_rows, alive0, winP, winB, winXp, winRb, winrsz,
                    dloc, steps: int):
    """`dfs_step_window_lanes` with any leading batch dims, none included:
    a (..., U, W), windows (..., T, W), winrsz (..., T), dloc (...) and
    ctl (..., 8). The single-root form is the 2-D call."""
    lead = tuple(winP.shape[:-2])

    def flat(t, tail):
        return t.reshape((-1,) + tuple(t.shape[t.dim() - tail:]))

    outs = dfs_step_window_lanes(
        flat(a, 2), flat(x_rows, 2), flat(alive0, 1), flat(winP, 2),
        flat(winB, 2), flat(winXp, 2), flat(winRb, 2), flat(winrsz, 1),
        dloc.reshape(-1), steps)
    return tuple(o.reshape(lead + tuple(o.shape[1:])) for o in outs)
