"""The DFS loops + single-host API (DESIGN.md §2.5, §2.6).

Composes the layers: `prepare` stages host-side buckets, `reductions`
applies the per-call lemmas, `pivot` picks branch sets, and this module
owns call entry, the explicit stack walk over a bucket's root batch, the
persistent lane engine, and the end-to-end `run()`.

Per-root engine: the reference vmaps a `lax.while_loop` over the roots of
a bucket; here one Python loop steps every root of the bucket at once,
with a per-root `live = (depth >= 0) & (iters < max_iters)`. A root that
is not live runs the same masked step with every side effect off and its
depth unchanged (the reference's `dfs_step(..., live=)` contract), so
every counter matches the vmapped loop. Whether any root is still live is
read on the host only every `LIVE_CHECK_EVERY` steps: each read is a
device sync, and the extra steps are exact no-ops.

Persistent engine: the reference's jitted `while_loop` with `lax.cond`
phases becomes a Python loop whose branch predicates are read on the host
(one small device sync each). Every branch runs exactly when the
reference's cond would take it, so `iters`, `steals` and the other
scheduling stats match it trip for trip.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import frames as fr
from repro_torch.core.engine import pivot as piv
from repro_torch.core.engine import reductions as red
from repro_torch.core.engine.frames import (WORD, EngineConfig, Frame,
                                            FrameStack)
from repro_torch.core.engine.prepare import (_unpack_bits_np, estimate_costs,
                                             prepare)
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels.bitset_ops import ops as bitops


LIVE_CHECK_EVERY = 64


# ===========================================================================
# Call-entry: dynamic reduction + leaf report + branch-set construction
# ===========================================================================

def enter_call(carry, cfg, ctx: fr.RootContext, P, Xp, xal, rsz, Rb,
               enable, pre=None):
    """BK call entry for each root's (R, P, X). Returns (carry, push?,
    Frame), push (R,) bool.

    `enable` (R,) gates every carry side-effect (counter bumps, clique
    reports): the DFS body runs enter_call unconditionally and masks it
    out on pop-only steps.

    `pre` is the fused frame-step kernel's (deg, partner) pair over this
    call's P — the DFS body computes it while constructing the child sets,
    so dynamic reduction (and pivot scoring when reduction is off) reuses
    it instead of re-sweeping A."""
    en_i = enable.to(torch.int32)
    carry["calls"] = carry["calls"] + en_i
    # |P| + |Xp| + |X0 alive| in one popcount over the three bitsets
    carry["sum_px"] = carry["sum_px"] + fr.popcount(
        torch.cat([P, Xp, xal], -1)) * en_i

    # ---- dynamic reduction (paper Lemmas 5, 7, 8) ----
    if cfg.dynamic_red:
        carry, rf = red.dynamic_reduce(carry, cfg, ctx, P, Xp, xal, rsz, Rb,
                                       enable, pre=pre)
        P, Xp, xal, Rb, rsz = rf.P, rf.Xp, rf.xal, rf.Rb, rf.rsz
    else:
        rf = None

    # ---- leaf report ----
    p_empty = ~fr.any_bit(P)
    x_empty = ~fr.any_bit(xal) & ~fr.any_bit(Xp)
    carry = fr.report_single(carry, cfg, Rb, rsz,
                             p_empty & x_empty & (rsz >= 2) & enable)
    push = ~p_empty & enable

    # ---- hybrid early termination + X-domination pruning (§2.7) ----
    if cfg.backend == "hybrid":
        # P a clique -> report R ∪ P and pop; P dominated by a forbidden
        # vertex -> pop silently. The report is gated by `enable`, so the
        # persistent refill and lane steps get the live-mask gating too.
        carry, stop = piv.hybrid_early_term(carry, cfg, ctx, P, Xp, xal,
                                            Rb, rsz, enable)
        push = push & ~stop

    # ---- branch set (pivot backends; rcd recomputes per visit) ----
    if cfg.backend in fr.PIVOT_BACKENDS:
        B = piv.branch_set(cfg, ctx, P, Xp, xal, rf,
                           deg=None if pre is None else pre[0])
    else:
        B = torch.zeros_like(P)
    return carry, push, Frame(P=P, B=B, Xp=Xp, Rb=Rb, rsz=rsz, xal=xal)


# ===========================================================================
# Shared DFS step + per-bucket DFS loop
# ===========================================================================

def dfs_step(cfg, ctx: fr.RootContext, depth, stack, carry, live):
    """One straight-line masked DFS step for every root of the bucket.

    Branch work always executes with its carry side-effects gated by
    `has_branch`, and stack writes land in frames that are DEAD on the pop
    path (slots > new depth), so they need no gating at all.

    `live` (R,) bool: a root that is not live reads its clamped slot
    max(depth, 0), every side-effect is masked off, and its depth passes
    through unchanged. Its slot keeps its values (`branch_step` writes
    only where a root branches), and its child push lands above its
    depth, in a dead slot."""
    ar = ctx.ar
    d = depth.clamp(min=0)
    w, branch_live = None, live
    if cfg.backend not in fr.PIVOT_BACKENDS:
        # rcd: clique test decides report-and-pop vs min-degree branch
        f = stack.read(ar, d)
        hb, w = piv.rcd_select(ctx, f.P)
        branch_live = hb & live
        # ---- pop path: rcd maximality check + report (gated) ----
        carry = piv.rcd_maximality_report(carry, cfg, ctx, f.P, f.Xp, f.xal,
                                          f.Rb, f.rsz, branch_live | ~live)

    # ---- branch path: always computed, side-effects gated ----
    # one launch: the slot's first bit of B (the pivot family; the given w
    # for rcd), the child sets with the fused degree sweep and Lemma-7
    # partner (threaded into enter_call as `pre`), the X0 rows adjacent to
    # w, and the current slot's P \ w, X ∪ w, B \ w written in place where
    # the root branches (a dead slot on the pop path)
    (has_branch, childP, childXp, childxal, childRb, child_rsz, deg,
     partner) = bitops.branch_step(ctx.A, ctx.x_rows, *stack, depth,
                                   branch_live, w)
    carry["branches"] = carry["branches"] + has_branch.to(torch.int32)
    carry, push, child = enter_call(carry, cfg, ctx, childP, childXp,
                                    childxal, child_rsz, childRb,
                                    enable=has_branch, pre=(deg, partner))
    # write child frame (slot depth+1 is dead unless pushed)
    nd = d + 1
    stack.push(ar, nd, child)
    new_depth = torch.where(has_branch, torch.where(push, nd, d), d - 1)
    return torch.where(live, new_depth, depth), stack, carry


def _window_eligible(cfg: EngineConfig) -> bool:
    """Static gate for the FUSED stack-window walk: the `dfs_step_window`/
    `dfs_step_window_lanes` kernel contract covers the pivot backend with
    dynamic reduction off and counting only (no enumeration buffers ride
    in the window). Ineligible configs with `window_steps > 0` still
    window in the persistent engine — via the engine-step window, which
    runs the full `dfs_step` contract."""
    return (cfg.window_steps > 0 and cfg.backend == "pivot"
            and not cfg.dynamic_red and not cfg.out_cap
            and cfg.window_frames in (0, bitops.WINDOW_FRAMES))


def run_root_windowed(a, p0, x_rows, x_alive0, rsz0, cfg: EngineConfig):
    """`run_bucket` with every root's DFS stack walked through a T-frame
    window: each trip advances up to `cfg.window_steps` frame-steps per
    root in ONE `dfs_step_window` launch over the (R, T, W) windows.

    The top-T stack frames stay resident across those steps, and the
    stack is touched only at the window boundary — one T-slot gather
    down, one scatter back per trip. The per-frame X0 alive set is not
    stacked: it is a closed form of the frame's Rb (see
    ref.dfs_step_window_lanes), so the window carries (P, B, Xp, Rb,
    rsz). Each root's window is re-centered every trip (base = clip(d −
    T/2, 0, D − T)); the kernel stops early on window overflow or
    underflow and the next trip re-slices. A root whose walk is over
    (d < 0, or iters at cfg.max_iters) gets dloc = −1, a no-op, as the
    reference's vmapped while_loop freezes it. Counters and `iters` equal
    the reference's vmapped `run_root_windowed`."""
    R, U, W = a.shape
    T = bitops.WINDOW_FRAMES
    dev = a.device
    ctx = fr.make_context(a, x_rows)
    zeros = torch.zeros((R, W), dtype=torch.int32, device=dev)
    carry = fr.carry_init(cfg, R, W, dev)
    carry, push0, frame0 = enter_call(
        carry, cfg, ctx, p0, zeros, fr.mask_to_bitset(x_alive0, ctx.xc_words),
        rsz0.to(torch.int32), zeros,
        enable=torch.ones(R, dtype=torch.bool, device=dev))
    alive0 = x_alive0.to(torch.int32).contiguous()
    # depth never exceeds U = D − 2 (every push consumes a P vertex), so a
    # freshly centered window always has a free slot above the top frame
    D = max(U + 2, T)
    bufs = [torch.zeros((R, D, W), dtype=torch.int32, device=dev)
            for _ in range(4)]                               # P, B, Xp, Rb
    srsz = torch.zeros((R, D), dtype=torch.int32, device=dev)
    for buf, v in zip(bufs, (frame0.P, frame0.B, frame0.Xp)):
        buf[:, 0] = v
    srsz[:, 0] = frame0.rsz
    bufs.append(srsz)
    d = torch.where(push0, 0, -1).to(torch.int32)
    iters = torch.zeros(R, dtype=torch.int32, device=dev)

    steps = 0
    while R:
        active = (d >= 0) & (iters < cfg.max_iters)
        if steps % LIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        base = (d - T // 2).clamp(0, D - T)
        *win, ctl = bitops.dfs_step_window(
            a, x_rows, alive0, *(fr.slot_window(b, base, T) for b in bufs),
            torch.where(active, d - base, -1).to(torch.int32),
            steps=cfg.window_steps)
        for buf, w in zip(bufs, win):
            fr.put_slot_window(buf, base, w)
        for i, k in enumerate(("calls", "branches", "sum_px", "cliques"), 1):
            carry[k] = carry[k] + ctl[:, i]
        d = torch.where(active, base + ctl[:, 0], d)
        iters = iters + ctl[:, 5]
        steps += 1
    return dict(carry, iters=iters, truncated=(d >= 0).to(torch.int32),
                steps=steps)


def run_bucket(a, p0, x_rows, x_alive0, rsz0, cfg: EngineConfig):
    """Run the full BK subtree of every root of a bucket, in lock step.

    a (R, U, W), p0 (R, W), x_rows (R, XC, W) int32 words; x_alive0
    (R, XC) bool; rsz0 (R,) int32 — all on one device. Returns a dict of
    per-root tensors: the counters, the enumeration buffers when
    cfg.out_cap (out_rows (R, out_cap, W), out_sizes, out_n, overflow),
    `iters` (steps the root was live) and `truncated` (1 iff the root hit
    cfg.max_iters with frames still live — its counts are partial), plus
    `steps`, the number of batched steps taken (an int).

    With `cfg.window_steps > 0` and an eligible config (pivot backend,
    dynamic reduction off, counting only) the walk routes through the
    stack window (`run_root_windowed`): same counters, up to K steps per
    trip, and `steps` counts trips."""
    if _window_eligible(cfg):
        return run_root_windowed(a, p0, x_rows, x_alive0, rsz0, cfg)
    R, U, W = a.shape
    ctx = fr.make_context(a, x_rows)
    dev = a.device
    xal0 = fr.mask_to_bitset(x_alive0, ctx.xc_words)
    zeros = torch.zeros((R, W), dtype=torch.int32, device=dev)

    carry = fr.carry_init(cfg, R, W, dev)
    # root frame: R = {v} (rsz=1), Rb covers universe additions only
    carry, push0, frame0 = enter_call(
        carry, cfg, ctx, p0, zeros, xal0, rsz0.to(torch.int32), zeros,
        enable=torch.ones(R, dtype=torch.bool, device=dev))
    # depth never exceeds U (every push consumes a P vertex)
    stack = FrameStack.alloc(R, U + 2, W, ctx.xc_words, dev)
    stack.push(ctx.ar, torch.zeros(R, dtype=torch.long, device=dev), frame0)
    depth = torch.where(push0, 0, -1)
    iters = torch.zeros(R, dtype=torch.int32, device=dev)

    steps = 0
    while R:
        live = (depth >= 0) & (iters < cfg.max_iters)
        if steps % LIVE_CHECK_EVERY == 0 and not bool(live.any()):
            break
        depth, stack, carry = dfs_step(cfg, ctx, depth, stack, carry, live)
        iters = iters + live.to(torch.int32)
        steps += 1
    out = dict(carry, iters=iters, truncated=(depth >= 0).to(torch.int32),
               steps=steps)
    if cfg.out_cap:
        out["out_rows"] = out["out_rows"][:, :cfg.out_cap]
        out["out_sizes"] = out["out_sizes"][:, :cfg.out_cap]
    return out


def run_root(a, p0, x_rows, x_alive0, rsz0, cfg: EngineConfig):
    """Run the full BK subtree of one root: `run_bucket` on a batch of
    one, with the root axis dropped from every output."""
    out = run_bucket(a[None], p0[None], x_rows[None], x_alive0[None],
                     torch.as_tensor(rsz0).reshape(1), cfg)
    steps = out.pop("steps")
    return dict({k: v[0] for k, v in out.items()}, steps=steps)


def bucket_tensors(a, p0, x_rows, x_alive0, rsz0, device):
    """Upload one packed bucket (uint32 numpy words) as the engine's
    tensors: words viewed bit for bit as int32."""
    def words(x):
        return torch.from_numpy(
            np.ascontiguousarray(x, dtype=np.uint32).view(np.int32)).to(device)
    return (words(a), words(p0), words(x_rows),
            torch.from_numpy(np.asarray(x_alive0, dtype=bool)).to(device),
            torch.from_numpy(np.asarray(rsz0, dtype=np.int32)).to(device))


# ===========================================================================
# Persistent bucket engine: lane-refill work queue + lane work stealing
# (DESIGN.md §2.6)
# ===========================================================================

@dataclasses.dataclass
class LaneState:
    """One same-shape span's lanes, carried across the slabs of a span.

    `it` (loop trips) and `cp` (queue claim counter) are host ints: the
    loop's control flow reads them every trip. The other scalars are
    device counters read once at the end."""
    it: int
    cp: int
    ls: torch.Tensor         # Σ useful lane steps
    st: torch.Tensor         # steal count
    et: torch.Tensor         # roots done inside their entry call
    ws: torch.Tensor         # window spills
    wh: torch.Tensor         # window hits
    depth: torch.Tensor      # (L,) per-lane DFS depth, -1 = idle
    al: torch.Tensor         # (L, U, W) per-lane adjacency context
    xrl: torch.Tensor        # (L, XC, W) per-lane X0 rows
    stack: FrameStack        # (L, D, ...)
    carry: dict              # per-lane counters (+ enumeration buffers)


def _persistent_state0(cfg: EngineConfig, lanes: int, U: int, words: int,
                       XC: int, device) -> LaneState:
    """Fresh lane state for one same-shape span of the root stream."""
    # depth never exceeds U (= D − 2), and the windowed segment slices
    # WINDOW_FRAMES + 1 consecutive slots per lane (T resident frames plus
    # one spill slot), so the stack always has slice room
    D = max(U + 2, bitops.WINDOW_FRAMES + 1)
    xc_words = max(-(-XC // WORD), 1)

    def z():
        return torch.zeros((), dtype=torch.int64, device=device)
    return LaneState(
        it=0, cp=0, ls=z(), st=z(), et=z(), ws=z(), wh=z(),
        depth=torch.full((lanes,), -1, dtype=torch.int64, device=device),
        al=torch.zeros((lanes, U, words), dtype=torch.int32, device=device),
        xrl=torch.zeros((lanes, XC, words), dtype=torch.int32,
                        device=device),
        stack=FrameStack.alloc(lanes, D, words, xc_words, device),
        carry=fr.carry_init(cfg, lanes, words, device,
                            track_root=bool(cfg.out_cap)))


def _bcast(mask, t):
    """(L,) mask shaped to broadcast against an (L, ...) tensor."""
    return mask.view((-1,) + (1,) * (t.dim() - 1))


def _any_idle_and_live(depth):
    """(any lane idle, any lane live) in one device read."""
    idle, live = torch.stack([(depth < 0).any(), (depth >= 0).any()]).tolist()
    return idle, live



def _persistent_segment(a, p0, x_rows, x_alive0, rsz0, root_base: int,
                        state: LaneState, cfg: EngineConfig, lanes: int,
                        drain: bool) -> LaneState:
    """One loop draining one root slab into a lane state (in place).

    `drain=True` runs until every lane's subtree exhausts (the classic
    per-bucket persistent loop). `drain=False` returns as soon as the
    queue is claimed out (`cp >= R`) with lanes still live — the stream
    caller (`run_stream_persistent`) then re-enters with the NEXT slab and
    the same lane state, so live lanes never drain at a bucket boundary.
    `root_base` offsets `cur_root` so enumerated cliques decode against
    the stream-global root index.

    Each trip: REFILL (idle lanes claim the next queue roots), STEAL once
    the queue is out (an idle lane adopts half of a live lane's shallowest
    splittable branch set), then one masked `dfs_step` of every lane —
    or, with `cfg.window_steps > 0`, up to K steps per lane over a stack
    window (`window_phase`). All of it is pure scheduling: counters and
    enumerated sets equal the per-root engine's."""
    R, U, words = a.shape
    XC = x_rows.shape[1]
    L = lanes
    dev = a.device
    xc_words = max(-(-XC // WORD), 1)
    # 'rcd' carries no branch set at rest — nothing to split, never steals
    can_steal = bool(cfg.steal) and cfg.backend in fr.PIVOT_BACKENDS
    if cfg.steal_victim not in ("branchiest", "deepest"):
        raise ValueError(f"unknown steal_victim {cfg.steal_victim!r} "
                         "(expected 'branchiest' or 'deepest')")
    windowed = cfg.window_steps > 0
    # window-eligible configs run the fused lane-batched kernel contract
    # (aliveness as a closed form of Rb — per-frame xal is NOT maintained
    # inside the window); everything else windows the engine's dfs_step
    win_kernel = _window_eligible(cfg)
    D = int(state.stack.P.shape[1])
    if win_kernel:
        T = bitops.WINDOW_FRAMES
        WT = T
    else:
        # engine-path window depth: cfg.window_frames, or the full stack
        # when 0 (the degenerate window: no re-centering, no boundary
        # stops). The +1 is the spill slot; full-depth windows need none
        # (depth <= U = D - 2 < WT - 1, a push can never overflow).
        T = cfg.window_frames if cfg.window_frames > 0 else D
        WT = min(T + 1, D)
    zeros_lw = torch.zeros((L, words), dtype=torch.int32, device=dev)
    slot_ix = torch.arange(D, device=dev).unsqueeze(0)

    def refill(s: LaneState):
        """Claim protocol: exhausted lanes take consecutive queue slots."""
        exh = s.depth < 0
        exh_i = exh.to(torch.int64)
        cand = s.cp + exh_i.cumsum(0) - exh_i   # exclusive cumsum per lane
        claim = exh & (cand < R)
        idx = torch.where(claim, cand, 0)
        a_new, xr_new = a[idx], x_rows[idx]
        carry = s.carry
        if "cur_root" in carry:
            carry["cur_root"] = torch.where(claim, root_base + idx,
                                            carry["cur_root"]).to(torch.int32)
        carry, push, f0 = enter_call(
            carry, cfg, fr.make_context(a_new, xr_new), p0[idx],
            zeros_lw,
            fr.mask_to_bitset(x_alive0[idx], xc_words),
            rsz0[idx].to(torch.int32), zeros_lw, enable=claim)
        # merge the fresh root frame into stack slot 0 where claimed
        for buf, new in zip(s.stack, f0):
            buf[:, 0] = torch.where(_bcast(claim, new), new, buf[:, 0])
        s.depth = torch.where(claim, torch.where(push, 0, -1), s.depth)
        s.al = torch.where(_bcast(claim, a_new), a_new, s.al)
        s.xrl = torch.where(_bcast(claim, xr_new), xr_new, s.xrl)
        s.cp += int(claim.sum())
        # a claimed root that finished inside its entry call (no push) did
        # its whole subtree's work this trip — count it as a useful trip
        done_entry = (claim & (s.depth < 0)).sum()
        s.ls += done_entry
        s.et += done_entry

    def pick_victim(depth, bcnt, live_slot):
        """(do-able, victim lane, donation slot) of a steal: the victim's
        donation slot is its SHALLOWEST live frame with >= 2 branches;
        'branchiest' scores victims by that slot's branch count,
        'deepest' by depth. Ties go to the lowest lane, as jnp.argmax."""
        splittable = (depth >= 0) & live_slot.any(1)
        slot_l = live_slot.to(torch.int32).argmax(1)
        donor = bcnt.gather(1, slot_l.unsqueeze(1)).squeeze(1)
        score = depth if cfg.steal_victim == "deepest" else donor
        victim = torch.where(splittable, score, -1).argmax()
        return splittable.any(), victim, slot_l[victim]

    def steal(s: LaneState):
        """STEAL transition (DESIGN.md §2.6): an idle lane adopts half of
        a live lane's shallowest splittable branch set. The victim keeps
        the LOW half of B; the thief's slot-0 frame is the state the
        victim's frame would reach after branching on every kept bit:
        P \\ keep, Xp ∪ keep, B = donated half. Every branch vertex still
        receives exactly one enter_call with an identical (P, Xp, xal)
        state, so counters and the enumerated set are unchanged. The
        thief also adopts the victim's root context and `cur_root`."""
        stack = s.stack
        idle = s.depth < 0
        bcnt = fr.popcount(stack.B)                         # (L, D)
        live_slot = (slot_ix <= s.depth.unsqueeze(1)) & (bcnt >= 2)
        any_split, victim, slot = pick_victim(s.depth, bcnt, live_slot)
        do = idle.any() & any_split
        thief = idle.to(torch.int32).argmax()
        P0, B0 = stack.P[victim, slot], stack.B[victim, slot]
        Xp0, Rb0 = stack.Xp[victim, slot], stack.Rb[victim, slot]
        rs0 = stack.rsz[victim, slot]
        if win_kernel:
            # kernel windows never write per-frame xal (aliveness is the
            # closed form of Rb), so slots above 0 are stale; rebuild the
            # donated frame's alive set from slot 0 — alive0' ∧ (Rb ⊆
            # N(x)) — idempotent at slot 0, exact above it (every window
            # frame's Rb extends slot 0's)
            alive_root = fr.bitset_to_mask(stack.xal[victim, 0], XC)
            alive_d = alive_root & (bitops.and_popcount_rows(
                s.xrl[victim], Rb0) == fr.popcount(Rb0))
            xa0 = fr.mask_to_bitset(alive_d, xc_words)
        else:
            xa0 = stack.xal[victim, slot]
        # split B at bit rank ceil(|B|/2): keep = lowest-ranked half
        in_b = fr.bitset_to_mask(B0, U)
        ib = in_b.to(torch.int32)
        rank = ib.cumsum(0) - ib
        keep = fr.mask_to_bitset(
            in_b & (rank < (bcnt[victim, slot] + 1) // 2), words)
        donate = B0 & ~keep

        def put(buf, lane, d, val):
            buf[lane, d] = torch.where(do, val, buf[lane, d])

        put(stack.B, victim, slot, keep)
        put(stack.P, thief, 0, P0 & ~keep)
        put(stack.B, thief, 0, donate)
        put(stack.Xp, thief, 0, Xp0 | keep)
        put(stack.Rb, thief, 0, Rb0)
        put(stack.rsz, thief, 0, rs0)
        put(stack.xal, thief, 0, xa0)
        s.depth[thief] = torch.where(do, 0, s.depth[thief])
        s.al[thief] = torch.where(do, s.al[victim], s.al[thief])
        s.xrl[thief] = torch.where(do, s.xrl[victim], s.xrl[thief])
        if "cur_root" in s.carry:
            cr = s.carry["cur_root"]
            cr[thief] = torch.where(do, cr[victim], cr[thief])
        s.st += do

    def window_phase(s: LaneState):
        """One trip's K-step window walk (WINDOW, DESIGN.md §2.6).

        Slices a WT-slot window per lane centered on its depth, steps it
        up to K times, writes it back, and tallies per-lane steps done.
        Dead lanes (depth < 0) pass through untouched.

        STAGED REFILL (engine-step path, counting mode): the trip boundary
        pre-claims the next pool of queue roots — gathers their contexts
        and runs their entry calls once, batched — and a lane whose
        SUBTREE exhausts mid-trip (wdep < 0 at window base 0, not a mere
        underflow of a higher-based window) swaps a staged root in instead
        of idling until the boundary. Staged roots are consumed in death
        order, so `cp + used` remains the boundary refill's prefix cursor;
        their entry-call counter deltas are added once, at consumption.
        Enumerating configs skip staging (reports must land in the lane's
        buffer at the step that finds them).

        The walk ends the trip early when a QUORUM of lanes (1/8th, at
        least one) is exhausted beyond what the staged pool can revive
        while a refill or steal could re-arm them. Pure scheduling either
        way — counters and sets unchanged."""
        K = cfg.window_steps
        live_in = s.depth >= 0
        full_win = not win_kernel and WT == D   # degenerate: whole stack
        used = 0
        nterm = stolen = torch.zeros((), dtype=torch.int64, device=dev)
        base = (s.depth - T // 2).clamp(0, D - WT)
        wstack = s.stack if full_win else s.stack.window(base, WT)
        wd = torch.where(live_in, s.depth - base, -1)
        if win_kernel:
            # lane-batched fused window: per-frame xal is a closed form of
            # Rb inside the window, seeded from each lane's slot-0 alive
            # set (valid for every window frame — their Rb all extend
            # slot 0's)
            alive0 = fr.bitset_to_mask(s.stack.xal[:, 0], XC)
            *win, ctl = bitops.dfs_step_window_lanes(
                s.al, s.xrl, alive0.to(torch.int32), wstack.P, wstack.B,
                wstack.Xp, wstack.Rb, wstack.rsz, wd.to(torch.int32),
                steps=K)
            wstack = wstack._replace(**dict(zip(("P", "B", "Xp", "Rb",
                                                 "rsz"), win)))
            nd = ctl[:, 0]
            for i, k in enumerate(("calls", "branches", "sum_px",
                                   "cliques"), 1):
                s.carry[k] = s.carry[k] + ctl[:, i]
            sdone = ctl[:, 5]
        else:
            nd, wstack, s.carry, sdone, used, nterm, stolen = \
                engine_step_window(s, K, s.cp, base, full_win, live_in,
                                   wstack, wd, s.carry)
        if not full_win:
            s.stack.put_window(base, wstack)
        # nd >= 0 also covers lanes REVIVED mid-trip by staged refill
        # (dead at entry, live at exit); their base is 0 by definition
        s.depth = torch.where(live_in | (nd >= 0), base + nd, s.depth)
        # a lane that ran all K steps stayed window-resident the whole
        # trip (hit); one that stopped early paid a window boundary —
        # overflow, underflow, or subtree exhaustion (spill)
        fin = sdone >= K
        s.cp += used               # staged claims advance the cursor
        s.ls += sdone.sum() + nterm
        s.et += nterm              # staged roots done inside entry
        s.st += stolen             # in-trip multi-way steal pieces
        s.ws += (live_in & ~fin).sum()
        s.wh += (live_in & fin).sum()

    def engine_step_window(s, K, cp, base, full_win, live_in, wstk, wdep,
                           carry):
        """The engine-step window: the full dfs_step contract (dynamic
        reduction, enumeration carry) over a WT-slot window whose top
        slot is spill-only — a push landing there parks the lane until
        the next trip re-centers its window."""
        al, xrl = s.al, s.xrl
        sd = torch.zeros_like(wdep)
        stage = cfg.out_cap == 0 and R > 0
        S = max(2, L // 4)
        quorum = max(1, L // 8)
        base0 = base == 0

        def one_step(wdep, wstk, carry, sd, al, xrl):
            lv = (wdep >= 0) & (wdep < WT - 1)
            if not full_win:
                # dfs_step's "dead-lane writes are harmless" invariant
                # assumes slots above the lane's depth are dead — false
                # for a lane PARKED at the spill slot (wdep == WT−1), whose
                # masked child push at WT−1 clobbers its live top frame.
                # That is the only live-slot write a masked step makes, so
                # restoring the top slot for parked lanes suffices.
                parked = wdep >= WT - 1
                top = [buf[:, WT - 1].clone() for buf in wstk]
            ndep, wstk, carry = dfs_step(
                cfg, fr.make_context(al, xrl),
                wdep.clamp(0, WT - 2), wstk, carry, live=lv)
            if not full_win:
                for buf, old in zip(wstk, top):
                    buf[:, WT - 1] = torch.where(_bcast(parked, old), old,
                                                 buf[:, WT - 1])
            return (torch.where(lv, ndep, wdep), wstk, carry,
                    sd + lv.to(sd.dtype))

        def counts(*preds):
            return torch.stack([p.sum() for p in preds]).tolist()

        if not stage:
            k = 0
            while k < K:
                # idle-but-revivable: exhausted during this trip (window
                # at base 0 — a higher-based underflow is a re-center, not
                # an exhaustion) or dead at entry
                idle = ~live_in | ((wdep < 0) & base0)
                n_idle, n_alive = counts(idle,
                                         (wdep >= 0) & (wdep < WT - 1))
                exit_refill = cp < R and n_idle >= quorum
                exit_steal = can_steal and cp >= R and n_idle >= quorum
                if not n_alive or (k >= 1 and (exit_refill or exit_steal)):
                    break
                wdep, wstk, carry, sd = one_step(wdep, wstk, carry, sd, al,
                                                 xrl)
                k += 1
            s.al, s.xrl = al, xrl
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            return wdep, wstk, carry, sd, 0, zero, zero

        # stage the next S queue roots: gather + batched entry calls,
        # skipped once the queue is out. Entry effects land in per-root
        # counter DELTAS, applied once when a lane consumes the root.
        n_stage = min(S, R - cp) if cp < R else 0
        if n_stage:
            s_idx = cp + torch.arange(S, device=dev)
            s_ok = s_idx < R
            s_cl = s_idx.clamp(max=R - 1)
            sa, sxr = a[s_cl], x_rows[s_cl]
            zeros_sw = torch.zeros((S, words), dtype=torch.int32,
                                   device=dev)
            c1, spush, sf0 = enter_call(
                fr.carry_init(cfg, S, words, dev), cfg,
                fr.make_context(sa, sxr), p0[s_cl], zeros_sw,
                fr.mask_to_bitset(x_alive0[s_cl], xc_words),
                rsz0[s_cl].to(torch.int32), zeros_sw, enable=s_ok)
            sdel = torch.stack([c1["calls"], c1["branches"], c1["sum_px"],
                                c1["cliques"]], -1)
        # in-trip steal needs the victim's donation slot INSIDE its
        # window — guaranteed only by the full-depth window (base is
        # identically 0); bounded windows keep boundary steals instead
        trip_steal = can_steal and full_win
        squorum = max(1, L // 16)
        used = 0
        ntm = torch.zeros((), dtype=torch.int64, device=dev)
        stl = torch.zeros((), dtype=torch.int64, device=dev)

        def consume(wdep, wstk, carry, al, xrl, used, ntm):
            """Swap staged roots into dead lanes, in death order."""
            dead = (wdep < 0) & base0
            di = dead.to(torch.int64)
            idx = used + di.cumsum(0) - di
            idxc = idx.clamp(max=S - 1)
            tk = dead & (idx < n_stage)
            # dead lanes sit at base 0: window slot 0 IS stack slot 0, the
            # same slot the boundary refill writes
            for buf, new in zip(wstk, sf0):
                n = new[idxc]
                buf[:, 0] = torch.where(_bcast(tk, n), n, buf[:, 0])
            push = spush[idxc]
            wdep = torch.where(tk & push, 0, wdep)
            al = torch.where(_bcast(tk, al), sa[idxc], al)
            xrl = torch.where(_bcast(tk, xrl), sxr[idxc], xrl)
            dl = sdel[idxc] * tk.to(torch.int32).unsqueeze(1)
            for i, k in enumerate(("calls", "branches", "sum_px",
                                   "cliques")):
                carry[k] = carry[k] + dl[:, i]
            used += int(tk.sum())
            ntm = ntm + (tk & ~push).sum()
            return wdep, wstk, carry, al, xrl, used, ntm

        def steal_multi(wdep, wstk, al, xrl, stl):
            """Multi-way in-trip STEAL: rank-partition the victim's
            donation slot across ALL idle lanes in one shot. Piece t takes
            the branch bits ranked [t·q, (t+1)·q) with P \\ {lower ranks}
            and Xp ∪ {lower ranks} — the state the victim's own walk would
            reach before branching on that piece's first bit, so every
            branch vertex still receives one enter_call with an identical
            frame. Counters and enumerated sets are unchanged."""
            idle = wdep < 0          # base == 0: true exhaustion
            bcnt = fr.popcount(wstk.B)                       # (L, D)
            live_slot = (slot_ix <= wdep.unsqueeze(1)) & (bcnt >= 2)
            any_split, victim, slot = pick_victim(wdep, bcnt, live_slot)
            do = idle.any() & any_split
            nb = bcnt[victim, slot]
            B0, P0 = wstk.B[victim, slot], wstk.P[victim, slot]
            Xp0, Rb0 = wstk.Xp[victim, slot], wstk.Rb[victim, slot]
            rs0, xa0 = wstk.rsz[victim, slot], wstk.xal[victim, slot]
            in_b = fr.bitset_to_mask(B0, U)
            ib = in_b.to(torch.int32)
            rank = (ib.cumsum(0) - ib).unsqueeze(0)
            n_idle = idle.sum()
            q = -torch.div(-nb, (n_idle + 1).clamp(min=1),
                           rounding_mode="floor")          # ceil
            # thief t ∈ 1..n_idle takes ranks [t·q, (t+1)·q)
            ii = idle.to(torch.int64)
            lo = (ii.cumsum(0) * ii * q).unsqueeze(1)      # 0 for live
            tk = do & idle & (lo.squeeze(1) < nb)
            low_b = fr.mask_to_bitset(in_b & (rank < lo), words)
            pc_b = fr.mask_to_bitset(in_b & (rank >= lo) & (rank < lo + q),
                                     words)
            for buf, new in ((wstk.P, P0 & ~low_b), (wstk.B, pc_b),
                             (wstk.Xp, Xp0 | low_b),
                             (wstk.Rb, Rb0.expand(L, -1)),
                             (wstk.rsz, rs0.expand(L)),
                             (wstk.xal, xa0.expand(L, -1))):
                buf[:, 0] = torch.where(_bcast(tk, new), new, buf[:, 0])
            # the victim keeps piece 0 (ranks < q)
            keep = fr.mask_to_bitset(in_b & (rank[0] < q), words)
            wstk.B[victim, slot] = torch.where(do, keep,
                                               wstk.B[victim, slot])
            wdep = torch.where(tk, 0, wdep)
            al = torch.where(_bcast(tk, al), al[victim], al)
            xrl = torch.where(_bcast(tk, xrl), xrl[victim], xrl)
            return wdep, wstk, al, xrl, stl + tk.sum()

        k = 0
        while k < K:
            dead = (wdep < 0) & base0
            n_dead, n_alive = counts(dead, (wdep >= 0) & (wdep < WT - 1))
            pool_left = n_stage - used
            exit_refill = cp + used < R and n_dead - pool_left >= quorum
            # with in-trip stealing the trip never yields for a steal —
            # the split happens inside
            exit_steal = (can_steal and not trip_steal and cp + used >= R
                          and n_dead >= quorum)
            if not (n_alive or (n_dead and used < n_stage)):
                break
            if k >= 1 and (exit_refill or exit_steal):
                break
            if n_dead and used < n_stage:
                wdep, wstk, carry, al, xrl, used, ntm = consume(
                    wdep, wstk, carry, al, xrl, used, ntm)
            if trip_steal and cp + used >= R:
                n_dead2, n_live = counts(wdep < 0, wdep >= 0)
                if n_dead2 >= squorum and n_live:
                    wdep, wstk, al, xrl, stl = steal_multi(wdep, wstk, al,
                                                           xrl, stl)
            wdep, wstk, carry, sd = one_step(wdep, wstk, carry, sd, al, xrl)
            k += 1
        s.al, s.xrl = al, xrl
        return wdep, wstk, carry, sd, used, ntm, stl

    s = state
    # boundary steals per trip: in-trip stealing (staged, full-depth
    # windows) needs the boundary steal only as a safety net; other
    # windowed trips yield once a quorum of lanes idles, so the boundary
    # re-arms up to a quorum of lanes (each repeat picks a fresh thief,
    # and a fresh victim once the last donor's halved slot stops being the
    # branchiest)
    in_trip = (windowed and not win_kernel and WT == D and cfg.out_cap == 0
               and R > 0)
    n_st = 1 if in_trip else (max(1, L // 8) if windowed else 1)
    while s.it < cfg.max_iters:
        idle, live = _any_idle_and_live(s.depth)
        if not (s.cp < R or (drain and live)):
            break
        if s.cp < R and idle:
            refill(s)
            if s.cp >= R and can_steal:
                idle, live = _any_idle_and_live(s.depth)
        if can_steal and s.cp >= R:
            for i in range(n_st):
                if i:
                    idle, live = _any_idle_and_live(s.depth)
                if not (idle and live):
                    break
                # only once the queue can no longer feed the idle lane —
                # while roots remain, claiming beats splitting
                steal(s)
        if windowed:
            window_phase(s)
        else:
            live_mask = s.depth >= 0
            s.ls += live_mask.sum()
            s.depth, s.stack, s.carry = dfs_step(
                cfg, fr.make_context(s.al, s.xrl), s.depth,
                s.stack, s.carry, live=live_mask)
        s.it += 1
    return s


def _persistent_out(s: LaneState, R: int, cfg: EngineConfig) -> dict:
    """Realize a lane state into the public output dict: the per-lane
    carry plus the span's scalars."""
    out = dict(s.carry)
    if cfg.out_cap:
        for k in ("out_rows", "out_sizes", "out_root"):
            out[k] = out[k][:, :cfg.out_cap]
    out.update(iters=s.it, live_iters=s.ls, claimed=s.cp, steals=s.st,
               entry_terms=s.et, window_spills=s.ws, window_hits=s.wh,
               truncated=(s.cp < R) | bool((s.depth >= 0).any()))
    return out


def run_bucket_persistent(a, p0, x_rows, x_alive0, rsz0, cfg: EngineConfig,
                          lanes: int = 64) -> dict:
    """Run a bucket on LANES DFS states fed by a device-resident root work
    queue.

    The per-root `run_bucket` steps lock-step: every root spins (masked)
    until the slowest root in the bucket finishes. Here a lane whose
    subtree exhausts (`depth < 0`) claims the next unstarted root —
    shared claim counter + per-lane exclusive-cumsum offsets — and
    reinitializes its stack in place, so lanes stay busy until the queue
    drains; then the STEAL transition splits live lanes' branch sets
    across idle ones. Roots are consumed in array order.

    Returns the per-lane carry dict plus: `iters` (loop trips),
    `live_iters` (Σ useful lane steps: live lanes per trip, plus claims
    whose root completed inside its entry call), `claimed`, `steals`,
    `entry_terms`, `window_spills`/`window_hits` (windowed lane-trips that
    stopped early at a window boundary vs ran all K steps resident; both
    0 without windows) and `truncated` (True iff cfg.max_iters was hit
    with work remaining). With `cfg.window_steps > 0`, `live_iters`
    counts executed frame-steps (each trip offers up to K per lane)."""
    R, U, words = a.shape
    state = _persistent_state0(cfg, lanes, U, words, x_rows.shape[1],
                               a.device)
    state = _persistent_segment(a, p0, x_rows, x_alive0, rsz0, 0, state,
                                cfg=cfg, lanes=lanes, drain=True)
    return _persistent_out(state, R, cfg)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_stream_persistent(slabs, cfg: EngineConfig, lanes: int = 64):
    """Bucket-spanning persistent engine over a stream of root slabs.

    `slabs` is an iterable of `(a, p0, x_rows, x_alive0, rsz0)` tensor
    tuples in the caller's root order. Consecutive slabs sharing a shape
    signature `(U, words, XC)` form a SPAN: the lane state (stacks,
    contexts, counters) carries across their boundary, so lanes that are
    mid-subtree when slab k's queue is claimed out keep running while slab
    k+1's queue feeds the refills. Each non-final slab runs a
    `drain=False` segment; the span's last slab re-enters with
    `drain=True`. A shape change flushes the span.

    `cur_root` is offset by the stream-global root base, so `out_root`
    decodes against the whole stream. Returns `(outs, spans)`: `outs[i]`
    is the i-th span's output dict (as `run_bucket_persistent`'s, plus
    `seconds`, the span's wall time to a device sync) and `spans[i] =
    (lo, hi)` its slab index range."""
    outs, spans = [], []
    state = None
    sig = None
    prev = None          # last slab fed to the open span (drain target)
    lanes_g = lanes
    root_base = 0
    lo = 0
    n = 0
    t0 = 0.0

    def flush(hi):
        nonlocal state
        st = _persistent_segment(*prev, root_base - prev[0].shape[0], state,
                                 cfg=cfg, lanes=lanes_g, drain=True)
        out = _persistent_out(st, prev[0].shape[0], cfg)
        _sync(prev[0].device)
        out["seconds"] = time.perf_counter() - t0
        outs.append(out)
        spans.append((lo, hi))
        state = None

    for k, slab in enumerate(slabs):
        n = k + 1
        a = slab[0]
        s = (a.shape[1], a.shape[2], slab[2].shape[1])
        if state is not None and s != sig:
            # shape change: drain the open span and flush its output
            flush(k)
        if state is None:
            sig = s
            lo = k
            t0 = time.perf_counter()
            lanes_g = max(1, min(lanes, a.shape[0]))
            state = _persistent_state0(cfg, lanes_g, *s, a.device)
        else:
            # re-arm the claim counter for the new slab; everything else
            # (lane depths, stacks, contexts, counters) carries over
            state.cp = 0
        state = _persistent_segment(*slab, root_base, state, cfg=cfg,
                                    lanes=lanes_g, drain=False)
        prev = slab
        root_base += a.shape[0]
    if state is not None:
        flush(n)
    return outs, spans


# ===========================================================================
# Engine choice
# ===========================================================================

def root_cost_skew(costs) -> float:
    """max/mean skew of a per-root cost proxy, hardened for edge buckets.

    Degenerate inputs (empty, all-zero/all-pad, NaN/inf costs) answer 1.0
    — "uniform", which routes to perroot downstream — instead of crashing
    on a length-0 max or exploding to max/1e-12 on an all-but-zero mean.
    The skew is clamped to n_roots: max/mean ≤ n holds for any nonnegative
    vector, so anything larger is float noise from a near-zero mean."""
    costs = np.asarray(costs, dtype=np.float64)
    n = int(costs.size)
    if n == 0:
        return 1.0
    m = float(costs.max())
    mean = float(costs.mean())
    if not np.isfinite(m) or m <= 0.0 or mean <= 0.0:
        return 1.0
    return min(m / mean, float(n))


def choose_engine(costs: Optional[np.ndarray] = None, *, lanes: int = 64,
                  skew: Optional[float] = None,
                  n_roots: Optional[int] = None,
                  skew_threshold: float = 4.0, min_roots: int = 16,
                  steal: bool = False):
    """Pick (engine, lanes) for one bucket from its root-cost skew.

    skew = max/mean of the per-root cost proxy (`prepare.estimate_costs`).
    A uniform bucket (skew < threshold) runs the lock-step per-root
    engine: every root finishes together, so a work queue would add claim
    overhead and win nothing. A skewed bucket runs the persistent
    lane-refill queue — exactly the regime where lock-step roots idle
    behind one hub root. Lanes are sized so the queue actually refills
    (>= ~4 roots per lane on average), clamped to [8, lanes]; tiny
    buckets (< min_roots) stay per-root.

    `steal=True` declares that the config the bucket will run with can
    steal (cfg.steal on AND a pivot-family backend): stealing splits a hub
    root's subtree across lanes once the queue drains, so the effective
    skew threshold halves. Pass `skew=`/`n_roots=` instead of `costs`
    when the skew is already known."""
    if costs is not None:
        costs = np.asarray(costs, dtype=np.float64)
        n_roots = int(costs.size)
        skew = root_cost_skew(costs)   # 1.0 on empty/all-pad/degenerate
    if skew is None or n_roots is None or not np.isfinite(skew):
        return "perroot", lanes
    skew = min(skew, float(max(n_roots, 1)))
    thr = skew_threshold / 2.0 if steal else skew_threshold
    if n_roots < min_roots or skew < thr:
        return "perroot", lanes
    per_lane = max(1, n_roots // 4)
    refill_lanes = 1 << (per_lane.bit_length() - 1)   # largest pow2 <= n/4
    return "persistent", max(8, min(lanes, refill_lanes))


# ===========================================================================
# Single-host API
# ===========================================================================

@dataclasses.dataclass
class MCEResult:
    cliques: int
    calls: int
    branches: int
    sum_px: int
    pre_reported: int
    enumerated: Optional[List[frozenset]] = None
    overflow: bool = False
    iters_exhausted: bool = False
    # per-run timings and shapes: prep_seconds, per bucket its shape,
    # roots, engine, steps and seconds, and the persistent lanes'
    # scheduling stats (see run())
    stats: Optional[dict] = None


def resolve_device(device=None) -> torch.device:
    """`device`, or "cuda" when None — which must then exist: nothing in
    the port falls back to the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the engine on the host")
    return dev


def _decode(total: MCEResult, out: dict, bucket_of) -> None:
    """Append a persistent run's enumerated cliques: each lane's rows with
    the queue slot that found them (`out_root`), mapped back through
    `bucket_of(slot) -> (bucket, local root)` to global vertex ids."""
    rows = out["out_rows"].view(np.uint32)
    for l in range(out["out_n"].shape[0]):
        for k in range(int(out["out_n"][l])):
            bucket, r = bucket_of(int(out["out_root"][l, k]))
            base = [int(b) for b in bucket.bases[r]]
            uni = bucket.universes[r]
            total.enumerated.append(frozenset(
                base + [int(uni[m]) for m in _unpack_bits_np(rows[l, k])]))


def _host(out: dict) -> dict:
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def run(g: CSRGraph, *, global_red: bool = True, dynamic_red: bool = True,
        x_red: bool = True, backend: str = "pivot",
        enumerate_cliques: bool = False, out_cap: int = 4096,
        bucket_sizes: Sequence[int] = (32, 64, 128, 256, 512, 1024),
        max_x_rows: int = 8192,
        split_threshold: Optional[int] = None,
        engine: str = "perroot", lanes: int = 64,
        steal: bool = True, steal_victim: str = "branchiest",
        window_steps: int = 0, window_frames: int = 0,
        device=None) -> MCEResult:
    """End-to-end single-host MCE: prepare on host, run buckets on device.

    `engine='persistent'` streams every bucket through the lane-refill work
    queue (`run_stream_persistent` with min(lanes, roots) lanes; same-shape
    buckets share one lane state); the default 'perroot' path steps every
    root of a bucket in lock step. `engine='auto'` picks per bucket from
    the root-cost skew (`choose_engine`). `window_steps > 0` walks up to K
    frame-steps per trip over stack windows.

    `backend` is any of `BACKENDS` ('pivot', 'rcd', 'revised',
    'hybrid'), on every engine. `device=None` runs on "cuda" and raises
    when there is none.

    `stats` holds `prep_seconds` and one entry per bucket (shape, roots,
    engine; per-root and auto runs also its steps and seconds); a
    persistent run adds the lanes' scheduling stats (`iters`,
    `live_iters`, `lane_iters`, `steals`, `entry_terms`, `window_spills`,
    `window_hits`, `spans`) and `span_seconds`."""
    if engine not in ("perroot", "persistent", "auto"):
        raise ValueError(f"unknown engine {engine!r}")
    if backend not in fr.BACKENDS:
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected one of {fr.BACKENDS})")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    prep = prepare(g, global_red=global_red, x_red=x_red,
                   bucket_sizes=bucket_sizes, max_x_rows=max_x_rows,
                   split_threshold=split_threshold, device=dev)
    cfg = EngineConfig(dynamic_red=dynamic_red, backend=backend,
                       out_cap=out_cap if enumerate_cliques else 0,
                       steal=steal, steal_victim=steal_victim,
                       window_steps=window_steps,
                       window_frames=window_frames)
    total = MCEResult(cliques=len(prep.pre_reported), calls=0, branches=0,
                      sum_px=0, pre_reported=len(prep.pre_reported),
                      enumerated=(list(prep.pre_reported)
                                  if enumerate_cliques else None),
                      stats=dict(prep_seconds=time.perf_counter() - t0,
                                 buckets=[]))

    def add(out, n_pad):
        total.cliques += int(out["cliques"].sum())
        # padded no-op roots (compile-count hygiene) are one call each
        total.calls += int(out["calls"].sum()) - n_pad
        total.branches += int(out["branches"].sum())
        total.sum_px += int(out["sum_px"].sum())
        total.iters_exhausted |= bool(np.any(out["truncated"]))
        if enumerate_cliques:
            total.overflow |= bool(out["overflow"].any())

    if engine == "persistent":
        # bucket-spanning path: consecutive same-shape buckets share one
        # lane state (run_stream_persistent) — no drain at their boundary
        slabs = [bucket_tensors(b.a, b.p0, b.x_rows, b.x_alive0, b.rsz0, dev)
                 for b in prep.buckets]
        outs, spans = run_stream_persistent(slabs, cfg, lanes=lanes)
        prefix = np.cumsum([0] + [b.num_roots for b in prep.buckets])
        st = total.stats
        st["buckets"] = [dict(u=b.u_pad, xc=b.x_pad, roots=b.num_roots,
                              engine="persistent") for b in prep.buckets]
        st.update(iters=0, live_iters=0, lane_iters=0, steals=0,
                  entry_terms=0, window_spills=0, window_hits=0,
                  spans=len(spans), span_seconds=[])
        # a windowed trip offers up to K steps per lane, so the occupancy
        # denominator (lane_iters) scales by the window depth
        spt = max(1, window_steps)

        def bucket_of(r):
            bi = int(np.searchsorted(prefix, r, side="right")) - 1
            return prep.buckets[bi], r - int(prefix[bi])

        for out, (lo, hi) in zip(outs, spans):
            out = _host(out)
            for k in ("iters", "live_iters", "steals", "entry_terms",
                      "window_spills", "window_hits"):
                st[k] += int(out[k])
            # carry is per-lane, so its leading dim is this span's lanes
            st["lane_iters"] += int(out["iters"]) * out["calls"].shape[0] \
                * spt
            st["span_seconds"].append(out["seconds"])
            add(out, sum(b.n_pad for b in prep.buckets[lo:hi]))
            if enumerate_cliques:
                # out_root carries the stream-global root index
                _decode(total, out, bucket_of)
        return total

    for bucket in prep.buckets:
        t1 = time.perf_counter()
        args = bucket_tensors(bucket.a, bucket.p0, bucket.x_rows,
                              bucket.x_alive0, bucket.rsz0, dev)
        eng_b, lanes_b = engine, lanes
        if engine == "auto":
            total_real = bucket.num_roots - bucket.n_pad
            eng_b, lanes_b = choose_engine(
                estimate_costs(bucket)[:total_real], lanes=lanes,
                steal=steal and backend in fr.PIVOT_BACKENDS)
        if eng_b == "persistent":
            lanes_b = min(lanes_b, bucket.num_roots)
            out = _host(run_bucket_persistent(*args, cfg, lanes=lanes_b))
            info = dict(lanes=lanes_b, steps=out["iters"],
                        live_iters=int(out["live_iters"]),
                        steals=int(out["steals"]))
        else:
            out = run_bucket(*args, cfg)
            steps = out.pop("steps")
            out = _host(out)
            info = dict(steps=steps, sum_iters=int(out["iters"].sum()),
                        max_iters=int(out["iters"].max(initial=0)))
        total.stats["buckets"].append(dict(
            u=bucket.u_pad, xc=bucket.x_pad, roots=bucket.num_roots,
            engine=eng_b, **info, seconds=time.perf_counter() - t1))
        add(out, bucket.n_pad)
        if enumerate_cliques:
            if eng_b == "persistent":
                # lanes interleave roots; out_root maps each clique back
                _decode(total, out, lambda r: (bucket, r))
            else:
                rows = out["out_rows"].view(np.uint32)
                for r in range(bucket.num_roots):
                    uni = bucket.universes[r]
                    base = [int(b) for b in bucket.bases[r]]
                    for k in range(int(out["out_n"][r])):
                        members = _unpack_bits_np(rows[r, k])
                        total.enumerated.append(frozenset(
                            base + [int(uni[m]) for m in members]))
    return total
