"""The per-root DFS loop + single-host API (DESIGN.md §2.5).

Composes the layers: `prepare` stages host-side buckets, `reductions`
applies the per-call lemmas, `pivot` picks branch sets, and this module
owns call entry, the explicit stack walk over a bucket's root batch, and
the end-to-end `run()`.

The reference vmaps a `lax.while_loop` over the roots of a bucket; here
one Python loop steps every root of the bucket at once, with a per-root
`live = (depth >= 0) & (iters < max_iters)`. A root that is not live runs
the same masked step with every side effect off and its depth unchanged
(the reference's `dfs_step(..., live=)` contract), so every counter
matches the vmapped loop. Whether any root is still live is read on the
host only every `LIVE_CHECK_EVERY` steps: each read is a device sync.
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
from repro_torch.core.engine.prepare import _unpack_bits_np, prepare
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

    # ---- branch set (pivot backends) ----
    B = piv.branch_set(cfg, ctx, P, Xp, xal, rf,
                       deg=None if pre is None else pre[0])
    return carry, push, Frame(P=P, B=B, Xp=Xp, Rb=Rb, rsz=rsz, xal=xal)


# ===========================================================================
# Shared DFS step + per-bucket DFS loop
# ===========================================================================

def dfs_step(cfg, ctx: fr.RootContext, depth, stack, carry, live):
    """One straight-line masked DFS step for every root of the bucket.

    Branch work always executes with its carry side-effects gated by
    `has_branch`, and stack writes land in frames that are DEAD on the pop
    path (slots > new depth), so they need no gating at all.

    `live` (R,) bool: a root that is not live reads/writes its clamped
    slot max(depth, 0), every side-effect is masked off, and its depth
    passes through unchanged. Its slot write stores the frame's own values
    back, and its child push lands above its depth, in a dead slot."""
    ar = ctx.ar
    d = depth.clamp(min=0)
    f = stack.read(ar, d)

    has_branch = fr.any_bit(f.B) & live
    # on an all-zero B, first_bit_index gives 32 (past U when U == 32):
    # jax clamps that gather, torch raises and a kernel would read out of
    # bounds — clamp; every use is masked by has_branch
    w = fr.first_bit_index(f.B).clamp(max=ctx.u - 1)

    # ---- branch path: always computed, side-effects gated ----
    wbit = ctx.eye[w]
    # fused frame step: child sets + child degree sweep + Lemma-7 partner
    # in one kernel pass over A (threaded into enter_call as `pre`)
    childP, childXp, deg, partner = bitops.frame_step(ctx.A, f.P, f.Xp,
                                                      ctx.A[ar, w])
    # X0 rows stay alive iff adjacent to w (bit w of their row)
    row_word = ctx.x_rows[ar, :, w // WORD]                     # (R, XC)
    adj_w = ((row_word >> (w % WORD).to(torch.int32).unsqueeze(-1)) & 1) != 0
    childxal = f.xal & fr.mask_to_bitset(adj_w, ctx.xc_words)
    carry["branches"] = carry["branches"] + has_branch.to(torch.int32)
    carry, push, child = enter_call(carry, cfg, ctx, childP, childXp,
                                    childxal, f.rsz + 1, f.Rb | wbit,
                                    enable=has_branch, pre=(deg, partner))
    # update current frame (dead slot on the pop path — no gating):
    # P \ w, X ∪ w, B \ w
    hb = has_branch.unsqueeze(-1)
    stack.write(ar, d, P=torch.where(hb, f.P & ~wbit, f.P),
                Xp=torch.where(hb, f.Xp | wbit, f.Xp),
                B=torch.where(hb, f.B & ~wbit, f.B))
    # write child frame (slot depth+1 is dead unless pushed)
    nd = d + 1
    stack.push(ar, nd, child)
    new_depth = torch.where(has_branch, torch.where(push, nd, d), d - 1)
    return torch.where(live, new_depth, depth), stack, carry


def run_bucket(a, p0, x_rows, x_alive0, rsz0, cfg: EngineConfig):
    """Run the full BK subtree of every root of a bucket, in lock step.

    a (R, U, W), p0 (R, W), x_rows (R, XC, W) int32 words; x_alive0
    (R, XC) bool; rsz0 (R,) int32 — all on one device. Returns a dict of
    per-root tensors: the counters, the enumeration buffers when
    cfg.out_cap (out_rows (R, out_cap, W), out_sizes, out_n, overflow),
    `iters` (steps the root was live) and `truncated` (1 iff the root hit
    cfg.max_iters with frames still live — its counts are partial), plus
    `steps`, the number of batched steps taken (an int)."""
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
    # per-run timings and shapes: prep_seconds, and per bucket its shape,
    # roots, batched steps, Σ/max root iters and device seconds
    stats: Optional[dict] = None


def resolve_device(device=None) -> torch.device:
    """`device`, or "cuda" when None — which must then exist: nothing in
    the port falls back to the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the engine on the host")
    return dev


def run(g: CSRGraph, *, global_red: bool = True, dynamic_red: bool = True,
        x_red: bool = True, backend: str = "pivot",
        enumerate_cliques: bool = False, out_cap: int = 4096,
        bucket_sizes: Sequence[int] = (32, 64, 128, 256, 512, 1024),
        max_x_rows: int = 8192,
        split_threshold: Optional[int] = None,
        engine: str = "perroot", window_steps: int = 0,
        device=None) -> MCEResult:
    """End-to-end single-host MCE: prepare on host, run buckets on device.

    `device=None` runs on "cuda" and raises when there is none. Only the
    per-root engine is ported: `engine="persistent"|"auto"` and
    `window_steps > 0` wait for ROADMAP Queue 1 item 4, the 'rcd' and
    'hybrid' backends for item 5."""
    if engine in ("persistent", "auto") or window_steps:
        raise NotImplementedError(
            "the persistent/auto engines and stack windows are not ported "
            "yet (ROADMAP Queue 1 item 4)")
    if engine != "perroot":
        raise ValueError(f"unknown engine {engine!r}")
    if backend not in fr.BACKENDS:
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected one of {fr.BACKENDS})")
    if backend not in fr.PORTED_BACKENDS:
        raise NotImplementedError(f"backend {backend!r} is not ported yet "
                                  f"(ROADMAP Queue 1 item 5)")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    prep = prepare(g, global_red=global_red, x_red=x_red,
                   bucket_sizes=bucket_sizes, max_x_rows=max_x_rows,
                   split_threshold=split_threshold, device=dev)
    cfg = EngineConfig(dynamic_red=dynamic_red, backend=backend,
                       out_cap=out_cap if enumerate_cliques else 0)
    total = MCEResult(cliques=len(prep.pre_reported), calls=0, branches=0,
                      sum_px=0, pre_reported=len(prep.pre_reported),
                      enumerated=(list(prep.pre_reported)
                                  if enumerate_cliques else None),
                      stats=dict(prep_seconds=time.perf_counter() - t0,
                                 buckets=[]))
    for bucket in prep.buckets:
        t1 = time.perf_counter()
        out = run_bucket(*bucket_tensors(bucket.a, bucket.p0, bucket.x_rows,
                                         bucket.x_alive0, bucket.rsz0, dev),
                         cfg)
        steps = out.pop("steps")
        out = {k: v.cpu().numpy() for k, v in out.items()}
        total.stats["buckets"].append(dict(
            u=bucket.u_pad, xc=bucket.x_pad, roots=bucket.num_roots,
            steps=steps, sum_iters=int(out["iters"].sum()),
            max_iters=int(out["iters"].max(initial=0)),
            seconds=time.perf_counter() - t1))
        total.cliques += int(out["cliques"].sum())
        # padded no-op roots (compile-count hygiene) are one call each
        total.calls += int(out["calls"].sum()) - bucket.n_pad
        total.branches += int(out["branches"].sum())
        total.sum_px += int(out["sum_px"].sum())
        total.iters_exhausted |= bool(out["truncated"].any())
        if enumerate_cliques:
            total.overflow |= bool(out["overflow"].any())
            rows = out["out_rows"].view(np.uint32)
            for r in range(bucket.num_roots):
                uni = bucket.universes[r]
                base = [int(b) for b in bucket.bases[r]]
                for k in range(int(out["out_n"][r])):
                    members = _unpack_bits_np(rows[r, k])
                    total.enumerated.append(frozenset(
                        base + [int(uni[m]) for m in members]))
    return total
