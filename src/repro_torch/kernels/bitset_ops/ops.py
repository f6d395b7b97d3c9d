"""Dispatching wrapper for bitset set algebra — the engine's ONLY entry point.

Layering contract (DESIGN.md §3, as in the reference package): every module
outside `kernels/bitset_ops` that needs bitset algebra calls this module,
never `ref` or the CUDA library directly, so there is one choke point to
measure, swap and accelerate.

Dispatch is by the device of the tensors handed in, and by nothing else:

* a CPU tensor takes the plain PyTorch version in `ref`;
* a CUDA tensor launches the hand-written Hopper kernel from
  `csrc/bitset_ops.cu` (built on first use by `build.LIBRARY`), or
  raises. No CUDA tensor ever reaches `ref`, and a failed build or launch
  is an error.

Each kernel wrapper adds one to `LAUNCHES[name]` where it launches, and
nowhere else, so a run can show that it went through the kernels. The
engine's entry points on a kernel count under that kernel's name:
`lemma8_reduce` as "and_popcount_rows", `pivot_select` as
"and_popcount_argmax", `hybrid_census` as "clique_counts", `branch_step`
as "frame_step", `rcd_dominated` as "and_popcount_many".

Shapes: rows (..., K, W) int32 bit words, masks (..., W), valid (..., K)
bool, with the same leading root-batch dims; the kernels see them
flattened to (R, K, W). The window walks take per-lane windows
(..., T, W) beside (..., U, W) adjacency and (..., XC, W) X0 rows.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels._build import Launches, on_cpu, raise_on, stream
from repro_torch.kernels.bitset_ops import ref
from repro_torch.kernels.bitset_ops.build import LIBRARY
from repro_torch.kernels.bitset_ops.ref import HYBRID_DENSITY
from repro_torch.kernels.bitset_ops.words import (  # noqa: F401
    and_reduce, and_rows, bits_to_mask, first_bit_index, mask_to_bits,
    or_reduce, popcount, popcount_words)

LAUNCHES = Launches({"frame_step": 0, "and_popcount_rows": 0,
                     "and_popcount_argmax": 0, "clique_counts": 0,
                     "and_popcount_many": 0, "dfs_step_window": 0,
                     "dfs_step_window_lanes": 0})

# Stack frames the engine keeps resident per window walk. The kernel takes
# any T; the engine passes this one, so its window spills and hits are the
# reference's.
WINDOW_FRAMES = 8
# Shared memory one block may use on an H100 (227 KB), and the most a
# lane's window and child sets may take (the window walk refuses more).
WINDOW_BLOCK_SMEM = 232448
WINDOW_SMEM_MAX = WINDOW_BLOCK_SMEM - 1024
# The window walk's launch: a group of 1, 2 or 4 warps walks one lane, and a
# block holds at most WINDOW_BLOCK_THREADS threads.
WINDOW_GROUPS = (1, 2, 4)
WINDOW_BLOCK_THREADS = 256
H100_SMS = 132


class WindowGeometry(NamedTuple):
    """Launch geometry of the window walk (`csrc/bitset_ops.cu`)."""
    group: int             # warps per lane
    lanes_per_block: int
    staged: bool           # the lane's A and X0 rows in shared memory
    index_bits: int        # 2**index_bits > max(U, XC)
    packed: bool           # (score + 1, ~index) fits one 32-bit key


def _align16(n: int) -> int:
    return (n + 15) & ~15


def window_lane_bytes(U: int, XC: int, T: int, W: int, group: int,
                      staged: bool) -> int:
    """Shared memory of one lane: mbarrier, the group's reduction scratch,
    the window, the child sets and, staged, alive0's bits and the rows (the
    layout of `WinLayout` in the CUDA source; the card tests hold the two
    together through the library's `bitset_window_lane_bytes`)."""
    n = (16 + _align16(32 * group) + _align16(4 * (4 * T * W + T))
         + _align16(12 * W))
    if staged:
        n += (_align16(4 * -(-XC // 32)) + _align16(4 * U * W)
              + _align16(4 * XC * W))
    return n


@functools.lru_cache(maxsize=1024)
def window_geometry(L: int, U: int, XC: int, T: int, W: int,
                    sms: int = H100_SMS,
                    group: Optional[int] = None) -> WindowGeometry:
    """The window walk's launch for L lanes of (U, XC, T, W), cached: the
    engine repeats a bucket's shape on every launch.

    G: the most warps a lane that keep the launch within 32 warps an SM
    (64 registers a thread), so that it runs in one wave: 4 on the
    engine's 64 lanes and per root at U = 64 and 128, 2 per root at
    U = 32 (1,663 lanes). More warps shorten each step's row sweep; on
    the scale-12 buckets the chosen G was the fastest of 1, 2 and 4 but
    per root at U = 64, where G = 2 was 1.4 % faster on an H100
    (`chip_smoke.py`'s `group_ms`, PERF.md §6). The rows are staged when
    one lane's fit the block's shared memory; rows that do not are read
    from device memory by one warp a lane (the CUDA source's one unstaged
    instance). Lanes per block fill at most WINDOW_BLOCK_THREADS threads
    and that memory, and stop at one when L is small. Any (U, XC, T, W)
    whose window fits (WINDOW_SMEM_MAX) gets a geometry. `group` fixes G
    of a staged launch instead."""
    if group is None:
        group = max((g for g in WINDOW_GROUPS if g * L <= 32 * sms),
                    default=1)
    staged = window_lane_bytes(U, XC, T, W, group, True) <= WINDOW_BLOCK_SMEM
    if not staged:
        group = 1
        staged = (window_lane_bytes(U, XC, T, W, group, True)
                  <= WINDOW_BLOCK_SMEM)
    lane = window_lane_bytes(U, XC, T, W, group, staged)
    per_block = max(1, min(WINDOW_BLOCK_THREADS // (32 * group), L // sms,
                           WINDOW_BLOCK_SMEM // lane))
    index_bits = max(U, XC).bit_length()
    return WindowGeometry(group, per_block, staged, index_bits,
                          (32 * W + 1).bit_length() + index_bits <= 32)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name: str, rows: torch.Tensor, *vecs: torch.Tensor):
    """Validate a kernel call; returns (lead dims, R, K, W), R = prod(lead)."""
    if rows.dim() < 2:
        raise ValueError(f"{name}: rows must be (..., K, W), got "
                         f"{tuple(rows.shape)}")
    *lead, k, w = rows.shape
    if k == 0 or w == 0:
        raise ValueError(f"{name}: empty rows {tuple(rows.shape)}")
    if rows.dtype != torch.int32 or not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous int32")
    if len({t.device for t in (rows,) + vecs}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    for v in vecs:
        if not v.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    r = 1
    for d in lead:
        r *= d
    return tuple(lead), r, k, w


def _check_mask(name, m, lead, w):
    if m.dtype != torch.int32 or tuple(m.shape) != lead + (w,):
        raise ValueError(f"{name}: mask must be int32 {lead + (w,)}, got "
                         f"{m.dtype} {tuple(m.shape)}")


def _check_frame(name, a, x_rows, xal, *vecs):
    """Validate the engine's operands of one call per root: a (..., U, W),
    x_rows (..., XC, W), xal (..., XCW) bits with 32·XCW >= XC and U <=
    32·W, all int32 and contiguous, and `vecs` (the frame's (..., W)
    masks) beside them. Returns (lead, R, U, W, XC, XCW)."""
    lead, r, u, w = _check(name, a, x_rows, xal, *vecs)
    xc = x_rows.shape[-2] if x_rows.dim() >= 2 else -1
    xcw = xal.shape[-1] if xal.dim() else -1
    if (x_rows.dtype != torch.int32 or tuple(x_rows.shape) != lead + (xc, w)
            or xal.dtype != torch.int32 or tuple(xal.shape) != lead + (xcw,)
            or 32 * xcw < xc or u > 32 * w):
        raise ValueError(f"{name}: x_rows must be int32 {lead + ('XC', w)} "
                         f"and the X0 bits int32 {lead + ('XCW',)} with "
                         f"32*XCW >= XC, U <= 32*W; got "
                         f"{tuple(x_rows.shape)}, {tuple(xal.shape)}")
    for v in vecs:
        _check_mask(name, v, lead, w)
    return lead, r, u, w, xc, xcw


def and_popcount_rows(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """out[..., k] = popcount(rows[..., k, :] & mask[..., :]) as int32."""
    if on_cpu(rows, mask):
        return ref.and_popcount_rows(rows, mask)
    lead, r, k, w = _check("and_popcount_rows", rows, mask)
    _check_mask("and_popcount_rows", mask, lead, w)
    out = torch.empty(lead + (k,), dtype=torch.int32, device=rows.device)
    if r:
        raise_on("and_popcount_rows", LIBRARY.load().bitset_and_popcount_rows(
            rows.data_ptr(), mask.data_ptr(), out.data_ptr(), r, k, w,
            stream()))
        LAUNCHES["and_popcount_rows"] += 1
    return out


def and_popcount_argmax(rows: torch.Tensor, mask: torch.Tensor,
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused pivot-select: (first argmax, max) of popcount(rows & mask) over
    the `valid` rows, both int32 (...,); invalid rows score -1, so an
    all-invalid batch row gives (0, -1)."""
    if valid is None:
        valid = torch.ones(rows.shape[:-1], dtype=torch.bool,
                           device=rows.device)
    if on_cpu(rows, mask, valid):
        return ref.and_popcount_argmax(rows, mask, valid)
    lead, r, k, w = _check("and_popcount_argmax", rows, mask, valid)
    _check_mask("and_popcount_argmax", mask, lead, w)
    if valid.dtype != torch.bool or tuple(valid.shape) != lead + (k,):
        raise ValueError(f"and_popcount_argmax: valid must be bool "
                         f"{lead + (k,)}")
    idx = torch.empty(lead, dtype=torch.int32, device=rows.device)
    best = torch.empty(lead, dtype=torch.int32, device=rows.device)
    if r:
        raise_on("and_popcount_argmax",
                  LIBRARY.load().bitset_and_popcount_argmax(
                      rows.data_ptr(), mask.data_ptr(), valid.data_ptr(),
                      idx.data_ptr(), best.data_ptr(), r, k, w, stream()))
        LAUNCHES["and_popcount_argmax"] += 1
    return idx, best


def frame_step(rows: torch.Tensor, p: torch.Tensor, xp: torch.Tensor,
               wrow: torch.Tensor):
    """Fused BK frame step: (childp, childxp, deg, partner).

    childp = p & wrow, childxp = xp & wrow, deg[k] = popcount(rows[k] &
    childp), partner[k] = the surviving bit index where deg[k] == 1 (the
    Lemma-7 partner; garbage elsewhere). One pass over the (K, W) rows
    replaces the engine's child-AND, degree sweep and partner extraction."""
    if on_cpu(rows, p, xp, wrow):
        return ref.frame_step(rows, p, xp, wrow)
    lead, r, k, w = _check("frame_step", rows, p, xp, wrow)
    for v in (p, xp, wrow):
        _check_mask("frame_step", v, lead, w)
    dev = rows.device
    childp = torch.empty(lead + (w,), dtype=torch.int32, device=dev)
    childxp = torch.empty(lead + (w,), dtype=torch.int32, device=dev)
    deg = torch.empty(lead + (k,), dtype=torch.int32, device=dev)
    partner = torch.empty(lead + (k,), dtype=torch.int32, device=dev)
    if r:
        raise_on("frame_step", LIBRARY.load().bitset_frame_step(
            rows.data_ptr(), p.data_ptr(), xp.data_ptr(), wrow.data_ptr(),
            childp.data_ptr(), childxp.data_ptr(), deg.data_ptr(),
            partner.data_ptr(), r, k, w, stream()))
        LAUNCHES["frame_step"] += 1
    return childp, childxp, deg, partner


def branch_step(a: torch.Tensor, x_rows: torch.Tensor, sP: torch.Tensor,
                sB: torch.Tensor, sXp: torch.Tensor, sRb: torch.Tensor,
                srsz: torch.Tensor, sxal: torch.Tensor, depth: torch.Tensor,
                live: torch.Tensor, w: Optional[torch.Tensor] = None):
    """The branch half of the engine's DFS step in one launch on the DFS
    stack itself: (has_branch, childP, childXp, childxal, childRb,
    child_rsz, deg, partner), new tensors, and the slot of every branching
    root updated in place, as `ref.branch_step` (the contract). a (R, U,
    W), x_rows (R, XC, W), the stack's buffers sP/sB/sXp/sRb (R, D, W),
    srsz (R, D) and sxal (R, D, XCW), all int32 and contiguous; depth (R,)
    int64 below D; live (R,) bool; w (R,) int32 ('rcd') or None (the
    pivot family). Counted in LAUNCHES["frame_step"]: its degree sweep is
    that kernel's."""
    given = () if w is None else (w,)
    if on_cpu(a, x_rows, sP, sB, sXp, sRb, srsz, sxal, depth, live, *given):
        return ref.branch_step(a, x_rows, sP, sB, sXp, sRb, srsz, sxal,
                               depth, live, w)
    lead, r, u, wds = _check("branch_step", a, x_rows, sP, sB, sXp, sRb,
                             srsz, sxal, depth, live, *given)
    xc = x_rows.shape[1] if x_rows.dim() == 3 else -1
    d_slots, xcw = (sxal.shape[1], sxal.shape[2]) if sxal.dim() == 3 \
        else (0, 0)
    want = {"x_rows": (x_rows, torch.int32, (r, xc, wds)),
            "sP": (sP, torch.int32, (r, d_slots, wds)),
            "sB": (sB, torch.int32, (r, d_slots, wds)),
            "sXp": (sXp, torch.int32, (r, d_slots, wds)),
            "sRb": (sRb, torch.int32, (r, d_slots, wds)),
            "srsz": (srsz, torch.int32, (r, d_slots)),
            "sxal": (sxal, torch.int32, (r, d_slots, xcw)),
            "depth": (depth, torch.int64, (r,)),
            "live": (live, torch.bool, (r,))}
    if given:
        want["w"] = (w, torch.int32, (r,))
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"branch_step: {name} must be {dtype} {shape} "
                             f"(a is {tuple(a.shape)}), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if len(lead) != 1 or d_slots < 1 or 32 * xcw < xc or u > 32 * wds:
        raise ValueError(f"branch_step: needs a (R, U, W), a stack of D >= "
                         f"1 slots, 32*XCW >= XC and U <= 32*W; got a "
                         f"{tuple(a.shape)}, sxal {tuple(sxal.shape)}")
    dev = a.device

    def new(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)
    outs = (new(r, dtype=torch.bool), new(r, wds), new(r, wds),
            new(r, xcw), new(r, wds), new(r), new(r, u), new(r, u))
    if r:
        raise_on("branch_step", LIBRARY.load().bitset_branch_step(
            *(t.data_ptr() for t in (a, x_rows, sP, sB, sXp, sRb, srsz,
                                     sxal, depth, live)),
            None if w is None else w.data_ptr(),
            *(t.data_ptr() for t in outs),
            r, u, xc, xcw, wds, d_slots, stream()))
        LAUNCHES["frame_step"] += 1
    return outs


def clique_counts(rows: torch.Tensor, mask: torch.Tensor, in_p: torch.Tensor,
                  in_x: torch.Tensor, *, threads: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused early-termination census of the 'hybrid' backend: (n_full,
    n_dom), both int32 (...,), the in_p rows with popcount(row & mask) ==
    |mask| − 1 and the in_x rows with popcount(row & mask) == |mask|.
    rows (..., K, W), mask (..., W), in_p/in_x (..., K) bool. `threads`
    sets the CUDA block's threads (a multiple of 32 up to 512; 0: the
    library's choice), for measurements."""
    if on_cpu(rows, mask, in_p, in_x):
        return ref.clique_counts(rows, mask, in_p, in_x)
    lead, r, k, w = _check("clique_counts", rows, mask, in_p, in_x)
    _check_mask("clique_counts", mask, lead, w)
    for sel in (in_p, in_x):
        if sel.dtype != torch.bool or tuple(sel.shape) != lead + (k,):
            raise ValueError(f"clique_counts: in_p/in_x must be bool "
                             f"{lead + (k,)}")
    n_full = torch.empty(lead, dtype=torch.int32, device=rows.device)
    n_dom = torch.empty(lead, dtype=torch.int32, device=rows.device)
    if r:
        raise_on("clique_counts", LIBRARY.load().bitset_clique_counts(
            rows.data_ptr(), mask.data_ptr(), in_p.data_ptr(),
            in_x.data_ptr(), n_full.data_ptr(), n_dom.data_ptr(), r, k, w,
            threads, stream()))
        LAUNCHES["clique_counts"] += 1
    return n_full, n_dom


def hybrid_census(a: torch.Tensor, x_rows: torch.Tensor, P: torch.Tensor,
                  Xp: torch.Tensor, x_alive: torch.Tensor, *,
                  threads: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 'hybrid' census on the engine's operands: (n_full, n_dom,
    psize), each int32 (...,), as `clique_counts` over A stacked on the X0
    rows with the selectors derived from P, Xp and x_alive, and psize =
    |P|'s bits below U (`ref.hybrid_census` is the composition). a (...,
    U, W), x_rows (..., XC, W), P/Xp (..., W), x_alive (..., XCW) bits
    with 32·XCW >= XC. The kernel is `clique_counts`'s, counted in
    LAUNCHES["clique_counts"]; it reads the two row blocks where they lie
    and builds no selector."""
    if on_cpu(a, x_rows, P, Xp, x_alive):
        return ref.hybrid_census(a, x_rows, P, Xp, x_alive)
    lead, r, u, w, xc, xcw = _check_frame("hybrid_census", a, x_rows,
                                          x_alive, P, Xp)
    outs = tuple(torch.empty(lead, dtype=torch.int32, device=a.device)
                 for _ in range(3))
    if r:
        raise_on("hybrid_census", LIBRARY.load().bitset_hybrid_census(
            *(t.data_ptr() for t in (a, x_rows, P, Xp, x_alive) + outs),
            r, u, xc, xcw, w, threads, stream()))
        LAUNCHES["clique_counts"] += 1
    return outs


def lemma8_reduce(a: torch.Tensor, x_rows: torch.Tensor, P: torch.Tensor,
                  Xp: torch.Tensor, xal: torch.Tensor, Rb: torch.Tensor,
                  rsz: torch.Tensor):
    """The dynamic degree-(|P|−1) reduction (Lemma 8) in one launch on the
    engine's operands: (P, Xp, xal, Rb, rsz, degP2, n_full), new tensors,
    as `ref.lemma8_reduce` (the contract). a (..., U, W), x_rows (..., XC,
    W), P/Xp/Rb (..., W), xal (..., XCW) bits with 32·XCW >= XC, rsz (...)
    int32, U <= 32·W. Counted in LAUNCHES["and_popcount_rows"]: its two
    sweeps are that kernel's."""
    if on_cpu(a, x_rows, P, Xp, xal, Rb, rsz):
        return ref.lemma8_reduce(a, x_rows, P, Xp, xal, Rb, rsz)
    lead, r, u, w, xc, xcw = _check_frame("lemma8_reduce", a, x_rows, xal,
                                          P, Xp, Rb)
    _check("lemma8_reduce", a, rsz)
    if rsz.dtype != torch.int32 or tuple(rsz.shape) != lead:
        raise ValueError(f"lemma8_reduce: rsz must be int32 {lead}")
    dev = a.device
    outs = tuple(torch.empty_like(t) for t in (P, Xp, xal, Rb, rsz)) + (
        torch.empty(lead + (u,), dtype=torch.int32, device=dev),
        torch.empty(lead, dtype=torch.int32, device=dev))
    if r:
        raise_on("lemma8_reduce", LIBRARY.load().bitset_lemma8_reduce(
            *(t.data_ptr() for t in (a, x_rows, P, Xp, xal, Rb, rsz) + outs),
            r, u, xc, xcw, w, stream()))
        LAUNCHES["and_popcount_rows"] += 1
    return outs


def pivot_select(a: torch.Tensor, x_rows: torch.Tensor, P: torch.Tensor,
                 Xp: torch.Tensor, xal: torch.Tensor,
                 deg: Optional[torch.Tensor] = None,
                 n_full: Optional[torch.Tensor] = None, *,
                 revised: bool = False, hybrid: bool = False,
                 density: float = HYBRID_DENSITY) -> torch.Tensor:
    """The pivot backends' branch set B (..., W) in one launch on the
    engine's operands, as `ref.pivot_select` (the contract): the universe
    scores deg − n_full, deg, or the kernel's own sweep of a, the alive X0
    rows' argmax against P, B = P & ~pivot_row, and `hybrid`'s density
    switch at `density` (passed to the kernel as float32). a (..., U, W),
    x_rows (..., XC, W), P/Xp (..., W), xal (..., XCW) bits with 32·XCW
    >= XC; deg (..., U) and n_full (...) int32 or None (n_full only with
    deg). Counted in LAUNCHES["and_popcount_argmax"]."""
    given = tuple(t for t in (deg, n_full) if t is not None)
    if on_cpu(a, x_rows, P, Xp, xal, *given):
        return ref.pivot_select(a, x_rows, P, Xp, xal, deg, n_full,
                                revised=revised, hybrid=hybrid,
                                density=density)
    lead, r, u, w, xc, xcw = _check_frame("pivot_select", a, x_rows, xal,
                                          P, Xp)
    _check("pivot_select", a, *given)
    if deg is not None and (deg.dtype != torch.int32
                            or tuple(deg.shape) != lead + (u,)):
        raise ValueError(f"pivot_select: deg must be int32 {lead + (u,)}")
    if n_full is not None and (deg is None or n_full.dtype != torch.int32
                               or tuple(n_full.shape) != lead):
        raise ValueError(f"pivot_select: n_full must be int32 {lead}, and "
                         f"comes with deg")
    B = torch.empty_like(P)
    if r:
        raise_on("pivot_select", LIBRARY.load().bitset_pivot_select(
            *(t.data_ptr() for t in (a, x_rows, P, Xp, xal)),
            *(None if t is None else t.data_ptr() for t in (deg, n_full)),
            B.data_ptr(), r, u, xc, xcw, w, int(revised), int(hybrid),
            ctypes.c_float(density), stream()))
        LAUNCHES["and_popcount_argmax"] += 1
    return B


def and_popcount_many(rows: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """out[..., m, k] = popcount(rows[..., k, :] & masks[..., m, :]) as
    int32: one row matrix (..., K, W) against a batch of masks (..., M, W)
    (the 'rcd' X-subset maximality test, with rows = P and K = 1)."""
    if on_cpu(rows, masks):
        return ref.and_popcount_many(rows, masks)
    lead, r, k, w = _check("and_popcount_many", rows, masks)
    if (masks.dtype != torch.int32 or masks.dim() != rows.dim()
            or tuple(masks.shape[:-2]) != lead or masks.shape[-1] != w
            or masks.shape[-2] == 0):
        raise ValueError(f"and_popcount_many: masks must be int32 "
                         f"{lead + ('M >= 1', w)}, got {masks.dtype} "
                         f"{tuple(masks.shape)}")
    m = masks.shape[-2]
    out = torch.empty(lead + (m, k), dtype=torch.int32, device=rows.device)
    if r:
        raise_on("and_popcount_many", LIBRARY.load().bitset_and_popcount_many(
            rows.data_ptr(), masks.data_ptr(), out.data_ptr(), r, k, m, w,
            stream()))
        LAUNCHES["and_popcount_many"] += 1
    return out


def rcd_dominated(a: torch.Tensor, x_rows: torch.Tensor, P: torch.Tensor,
                  Xp: torch.Tensor, xal: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 'rcd' maximality test in one launch on the engine's operands:
    (blocked (...) bool, psize (...) int32), as `ref.rcd_dominated` (the
    contract): some alive X0 row or universe row of Xp contains P, and
    |P|. a (..., U, W), x_rows (..., XC, W), P/Xp (..., W), xal (...,
    XCW) bits with 32·XCW >= XC, U <= 32·W. Counted in
    LAUNCHES["and_popcount_many"]; it reads the selected rows where they
    lie and takes their complement in registers."""
    if on_cpu(a, x_rows, P, Xp, xal):
        return ref.rcd_dominated(a, x_rows, P, Xp, xal)
    lead, r, u, w, xc, xcw = _check_frame("rcd_dominated", a, x_rows, xal,
                                          P, Xp)
    blocked = torch.empty(lead, dtype=torch.bool, device=a.device)
    psize = torch.empty(lead, dtype=torch.int32, device=a.device)
    if r:
        raise_on("rcd_dominated", LIBRARY.load().bitset_rcd_dominated(
            *(t.data_ptr() for t in (a, x_rows, P, Xp, xal, blocked, psize)),
            r, u, xc, xcw, w, stream()))
        LAUNCHES["and_popcount_many"] += 1
    return blocked, psize


def _window_walk(name: str, a, x_rows, alive0, winP, winB, winXp, winRb,
                 winrsz, dloc, steps: int,
                 geometry: Optional[WindowGeometry] = None):
    """Validate and launch one window walk over every lane (the leading
    dims of the windows, flattened), with `window_geometry`'s launch
    unless one is given (the card tests drive every instance)."""
    if winP.dim() < 2:
        raise ValueError(f"{name}: windows must be (..., T, W)")
    lead = tuple(winP.shape[:-2])
    T, W = winP.shape[-2:]
    U, XC = a.shape[-2], x_rows.shape[-2]
    want = {"a": (a, lead + (U, W)), "x_rows": (x_rows, lead + (XC, W)),
            "alive0": (alive0, lead + (XC,)), "winP": (winP, lead + (T, W)),
            "winB": (winB, lead + (T, W)), "winXp": (winXp, lead + (T, W)),
            "winRb": (winRb, lead + (T, W)), "winrsz": (winrsz, lead + (T,)),
            "dloc": (dloc, lead)}
    for arg, (t, shape) in want.items():
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be contiguous int32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if min(T, W, U, XC) == 0 or steps < 0:
        raise ValueError(f"{name}: empty window, rows or negative steps")
    smem = 4 * (4 * T * W + 3 * W + T)
    if smem > WINDOW_SMEM_MAX:
        raise ValueError(f"{name}: a ({T}, {W}) window needs {smem} bytes "
                         f"of shared memory, above {WINDOW_SMEM_MAX}")
    outs = tuple(torch.empty_like(t) for t in (winP, winB, winXp, winRb,
                                                 winrsz))
    ctl = torch.empty(lead + (8,), dtype=torch.int32, device=a.device)
    n = 1
    for d in lead:
        n *= d
    if n:
        geo = geometry or window_geometry(n, U, XC, T, W, _sms(a.device))
        raise_on(name, LIBRARY.load().bitset_dfs_step_window(
            *(t.data_ptr() for t in (a, x_rows, alive0, winP, winB, winXp,
                                     winRb, winrsz, dloc) + outs + (ctl,)),
            n, U, XC, T, W, steps, geo.group, geo.lanes_per_block,
            int(geo.staged), geo.index_bits, int(geo.packed), stream()))
        LAUNCHES[name] += 1
    return outs + (ctl,)


def dfs_step_window(a, x_rows, alive0, winP, winB, winXp, winRb, winrsz,
                    dloc, steps: int):
    """Up to `steps` fused pivot-BK frame-steps over a resident T-frame
    stack window (dynamic reduction off, counting only), for one root or
    a batch of roots: a (..., U, W), x_rows (..., XC, W), alive0
    (..., XC) int32 0/1, windows (..., T, W), winrsz (..., T), dloc
    (...). Returns the updated windows plus ctl (..., 8) int32 =
    [dloc', calls, branches, sum_px, cliques, steps_done, 0, 0]. Stops
    on window underflow (dloc' = −1) or overflow (a branch step at the
    top slot); a root with dloc < 0 is a no-op. See
    ref.dfs_step_window_lanes for the full contract."""
    if on_cpu(a, x_rows, alive0, winP, winB, winXp, winRb, winrsz, dloc):
        return ref.dfs_step_window(a, x_rows, alive0, winP, winB, winXp,
                                   winRb, winrsz, dloc, steps)
    return _window_walk("dfs_step_window", a, x_rows, alive0, winP, winB,
                        winXp, winRb, winrsz, dloc, steps)


def dfs_step_window_lanes(a, x_rows, alive0, winP, winB, winXp, winRb,
                          winrsz, dloc, steps: int):
    """The persistent engine's lane-batched window walk: the contract of
    `dfs_step_window` over exactly one lane axis, a (L, U, W), windows
    (L, T, W), dloc (L,), ctl (L, 8)."""
    if winP.dim() != 3:
        raise ValueError("dfs_step_window_lanes: windows must be (L, T, W)")
    if on_cpu(a, x_rows, alive0, winP, winB, winXp, winRb, winrsz, dloc):
        return ref.dfs_step_window_lanes(a, x_rows, alive0, winP, winB,
                                         winXp, winRb, winrsz, dloc, steps)
    return _window_walk("dfs_step_window_lanes", a, x_rows, alive0, winP,
                        winB, winXp, winRb, winrsz, dloc, steps)
