"""Dispatching wrapper for bitset set algebra — the engine's ONLY entry point.

Layering contract (DESIGN.md §3, as in the reference package): every module
outside `kernels/bitset_ops` that needs bitset algebra calls this module,
never `ref` or the CUDA library directly, so there is one choke point to
measure, swap and accelerate.

Dispatch is by the device of the tensors handed in, and by nothing else:

* a CPU tensor takes the plain PyTorch version in `ref`;
* a CUDA tensor launches the hand-written Hopper kernel from
  `csrc/bitset_ops.cu` (built on first use by `build`), or raises. No CUDA
  tensor ever reaches `ref`, and a failed build or launch is an error.

Each kernel wrapper adds one to `LAUNCHES[name]` where it launches, and
nowhere else, so a run can show that it went through the kernels.

Shapes: rows (..., K, W) int32 bit words, masks (..., W), valid (..., K)
bool, with the same leading root-batch dims; the kernels see them
flattened to (R, K, W).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.bitset_ops import build, ref
from repro_torch.kernels.bitset_ops.words import (and_rows,  # noqa: F401
                                                  popcount, popcount_words)

LAUNCHES: Dict[str, int] = {"frame_step": 0, "and_popcount_rows": 0,
                            "and_popcount_argmax": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"bitset ops take CPU or CUDA tensors on one device, "
                     f"got {sorted(devs)}")


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


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def and_popcount_rows(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """out[..., k] = popcount(rows[..., k, :] & mask[..., :]) as int32."""
    if _on_cpu(rows, mask):
        return ref.and_popcount_rows(rows, mask)
    lead, r, k, w = _check("and_popcount_rows", rows, mask)
    _check_mask("and_popcount_rows", mask, lead, w)
    out = torch.empty(lead + (k,), dtype=torch.int32, device=rows.device)
    if r:
        _raise_on("and_popcount_rows", build.load().bitset_and_popcount_rows(
            rows.data_ptr(), mask.data_ptr(), out.data_ptr(), r, k, w,
            _stream()))
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
    if _on_cpu(rows, mask, valid):
        return ref.and_popcount_argmax(rows, mask, valid)
    lead, r, k, w = _check("and_popcount_argmax", rows, mask, valid)
    _check_mask("and_popcount_argmax", mask, lead, w)
    if valid.dtype != torch.bool or tuple(valid.shape) != lead + (k,):
        raise ValueError(f"and_popcount_argmax: valid must be bool "
                         f"{lead + (k,)}")
    idx = torch.empty(lead, dtype=torch.int32, device=rows.device)
    best = torch.empty(lead, dtype=torch.int32, device=rows.device)
    if r:
        _raise_on("and_popcount_argmax",
                  build.load().bitset_and_popcount_argmax(
                      rows.data_ptr(), mask.data_ptr(), valid.data_ptr(),
                      idx.data_ptr(), best.data_ptr(), r, k, w, _stream()))
        LAUNCHES["and_popcount_argmax"] += 1
    return idx, best


def frame_step(rows: torch.Tensor, p: torch.Tensor, xp: torch.Tensor,
               wrow: torch.Tensor):
    """Fused BK frame step: (childp, childxp, deg, partner).

    childp = p & wrow, childxp = xp & wrow, deg[k] = popcount(rows[k] &
    childp), partner[k] = the surviving bit index where deg[k] == 1 (the
    Lemma-7 partner; garbage elsewhere). One pass over the (K, W) rows
    replaces the engine's child-AND, degree sweep and partner extraction."""
    if _on_cpu(rows, p, xp, wrow):
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
        _raise_on("frame_step", build.load().bitset_frame_step(
            rows.data_ptr(), p.data_ptr(), xp.data_ptr(), wrow.data_ptr(),
            childp.data_ptr(), childxp.data_ptr(), deg.data_ptr(),
            partner.data_ptr(), r, k, w, _stream()))
        LAUNCHES["frame_step"] += 1
    return childp, childxp, deg, partner
