"""Dispatching wrapper for flash attention, forward and backward.

Dispatch is by the device of the tensors handed in, and by nothing else:
a CPU tensor takes the plain version in `ref`; a CUDA tensor launches the
hand-written Hopper kernels of `csrc/flash_attention.cu` (built at first
use by the port's build helper) or raises. `takes_tensor_cores` picks the
forward kernel: bfloat16 at D = 64 or 128 takes the bf16 `wgmma` kernel
fed by TMA, everything else (float32, float16, bfloat16 at another D)
the CUDA-core kernel, which computes in float32; neither falls back to
the other. `LAUNCHES["flash_attention"]` counts every forward launch,
`LAUNCHES["flash_attention_wgmma"]` those of the tensor-core kernel.

`flash_attention` and `mha` are differentiable: an autograd Function
saves q, k and v and its backward calls `flash_attention_bwd`, three
CUDA-core launches on the card (each counted in
`LAUNCHES["flash_attention_bwd"]`: the rows' log-sum-exp and
rowsum(dO * O) of the recomputed float32 output, then dK and dV a key
tile a block, then dQ a query tile a block), the plain
`ref.flash_attention_bwd` on the CPU.

`mha` adapts the (B, S, H, D) layout of the models to the kernel's
flattened (B*H, S, D) layout; GQA expansion happens before the call (the
kernel is head-agnostic).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import (CudaLibrary, Launches, on_cpu,
                                        raise_on, stream)
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_p, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_BWD_TAIL = [_ll, _i, _i, _i, _f, _i, _i, _p]
LIBRARY = CudaLibrary(SOURCE, {
    "flash_attention_fwd": [_p, _p, _p, _p, _ll, _i, _i, _i, _f, _i, _i, _p],
    "flash_attention_fwd_sm90": [_p, _p, _p, _p, _ll, _i, _i, _i, _f, _i,
                                 _p],
    # backward: pointers, then (BH, Sq, Sk, D, scale, causal, dtype, stream)
    "flash_attention_bwd_rows": [_p] * 6 + _BWD_TAIL,
    "flash_attention_bwd_dkdv": [_p] * 8 + _BWD_TAIL,
    "flash_attention_bwd_dq": [_p] * 7 + _BWD_TAIL})
LAUNCHES = Launches({"flash_attention": 0, "flash_attention_wgmma": 0,
                     "flash_attention_bwd": 0})
# Head widths the CUDA-core kernel takes: its accumulator is sized at
# compile time (64, 128 or 256 columns); the repo's configurations use 128.
MAX_HEAD_DIM = 256
# Head widths of the tensor-core kernel (one or two 64-column TMA boxes).
TENSOR_CORE_HEAD_DIMS = (64, 128)
# Types of the CUDA-core kernel (its C entry point's dtype code).
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def takes_tensor_cores(dtype: torch.dtype, d: int) -> bool:
    """Whether a CUDA call takes the bf16 tensor-core kernel: bfloat16 at
    D = 64 or 128. float32 stays on the CUDA cores (its 2e-5 checks are
    beyond TF32), as does bfloat16 at any other D."""
    return dtype == torch.bfloat16 and d in TENSOR_CORE_HEAD_DIMS


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention forward. q: (BH, Sq, D); k, v: (BH, Sk, D), all
    float32, all bfloat16 or all float16 -> (BH, Sq, D) in q's type.
    Scale 1/sqrt(D); causal masks k_pos > q_pos (top-left aligned, also
    when Sq != Sk). On the card D is at most MAX_HEAD_DIM (256): a wider
    head is refused. Differentiable in q, k and v (`_Attention`)."""
    return _Attention.apply(q, k, v, causal)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernels take, else ValueError."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: q must be (BH, Sq, D) and k, v "
                         f"(BH, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be float32, "
                         f"all bfloat16 or all float16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head width {d} is outside "
                         f"1..{MAX_HEAD_DIM}")
    if sk == 0:
        raise ValueError("flash_attention: no keys")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> torch.Tensor:
    if on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal)
    _check(q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    if not (bh and sq):
        return out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            sk, d, 1.0 / math.sqrt(d), int(causal))
    if takes_tensor_cores(q.dtype, d):
        raise_on("flash_attention",
                 LIBRARY.load().flash_attention_fwd_sm90(*args, stream()))
        LAUNCHES["flash_attention_wgmma"] += 1
    else:
        raise_on("flash_attention", LIBRARY.load().flash_attention_fwd(
            *args, _DTYPES[q.dtype], stream()))
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True):
    """(dq, dk, dv) of `flash_attention` at the output's gradient `do`
    ((BH, Sq, D) in q's type), each in q's type. On the card: three
    launches, float32 inside (each row's output and log-sum-exp are
    recomputed, the forward saves neither); deterministic, no atomics."""
    if on_cpu(q, k, v, do):
        return ref.flash_attention_bwd(q, k, v, do, causal=causal)
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: do must be "
                         f"{q.dtype}{tuple(q.shape)}, got "
                         f"{do.dtype}{tuple(do.shape)}")
    do = do.contiguous()
    bh, sq, d = q.shape
    sk = k.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not bh:
        return dq, dk, dv
    if not sq:
        return dq, dk.zero_(), dv.zero_()
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    lib = LIBRARY.load()
    qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    rows = (lse.data_ptr(), delta.data_ptr())
    tail = (bh, sq, sk, d, 1.0 / math.sqrt(d), int(causal), _DTYPES[q.dtype],
            stream())
    for name, fn, ptrs in (
            ("rows", lib.flash_attention_bwd_rows,
             (*qkv, do.data_ptr(), *rows)),
            ("dkdv", lib.flash_attention_bwd_dkdv,
             (*qkv, do.data_ptr(), *rows, dk.data_ptr(), dv.data_ptr())),
            ("dq", lib.flash_attention_bwd_dq,
             (*qkv, do.data_ptr(), *rows, dq.data_ptr()))):
        raise_on(f"flash_attention_bwd_{name}", fn(*ptrs, *tail))
        LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """`flash_attention` with its backward: the kernels on the card, the
    plain versions on the CPU, chosen by the tensors' device."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do.to(q.dtype),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True) -> torch.Tensor:
    """(B, S, H, D) attention via the flash kernel."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    # at B = 1 the reshape is a strided view: copy to the kernel's layout
    qf = q.transpose(1, 2).reshape(b * h, sq, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * h, sk, d).contiguous()
    vf = v.transpose(1, 2).reshape(b * h, sk, d).contiguous()
    out = flash_attention(qf, kf, vf, causal=causal)
    return out.reshape(b, h, sq, d).transpose(1, 2)
