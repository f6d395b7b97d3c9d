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
launches on the card, each counted in `LAUNCHES["flash_attention_bwd"]`:
the rows' log-sum-exp and delta = rowsum(P * dP) of the unrounded
softmax, then dK and dV a key tile a block, then dQ a query tile a block.
`takes_tensor_cores` routes it as it routes the forward: bfloat16 at
D = 64 or 128 takes the bf16 `wgmma` kernels fed by TMA (also counted in
`LAUNCHES["flash_attention_bwd_wgmma"]`), everything else the CUDA-core
float32 kernels; on the CPU it is the plain `ref.flash_attention_bwd`.
`_backward(..., cuda_cores=True)` forces the CUDA-core kernels on bf16
inputs too (for the card tests and timing them in turns).

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
_BWD_TAIL = [_ll, _i, _i, _i, _f, _i, _i, _i, _p]
LIBRARY = CudaLibrary(SOURCE, {
    # pointers, then (BH, Sq, Sk, D, scale, causal, q_offset[, dtype],
    # stream)
    "flash_attention_fwd": [_p, _p, _p, _p, _ll, _i, _i, _i, _f, _i, _i, _i,
                            _p],
    "flash_attention_fwd_sm90": [_p, _p, _p, _p, _ll, _i, _i, _i, _f, _i,
                                 _i, _p],
    "flash_attention_bwd_rows": [_p] * 6 + _BWD_TAIL,
    "flash_attention_bwd_dkdv": [_p] * 8 + _BWD_TAIL,
    "flash_attention_bwd_dq": [_p] * 7 + _BWD_TAIL,
    "flash_attention_bwd_rows_sm90": [_p] * 6 + _BWD_TAIL,
    "flash_attention_bwd_dkdv_sm90": [_p] * 8 + _BWD_TAIL,
    "flash_attention_bwd_dq_sm90": [_p] * 7 + _BWD_TAIL})
LAUNCHES = Launches({"flash_attention": 0, "flash_attention_wgmma": 0,
                     "flash_attention_bwd": 0,
                     "flash_attention_bwd_wgmma": 0})
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
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Softmax attention forward. q: (BH, Sq, D); k, v: (BH, Sk, D), all
    float32, all bfloat16 or all float16 -> (BH, Sq, D) in q's type.
    Scale 1/sqrt(D); causal masks k_pos > q_pos + q_offset (top-left
    aligned at q_offset 0, also when Sq != Sk; q_offset >= 0 is where the
    query rows start among the keys, as on a rank of a sequence split). On
    the card D is at most MAX_HEAD_DIM (256): a wider head is refused.
    Differentiable in q, k and v (`_Attention`)."""
    return _Attention.apply(q, k, v, causal, q_offset)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    """What the kernels take, else ValueError."""
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
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
             causal: bool, q_offset: int) -> torch.Tensor:
    if on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    _check(q, k, v, q_offset)
    bh, sq, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    if not (bh and sq):
        return out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            sk, d, 1.0 / math.sqrt(d), int(causal), q_offset)
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
                        do: torch.Tensor, *, causal: bool = True,
                        q_offset: int = 0):
    """(dq, dk, dv) of `flash_attention` at the output's gradient `do`
    ((BH, Sq, D) in q's type), each in q's type. On the card: three
    launches (each row's log-sum-exp and delta are recomputed, the forward
    saves neither), on the tensor cores where `takes_tensor_cores`, else on
    the CUDA cores in float32; deterministic, no atomics."""
    return _backward(q, k, v, do, causal, q_offset)


def padded_rows(sq: int) -> int:
    """Rows of the tensor-core backward's lse and delta scratch: Sq rounded
    up to a whole 128-row query tile."""
    return -(-sq // 128) * 128


def _backward(q, k, v, do, causal, q_offset=0, *, cuda_cores: bool = False):
    """`flash_attention_bwd`; `cuda_cores=True` takes the CUDA-core kernels
    whatever the dtype and D."""
    if on_cpu(q, k, v, do):
        return ref.flash_attention_bwd(q, k, v, do, causal=causal,
                                       q_offset=q_offset)
    _check(q, k, v, q_offset)
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
    wgmma = takes_tensor_cores(q.dtype, d) and not cuda_cores
    lse = torch.empty(bh, padded_rows(sq) if wgmma else sq,
                      dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    lib = LIBRARY.load()
    qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr())
    rows = (lse.data_ptr(), delta.data_ptr())
    tail = (bh, sq, sk, d, 1.0 / math.sqrt(d), int(causal), q_offset,
            _DTYPES[q.dtype], stream())
    suffix = "_sm90" if wgmma else ""
    for name, out in (("rows", ()), ("dkdv", (dk.data_ptr(), dv.data_ptr())),
                      ("dq", (dq.data_ptr(),))):
        fn = getattr(lib, f"flash_attention_bwd_{name}{suffix}")
        raise_on(f"flash_attention_bwd_{name}{suffix}",
                 fn(*qkv, *rows, *out, *tail))
        LAUNCHES["flash_attention_bwd"] += 1
        if wgmma:
            LAUNCHES["flash_attention_bwd_wgmma"] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """`flash_attention` with its backward: the kernels on the card, the
    plain versions on the CPU, chosen by the tensors' device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        ctx.causal, ctx.q_offset = causal, q_offset
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal, q_offset)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do.to(q.dtype),
                                         causal=ctx.causal,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """(B, S, H, D) attention via the flash kernel; q's rows start at
    q_offset among k's (`flash_attention`)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    # at B = 1 the reshape is a strided view: copy to the kernel's layout
    qf = q.transpose(1, 2).reshape(b * h, sq, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * h, sk, d).contiguous()
    vf = v.transpose(1, 2).reshape(b * h, sk, d).contiguous()
    out = flash_attention(qf, kf, vf, causal=causal, q_offset=q_offset)
    return out.reshape(b, h, sq, d).transpose(1, 2)
