#!/usr/bin/env python3
"""One-off measurements of flash_attention's bf16 tensor-core kernels on one
NVIDIA GPU, behind the notes on them in PERF.md:

1. registers: the kernel source compiled once more with the port's nvcc
   flags plus `-Xptxas -v`; for each instance of the forward
   (`flash_attention_sm90_kernel`) and of the backward's three passes
   (`bwd90::rows_kernel`, `dkdv_kernel`, `dq_kernel`) its registers, stack
   frame and spill bytes, and every warning ptxas printed (such as C7508,
   "setmaxnreg ignored");
2. P rounding: the kernel's arithmetic in plain PyTorch (128-key tiles, the
   online softmax in float32, l from the unrounded p) with P rounded once
   to bf16 before P.V, and with P split into the pair bf16(p) +
   bf16(p - bf16(p)) as the kernel does, each held to the plain version
   under the card's bf16 check (rtol 1e-2, atol 1e-3 elementwise, relative
   norm under 1e-2), on the inputs of the card test, of chip_smoke.py's
   bf16 edge shape and two heads of qwen3-14b at train_4k;
3. P and dS rounding in the backward: its gradients in plain PyTorch
   (float32, TF32 off) with P (in dV = P^T dO) and dS (in dK = dS^T Q and
   dQ = dS K) each as a sum of one, two or three bf16 terms (the kernels
   use three), held to `ref.flash_attention_bwd` under the same checks, on
   the card test's bf16 inputs at D = 128 and two heads of train_4k; and
   on the GQA card test's inputs, whose leaves sum two heads' bf16
   gradients;
4. the backward at qwen3-14b's train_4k (40 heads, S = 4,096, D = 128,
   bf16, causal, seeded inputs): each tensor-core pass alone and the
   whole tensor-core backward against the CUDA-core one in turns (new,
   old, old, new), CUDA events, median of 5 windows of 3 calls each;
5. rounding flips of the two backwards: the share of each gradient's
   elements whose bf16 value differs from the float32 plain backward's
   rounded once (the size of the error before the output's rounding, in
   flips), on the GQA card test's inputs (and whether each leaf's
   summed gradient meets the bf16 checks against the plain backward's)
   and on (6, 517, 517, 128), causal.

    PYTHONPATH=src python3 tools/flash_attention_probe.py

Run from the root of a checkout with a CUDA card and nvcc. Prints one JSON
line per result. Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

BF16_RTOL, BF16_ATOL = 1e-2, 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_report(source: Path,
                 match=("flash_attention_sm90", "bwd90")) -> dict:
    """{"kernels": {mangled name: {registers, stack_bytes, spill_stores,
    spill_loads}}, "warnings": [...]} from one nvcc -Xptxas -v build."""
    from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, nvcc
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, out = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", out, str(source)],
            capture_output=True, text=True, timeout=600)
    finally:
        os.unlink(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    kernels, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?"
                      r"([\w$]+)", line)
        if m:
            name = m.group(1) if any(t in m.group(1) for t in match) \
                else None
            continue
        if name is None:
            continue
        k = kernels.setdefault(name, {})
        for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers")):
            m = re.search(pat, line)
            if m:
                k[key] = int(m.group(1))
    warnings = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                if "warning" in ln.lower()]
    return {"kernels": kernels, "warnings": warnings}


def p_rounding_model(q, k, v, causal, split, bk=128):
    """The tensor-core kernel's arithmetic in plain PyTorch, on (BH, S, D)
    bf16 tensors: key tiles of `bk`, the online softmax in float32 in the
    log2 domain, l from the unrounded p, P.V with p rounded to bf16 once
    (`split=False`) or as the pair bf16(p) + bf16(p - bf16(p)) (`split=
    True`), products summed in float32 (TF32 off), output in bf16."""
    import torch
    bh, sq, d = q.shape
    sk = k.shape[1]
    c = 1.4426950408889634 / d ** 0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bh, sq, 1), -1e30, device=q.device)
    l = torch.zeros(bh, sq, 1, device=q.device)
    acc = torch.zeros(bh, sq, d, device=q.device)
    for k0 in range(0, sk, bk):
        kt, vt = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
        kpos = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None, :]
        x = torch.einsum("bqd,bkd->bqk", q.float(), kt) * c
        if causal:
            x = torch.where(qpos >= kpos, x, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp2(x - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


def p_rounding_inputs(dev):
    """{label: (q, k, v)}: the card test's inputs (tests/
    test_torch_cuda_kernels.py::test_cuda_flash_attention_bf16), chip_smoke
    .py's bf16 edge shape and the first two heads of its train_4k inputs."""
    import numpy as np
    import torch
    rng = np.random.default_rng(8)
    card = [torch.from_numpy(rng.normal(size=(2, 300, 128))).to(
        dev, torch.bfloat16) for _ in range(3)]
    rng = np.random.default_rng(2 * 128 + 64)
    edge = [torch.from_numpy(rng.normal(size=(2, 128, 64)).astype(
        np.float32)).to(dev).to(torch.bfloat16) for _ in range(3)]
    b, s, h, kv, d = 1, 4096, 40, 8, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, s, kv, d, generator=gen, device=dev)
            .to(torch.bfloat16)[:, :, :, None, :]
            .expand(b, s, kv, h // kv, d).reshape(b, s, h, d)
            for _ in range(2))
    heads = [t.transpose(1, 2).reshape(b * h, s, d).contiguous()
             for t in (q, k, v)]
    return {"card test (2, 300, 128), seed 8": card,
            "edge shape (2, 128, 128, 64)": edge,
            "train_4k, two heads": [t[:2].contiguous() for t in heads],
            "train_4k, all heads": heads}


def p_rounding(dev) -> None:
    import torch
    from repro_torch.kernels.flash_attention import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    for label, (q, k, v) in p_rounding_inputs(dev).items():
        if label == "train_4k, all heads":
            continue
        want = ref.flash_attention(q, k, v, causal=True).float()
        for split in (False, True):
            got = p_rounding_model(q, k, v, True, split).float()
            diff = (got - want).abs()
            emit(dict(check="p_rounding", inputs=label, shape=list(q.shape),
                      p="bf16 pair" if split else "bf16 once",
                      out_of_tolerance=int(
                          (diff > BF16_ATOL + BF16_RTOL * want.abs()).sum()),
                      max_abs_err=float(diff.max()),
                      rel_norm_err=float(diff.norm() / want.norm())))


def bf16_terms(x, n):
    """x as the sum of n bf16 terms (hi = bf16(x), then each next term the
    bf16 of what is left), back in float32."""
    import torch
    out, rest = torch.zeros_like(x), x
    for _ in range(n):
        term = rest.to(torch.bfloat16).float()
        out, rest = out + term, rest - term
    return out


def ds_rounding_model(q, k, v, do, causal, p_terms, ds_terms):
    """(dq, dk, dv) in bf16 of the backward's arithmetic in plain PyTorch,
    float32 throughout but P entering dV and dS entering dK and dQ as sums
    of `p_terms` and `ds_terms` bf16 terms."""
    import torch
    from repro_torch.kernels.flash_attention import ref
    scale = q.shape[-1] ** -0.5
    p = ref._softmax(ref._scores(q, k, causal))
    dof = do.float()
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    p, ds = bf16_terms(p, p_terms), bf16_terms(ds, ds_terms)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


# (P terms, dS terms): each operand once against three, two each, and the
# three-term design with either operand at two
TERMS = ((1, 3), (3, 1), (2, 2), (2, 3), (3, 2), (3, 3))


def _errors(got, want):
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return dict(out_of_tolerance=int((diff > BF16_ATOL + BF16_RTOL
                                      * w.abs()).sum()),
                max_abs_err=float(diff.max()),
                rel_norm_err=float(diff.norm() / w.norm()))


def ds_rounding_inputs(dev):
    """{label: (q, k, v, dO, causal)}: the card test's bf16 inputs at
    D = 128 (tests/test_torch_cuda_kernels.py::_bwd_inputs) and two heads
    of chip_smoke.py's train_4k attention inputs with a seeded dO."""
    import numpy as np
    import torch
    out = {}
    for sq, sk, causal in ((130, 130, True), (384, 384, True),
                           (517, 261, True), (261, 517, True),
                           (517, 261, False)):
        rng = np.random.default_rng(sq + 3 * sk + 128 + causal)
        q, k, v = (torch.from_numpy(rng.normal(size=(3, s, 128))).to(
            dev, torch.bfloat16) for s in (sq, sk, sk))
        do = torch.from_numpy(rng.normal(size=(3, sq, 128))).to(
            dev, torch.bfloat16)
        out[f"card test (3, {sq}, {sk}, 128), causal {causal}"] = (
            q, k, v, do, causal)
    q, k, v = p_rounding_inputs(dev)["train_4k, two heads"]
    gen = torch.Generator(device=dev).manual_seed(3)
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    out["train_4k, two heads"] = (q, k, v, do, True)
    return out


def ds_rounding(dev) -> None:
    import torch
    from repro_torch.kernels.flash_attention import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    for label, (q, k, v, do, causal) in ds_rounding_inputs(dev).items():
        want = ref.flash_attention_bwd(q, k, v, do, causal=causal)
        for p_terms, ds_terms in TERMS:
            got = ds_rounding_model(q, k, v, do, causal, p_terms, ds_terms)
            emit(dict(check="ds_rounding", inputs=label,
                      shape=list(q.shape), sk=k.shape[1], p_terms=p_terms,
                      ds_terms=ds_terms, **{
                          name: _errors(g, w) for name, g, w in
                          zip(("dq", "dk", "dv"), got, want)}))


def gqa_rounding(dev) -> None:
    """The same study on the inputs of tests/test_torch_cuda_kernels.py::
    test_cuda_mha_backward_reaches_q_k_v (bf16, D = 128, 4 query heads over
    2 kv heads): the leaves' gradients, each kv head's two query heads
    rounded to bf16 and then summed as autograd sums them, against autograd
    through the plain forward. Where two heads' gradients cancel, one bf16
    rounding that flips in either moves the sum by an ulp of the heads'
    own size."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.models.layers import repeat_kv
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(128)
    b, s, h, kv, d = 2, 96, 4, 2, 128
    leaves = [torch.from_numpy(rng.normal(size=(b, s, n, d))).to(
        dev, torch.bfloat16).requires_grad_() for n in (h, kv, kv)]
    do = torch.from_numpy(rng.normal(size=(b, s, h, d))).to(dev,
                                                            torch.bfloat16)
    qkv = (leaves[0], repeat_kv(leaves[1], h // kv),
           repeat_kv(leaves[2], h // kv))
    flat = [t.transpose(1, 2).reshape(b * h, s, d) for t in qkv]
    ref.flash_attention(*flat, causal=True).reshape(
        b, h, s, d).transpose(1, 2).backward(do)
    want = [t.grad for t in leaves]
    flat = [t.detach() for t in flat]
    dof = do.transpose(1, 2).reshape(b * h, s, d)

    def leaf(g, heads):
        g = g.reshape(b, h, s, d).transpose(1, 2)
        return g if heads == h else g.reshape(b, s, kv, h // kv, d).sum(3)
    for p_terms, ds_terms in ((1, 1),) + TERMS:
        got = ds_rounding_model(*flat, dof, True, p_terms, ds_terms)
        emit(dict(check="gqa_rounding", shape=[b, s, h, kv, d],
                  p_terms=p_terms, ds_terms=ds_terms, **{
                      name: _errors(leaf(g, n), w) for name, g, n, w in
                      zip(("dq", "dk", "dv"), got, (h, kv, kv), want)}))


def bwd_timing(dev) -> None:
    import math
    import torch
    from repro_torch.kernels._build import stream
    from repro_torch.kernels.flash_attention import ops
    q, k, v = p_rounding_inputs(dev)["train_4k, all heads"]
    gen = torch.Generator(device=dev).manual_seed(3)
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    bh, s, d = q.shape
    lib = ops.LIBRARY.load()
    lse = torch.empty(bh, ops.padded_rows(s), device=dev)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    tail = (bh, s, s, d, 1.0 / math.sqrt(d), 1, 0, 1)   # causal, offset 0
    passes = {
        "rows": lambda: lib.flash_attention_bwd_rows_sm90(*ptrs, *tail,
                                                          stream()),
        "dkdv": lambda: lib.flash_attention_bwd_dkdv_sm90(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *tail, stream()),
        "dq": lambda: lib.flash_attention_bwd_dq_sm90(
            *ptrs, dq.data_ptr(), *tail, stream())}

    def ms(fn, windows=5, calls=3):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(windows):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b) / calls)
        return sorted(out)[len(out) // 2]
    line = {name: ms(fn) for name, fn in passes.items()}
    new = lambda: ops._backward(q, k, v, do, True)            # noqa: E731
    old = lambda: ops._backward(q, k, v, do, True, cuda_cores=True)  # noqa
    turns = [ms(new), ms(old, 3, 1), ms(old, 3, 1), ms(new)]
    emit(dict(check="bwd_timing", shape=[bh, s, s, d, True, "bf16"],
              passes_ms=line, in_turns_ms=dict(new=[turns[0], turns[3]],
                                               old=[turns[1], turns[2]])))


def bwd_flips(dev) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models.layers import repeat_kv
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(128)
    b, s, h, kv, d = 2, 96, 4, 2, 128
    leaves = [torch.from_numpy(rng.normal(size=(b, s, n, d))).to(
        dev, torch.bfloat16) for n in (h, kv, kv)]
    do = torch.from_numpy(rng.normal(size=(b, s, h, d))).to(dev,
                                                            torch.bfloat16)
    qkv = (leaves[0], repeat_kv(leaves[1], h // kv),
           repeat_kv(leaves[2], h // kv), do)
    gqa = [t.transpose(1, 2).reshape(b * h, s, d).contiguous() for t in qkv]
    rng = np.random.default_rng(5)
    big = [torch.from_numpy(rng.normal(size=(6, 517, 128))).to(
        dev, torch.bfloat16) for _ in range(4)]

    def leaf(g, heads):
        g = g.reshape(b, h, s, d).transpose(1, 2).float()
        return g if heads == h else g.reshape(b, s, kv, h // kv, d).sum(3)
    for label, (q, k, v, o) in (("GQA card test", gqa),
                                ("(6, 517, 517, 128)", big)):
        want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                       o.float(), causal=True)
        for name, cuda_cores in (("tensor cores", False),
                                 ("CUDA cores", True)):
            got = ops._backward(q, k, v, o, True, cuda_cores=cuda_cores)
            line = dict(check="bwd_flips", inputs=label, kernel=name)
            for what, g, w, heads in zip(("dq", "dk", "dv"), got, want,
                                         (h, kv, kv)):
                wb = w.to(torch.bfloat16)
                line[what] = dict(flip_share=float((g != wb).float().mean()))
                if label == "GQA card test":
                    gl, wl = leaf(g, heads), leaf(wb, heads)
                    line[what]["leaf_out_of_tolerance"] = int(
                        ((gl - wl).abs() > BF16_ATOL
                         + BF16_RTOL * wl.abs()).sum())
            emit(line)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import ops
    emit(dict(check="ptxas", **ptxas_report(ops.SOURCE)))
    p_rounding(torch.device("cuda"))
    ds_rounding(torch.device("cuda"))
    gqa_rounding(torch.device("cuda"))
    bwd_timing(torch.device("cuda"))
    bwd_flips(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
