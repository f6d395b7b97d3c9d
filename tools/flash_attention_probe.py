#!/usr/bin/env python3
"""One-off measurements of flash_attention's bf16 tensor-core kernel on one
NVIDIA GPU, behind the notes on it in PERF.md:

1. registers: the kernel source compiled once more with the port's nvcc
   flags plus `-Xptxas -v`; for each instance of
   `flash_attention_sm90_kernel` its registers, stack frame and spill
   bytes, and every warning ptxas printed (such as C7508, "setmaxnreg
   ignored");
2. P rounding: the kernel's arithmetic in plain PyTorch (128-key tiles, the
   online softmax in float32, l from the unrounded p) with P rounded once
   to bf16 before P.V, and with P split into the pair bf16(p) +
   bf16(p - bf16(p)) as the kernel does, each held to the plain version
   under the card's bf16 check (rtol 1e-2, atol 1e-3 elementwise, relative
   norm under 1e-2), on the inputs of the card test, of chip_smoke.py's
   bf16 edge shape and two heads of qwen3-14b at train_4k.

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


def ptxas_report(source: Path, match: str = "flash_attention_sm90") -> dict:
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
            name = m.group(1) if match in m.group(1) else None
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
    train = [t.transpose(1, 2).reshape(b * h, s, d)[:2].contiguous()
             for t in (q, k, v)]
    return {"card test (2, 300, 128), seed 8": card,
            "edge shape (2, 128, 128, 64)": edge,
            "train_4k, two heads": train}


def p_rounding(dev) -> None:
    import torch
    from repro_torch.kernels.flash_attention import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    for label, (q, k, v) in p_rounding_inputs(dev).items():
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import ops
    emit(dict(check="ptxas", **ptxas_report(ops.SOURCE)))
    p_rounding(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
