#!/usr/bin/env python3
"""Where a served LM request's device time goes, by kernel, on one NVIDIA
GPU: qwen3-14b at `build()` (40 layers, bfloat16, random weights from
seed 0) at chip_smoke.py's serve shapes (4 prompts of 2,048 tokens, a
cache of 2,080 slots), one decode step at the cache's last position and
one prefill, each under torch.profiler after two warm-up calls. For each,
the device time summed over its kernels and the top kernels and aten ops
by device time (PERF.md §5, serving).

    PYTHONPATH=src python3 tools/serve_probe.py [--top N]

Run from the root of a checkout with a CUDA card and nvcc. Prints one JSON
line per step. Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

BATCH, PROMPT, NEW = 4, 2048, 32


def breakdown(fn, top):
    """(device ms, kernels, top kernels, top aten ops) of one call of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels),
            [(e.key[:120], e.count, e.self_device_time_total / 1e3)
             for e in kernels[:top]],
            [(e.key, e.count, e.device_time_total / 1e3) for e in ops[:top]])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_steps import make_prefill_step
    dev = torch.device("cuda")
    cfg = get_arch("qwen3-14b").build()
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    cache = T.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    cache["pos"] = PROMPT + NEW - 1
    tok = torch.zeros(BATCH, 1, dtype=torch.int64, device=dev)
    prompts = torch.zeros(BATCH, PROMPT, dtype=torch.int32, device=dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    for name, fn in (
            ("decode_step", lambda: T.decode_step(cfg, model, cache, tok)),
            ("prefill", lambda: make_prefill_step(cfg)(model, prompts))):
        ms, n, kernels, ops = breakdown(fn, args.top)
        print(json.dumps(dict(step=name, device_ms=ms, kernels=n,
                              top_kernels=kernels, top_ops=ops,
                              card=card)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
