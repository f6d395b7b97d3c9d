#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the MCE engine on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the Hopper kernels from `src/repro_torch/kernels/bitset_ops/
csrc/` and then, printing one JSON line per phase:

1. device: the card, its driver and power limit, and the kernels' build;
2. kernels: each CUDA kernel held bit-exact against its plain PyTorch
   version on the same CUDA tensors, at edge shapes and at the shapes of
   the Graph500 scale-12 buckets (the window walk on the windows the
   persistent and per-root engines launch it with), with CUDA-event
   times;
3. small graphs: `run(g)` on the card with enumeration, against the
   port's oracles (exact clique sets) and the reference's pivot counters;
4. device peel: the degree-0/1 peel on the card against its host mirror;
5. the slice: `run(kronecker(11, 16, seed=0))` with `run()` defaults
   (the per-root engine) on the card, against the reference's counters;
6. the persistent paths on `kronecker(12, 16, seed=0)`: the lane engine
   (`engine="persistent"`), its fused window walk (`window_steps=16`,
   dynamic reduction off), the per-root window walk, and
   `engine="auto"`, each against the reference's counters and, for the
   lane engine, its scheduling stats;
7. step and trip profiles: where a per-root step's and a persistent
   trip's time goes (host against device).

Each path runs with the kernels' launch counts set to 0 just before it
and read just after, and fails if a kernel of that path was not launched.

Every check raises on failure (exit code 1). The last two lines are the
kernel table as JSON and `{"ok": true, "device": {...}}`. It imports
nothing of JAX or of the reference package `repro`.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
# Integer ALU work (AND, popcount, add) has no row in the data sheet's peak
# table; its float32 non-tensor rate, 67 TFLOP/s, stands in as the
# operations bound. The bytes bound is the larger for every kernel at the
# slice's shapes.
OPS_PER_S = 67e12
SOURCE = "src/repro_torch/kernels/bitset_ops/csrc/bitset_ops.cu"
REPLACES = {
    "frame_step": "src/repro/kernels/bitset_ops/kernel.py:167",
    "and_popcount_rows": "src/repro/kernels/bitset_ops/kernel.py:67",
    "and_popcount_argmax": "src/repro/kernels/bitset_ops/kernel.py:103",
    "dfs_step_window": "src/repro/kernels/bitset_ops/kernel.py:559",
    "dfs_step_window_lanes": "src/repro/kernels/bitset_ops/kernel.py:613",
}

# The reference's counters, from `repro.core.engine.run(...)` with JAX
# 0.9.0 on the CPU. The per-root slice: kronecker(11, 16, seed=0) with
# run() defaults (perroot, pivot, dynamic_red=True):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "from repro.core.engine \
#     import run; from repro.graph.generators import kronecker; \
#     r = run(kronecker(11, 16, seed=0)); print(r.cliques, r.calls, \
#     r.branches, r.sum_px, r.pre_reported)"
SLICE11_EXPECT = dict(cliques=122_478, calls=113_416, branches=112_187,
                      sum_px=683_947, pre_reported=1_031)
# kronecker(12, 16, seed=0) with dynamic reduction on: the per-root
# defaults, engine="persistent" and engine="auto" give the same counters
SLICE_EXPECT = dict(cliques=807_367, calls=733_591, branches=731_284,
                    sum_px=4_290_765, pre_reported=2_558)
# ... and with dynamic_red=False, window_steps=16 (persistent or per-root)
WINDOW_EXPECT = dict(cliques=807_367, calls=1_905_948, branches=1_903_641,
                     sum_px=5_534_728, pre_reported=2_558)
# The reference's scheduling stats of run(..., engine="persistent") on
# scale 12: with the defaults, and with dynamic_red=False, window_steps=16
PERSISTENT_STATS = dict(iters=22_700, live_iters=1_085_843,
                        lane_iters=1_350_245, steals=11_564, entry_terms=474,
                        window_spills=0, window_hits=0, spans=3)
WINDOW_STATS = dict(iters=5_071, live_iters=3_008_993, lane_iters=4_758_576,
                    steals=16_737, entry_terms=0, window_spills=117_930,
                    window_hits=139_058, spans=3)
# The reference's pivot-backend rows of BENCH_branching.json
# (benchmarks/table3_ablation.py --branching: bucket_sizes (32, 64, 128,
# 256)), as (cliques, calls, branches, sum_px).
BRANCHING_EXPECT = {
    ("ba_web", True): (13725, 339, 64, 1550),
    ("ba_web", False): (13725, 1248, 973, 2396),
    ("caveman_comm", True): (488, 538, 111, 2004),
    ("caveman_comm", False): (488, 1299, 872, 3703),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 21, inner: int = 10):
    """(device ms, call ms) per call of `fn`, after a warm-up.

    Device ms: the median over `reps` CUDA-event windows of `inner` calls.
    Each window is queued behind a `torch.cuda._sleep` that outlasts the
    host's enqueueing of it, so the events time the calls back to back on
    the card rather than the host's launch rate. Call ms: host wall time
    per call with a sync at the end, which is what a caller that launches
    one call at a time waits for."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # 3x the window's host time at up to 2 GHz SM clock, plus 0.5 ms
    cycles = int(3 * host_s * 2.0e9) + 1_000_000
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times), 1e3 * host_s / inner


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def kernel_cost(name, rows, mask):
    """(bytes, operations) the function must move and do on these inputs:
    each input read once, each output written once."""
    R, K, W = (1,) * (3 - rows.dim()) + tuple(rows.shape)
    words = R * K * W
    if name == "and_popcount_rows":
        nbytes = 4 * (words + R * W + R * K)
        ops = 3 * words                       # and, popcount, add
    elif name == "and_popcount_argmax":
        nbytes = 4 * (words + R * W) + R * K + 8 * R
        ops = 3 * words + 2 * R * K           # + select, compare
    else:
        nbytes = 4 * (words + 3 * R * W + 2 * R * W + 2 * R * K)
        ops = 6 * words + 2 * R * W           # + lowest bit, partner sum
    return nbytes, ops


def run_kernel(name, rows, mask, extra, impl):
    if name == "and_popcount_rows":
        return (impl.and_popcount_rows(rows, mask),)
    if name == "and_popcount_argmax":
        return impl.and_popcount_argmax(rows, mask, extra[0])
    return impl.frame_step(rows, mask, extra[0], extra[1])


def exact(name, got, want, shape) -> int:
    """Largest difference between a kernel's outputs and its plain
    version's on the same CUDA tensors, which must be 0."""
    import torch
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    check(err == 0, f"{name} differs from its plain version by {err} at "
          f"{tuple(shape)}")
    return err


def compare(name, rows, mask, extra, timed=False):
    """Kernel vs plain version on the same CUDA tensors. Tolerance 0:
    every output is an integer or a bit pattern, so they must be equal."""
    from repro_torch.kernels.bitset_ops import ops, ref
    err = exact(name, run_kernel(name, rows, mask, extra, ops),
                run_kernel(name, rows, mask, extra, ref), rows.shape)
    out = dict(name=name, shape=list(rows.shape), max_abs_err=err,
               tolerance=0)
    if timed:
        nbytes, nops = kernel_cost(name, rows, mask)
        ms, call_ms = cuda_ms(lambda: run_kernel(name, rows, mask, extra,
                                                 ops))
        plain_ms, plain_call_ms = cuda_ms(
            lambda: run_kernel(name, rows, mask, extra, ref))
        out.update(
            ms=ms, plain_ms=plain_ms, call_ms=call_ms,
            plain_call_ms=plain_call_ms,
            bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S, nops / OPS_PER_S),
            bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                      >= nops / OPS_PER_S else "operations"),
            library_ms=None)
    return out


def edge_cases(dev):
    """Random words with the top bit set often, K off the 256-thread
    block, W = 1/4/32, tied scores, all-invalid roots."""
    import numpy as np
    import torch
    from repro_torch.kernels.bitset_ops import ops
    rng = np.random.default_rng(0)

    def words(*shape):
        w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
        w[rng.random(shape) < 0.1] |= np.uint32(0x80000000)
        w[rng.random(shape) < 0.05] = np.uint32(0xFFFFFFFF)
        w[rng.random(shape) < 0.05] = 0
        return torch.from_numpy(w.view(np.int32)).to(dev)

    n = 0
    for r, k, w in [(1, 1, 1), (3, 255, 4), (2, 257, 32), (5, 1000, 1),
                    (4, 513, 4), (1, 2048, 2)]:
        rows, mask, xp, wrow = words(r, k, w), words(r, w), words(r, w), \
            words(r, w)
        valid = torch.from_numpy(rng.random((r, k)) < 0.6).to(dev)
        valid[0] = False                                 # all-invalid root
        tied = rows.clone()
        tied[:, :] = rows[:, :1]                         # every score tied
        tvalid = torch.from_numpy(rng.random((r, k)) < 0.5).to(dev)
        for name, rr, extra in [
                ("and_popcount_rows", rows, ()),
                ("and_popcount_argmax", rows, (valid,)),
                ("and_popcount_argmax", tied, (tvalid,)),
                ("frame_step", rows, (xp, wrow))]:
            compare(name, rr, mask, extra)
            n += 1
        idx, best = ops.and_popcount_argmax(rows, mask, valid)
        check(int(idx[0]) == 0 and int(best[0]) == -1,
              "all-invalid root must give (0, -1)")
    return n


def bucket_cases(prep, dev):
    """Each Graph500 bucket's own rows, with masks drawn from its p0 — the
    shapes the slice's main path hands every kernel."""
    import numpy as np
    import torch
    from repro_torch.core.engine.loop import bucket_tensors
    rng = np.random.default_rng(1)
    lines = []
    for b in prep.buckets:
        a, p0, x_rows, x_alive0, _ = bucket_tensors(
            b.a, b.p0, b.x_rows, b.x_alive0, b.rsz0, dev)
        keep = torch.from_numpy(
            rng.integers(0, 2**32, p0.shape, dtype=np.uint64)
            .astype(np.uint32).view(np.int32)).to(dev)
        P = p0 & keep
        Xp = p0 & ~keep
        wrow = a[:, 0].contiguous()
        not_x = ~x_rows
        for name, rows, mask, extra in [
                ("frame_step", a, P, (Xp, wrow)),
                ("and_popcount_rows", a, P, ()),
                ("and_popcount_rows", not_x, P, ()),
                ("and_popcount_argmax", x_rows, P, (x_alive0,))]:
            line = compare(name, rows, mask, extra, timed=True)
            line.update(phase="kernels", bucket_u=b.u_pad, bucket_xc=b.x_pad,
                        roots=b.num_roots)
            emit(line)
            lines.append(line)
    return lines


def window_cost(args, ctl):
    """(bytes, operations) of one window walk on these inputs: each input
    read once and each output written once; per BRANCHING step (this
    run's `calls`, a pop does no sweep) one AND+popcount+add per word of
    the U adjacency rows and, twice, of the XC X0 rows."""
    a, x_rows = args[0], args[1]
    U, W = a.shape[-2:]
    XC = x_rows.shape[-2]
    nbytes = 4 * (a.numel() + x_rows.numel() + args[2].numel()
                  + 2 * sum(t.numel() for t in args[3:8]) + args[8].numel()
                  + ctl.numel())
    return nbytes, 3 * int(ctl[..., 1].sum()) * (U + 2 * XC) * W


def compare_window(name, args, steps, timed=False):
    """Window kernel vs its plain version on the same CUDA tensors.
    Tolerance 0: windows are bit patterns and ctl holds integers."""
    from repro_torch.kernels.bitset_ops import ops, ref

    def call(impl):
        return getattr(impl, name)(*args, steps=steps)
    got = call(ops)
    err = exact(name, got, call(ref), args[3].shape)
    ctl = got[-1]
    out = dict(name=name, shape=list(args[0].shape), xc=args[1].shape[-2],
               window=list(args[3].shape), steps=steps, max_abs_err=err,
               tolerance=0, steps_done=int(ctl[..., 5].sum()),
               calls=int(ctl[..., 1].sum()))
    if timed:
        nbytes, nops = window_cost(args, ctl)
        ms, call_ms = cuda_ms(lambda: call(ops))
        plain_ms, plain_call_ms = cuda_ms(lambda: call(ref), reps=5,
                                          inner=3)
        out.update(
            ms=ms, plain_ms=plain_ms, call_ms=call_ms,
            plain_call_ms=plain_call_ms,
            bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S, nops / OPS_PER_S),
            bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                      >= nops / OPS_PER_S else "operations"),
            library_ms=None)
    return out


def window_inputs(dev, L, U, XC, W, edge, seed, T=8):
    """Seeded windows shaped like a walk's (B ⊆ P, Xp and Rb disjoint
    from P) with one edge case on lane 0."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def bits(shape, density):
        b = rng.random(shape + (32,)) < density
        return np.packbits(b, axis=-1, bitorder="little").view(
            np.uint32).reshape(shape)

    valid = np.packbits(np.arange(32 * W) < U, bitorder="little").view(
        np.uint32)
    a = bits((L, U, W), 0.45) & valid
    x_rows = bits((L, XC, W), 0.5) & valid
    alive0 = (rng.random((L, XC)) < 0.8).astype(np.int32)
    P = bits((L, T, W), 0.5) & valid
    B = P & bits((L, T, W), 0.6)
    Xp = bits((L, T, W), 0.15) & ~P & valid
    Rb = bits((L, T, W), 0.03) & ~P & ~Xp & valid
    rsz = rng.integers(1, 6, (L, T)).astype(np.int32)
    dloc = rng.integers(0, T // 2 + 1, L).astype(np.int32)
    if edge == "dead":
        dloc[0] = -1
    elif edge == "blocked":
        dloc[0] = T - 1
        B[0, T - 1] |= P[0, T - 1] | np.uint32(1)
    elif edge == "empty_b":
        B[0] = 0
        dloc[0] = T - 1
    return [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)
            for x in (a, x_rows, alive0, P, B, Xp, Rb, rsz, dloc)]


def window_edge_cases(dev):
    """The window walk, both forms, at its edge cases: a dead lane,
    dloc = T−1 with branches left, an empty B at U = 32 (the branch
    vertex clamps), W = 3, XC = 1, K = 1 and K = 64."""
    n = 0
    for i, (L, U, XC, W, edge, steps) in enumerate([
            (3, 64, 40, 2, "dead", 16), (3, 64, 40, 2, "blocked", 16),
            (3, 32, 64, 1, "empty_b", 16), (4, 96, 50, 3, "none", 16),
            (4, 64, 1, 2, "none", 16), (4, 64, 40, 2, "none", 1),
            (4, 64, 40, 2, "none", 64)]):
        args = window_inputs(dev, L, U, XC, W, edge, seed=i)
        compare_window("dfs_step_window_lanes", args, steps)
        compare_window("dfs_step_window", args, steps)
        compare_window("dfs_step_window", [t[1] for t in args], steps)
        n += 3
    return n


def launched_windows(name, drive):
    """The inputs of every launch of `ops.<name>` while `drive()` runs
    the engine, cloned as the engine handed them to the kernel."""
    from repro_torch.kernels.bitset_ops import ops
    real = getattr(ops, name)
    seen = []

    def record(*args, steps):
        seen.append(tuple(t.clone() for t in args))
        return real(*args, steps=steps)
    setattr(ops, name, record)
    try:
        drive()
    finally:
        setattr(ops, name, real)
    return seen


def window_slice_cases(dev, prep):
    """The window walk on each Graph500 bucket's real windows: those of
    the launch with the most live lanes (dloc >= 0; the later on a tie)
    among the first four trips of the fused-window persistent engine
    (lane form) and of the windowed per-root walk (per-root form)."""
    from repro_torch.core.engine import frames as fr
    from repro_torch.core.engine import loop
    from repro_torch.core.engine.loop import bucket_tensors
    cfg = fr.EngineConfig(dynamic_red=False, window_steps=16, max_iters=4)
    lines = []
    for b in prep.buckets:
        args = bucket_tensors(b.a, b.p0, b.x_rows, b.x_alive0, b.rsz0, dev)
        lanes = min(64, b.num_roots)
        for name, drive in (
                ("dfs_step_window_lanes", lambda: loop.run_bucket_persistent(
                    *args, cfg, lanes=lanes)),
                ("dfs_step_window", lambda: loop.run_bucket(
                    *args, fr.EngineConfig(dynamic_red=False,
                                           window_steps=16,
                                           max_iters=64)))):
            seen = launched_windows(name, drive)[:4]
            live = [int((w[-1] >= 0).sum()) for w in seen]
            wargs = seen[max(range(len(seen)), key=lambda i: (live[i], i))]
            line = compare_window(name, wargs, 16, timed=True)
            line.update(phase="kernels", bucket_u=b.u_pad, bucket_xc=b.x_pad,
                        roots=b.num_roots, live=max(live))
            emit(line)
            lines.append(line)
    return lines

# --------------------------------------------------------------------------
# phases 3-5
# --------------------------------------------------------------------------

def small_graphs(dev):
    from repro_torch.core import oracle
    from repro_torch.core.engine import run
    from repro_torch.graph import generators as gen
    graphs = {
        "ba_web": gen.barabasi_albert(3000, 5, seed=3),
        "caveman_comm": gen.caveman(60, 8, 0.12, seed=7),
        "er_300": gen.erdos_renyi(300, 0.1, seed=3),
        "moon_moser_6": gen.moon_moser(6),
    }
    for name, g in graphs.items():
        truth = set(oracle.bk_pivot(g))
        check(truth == set(oracle.rmce(g)), f"{name}: oracles disagree")
        for dr in (True, False):
            t0 = time.perf_counter()
            res = run(g, dynamic_red=dr, enumerate_cliques=True,
                      bucket_sizes=(32, 64, 128, 256), device=dev)
            secs = time.perf_counter() - t0
            got = (res.cliques, res.calls, res.branches, res.sum_px)
            check(not res.overflow and not res.iters_exhausted,
                  f"{name}: overflow/truncated")
            check(len(res.enumerated) == res.cliques
                  and set(res.enumerated) == truth,
                  f"{name} dynamic_red={dr}: clique set differs from oracle")
            want = BRANCHING_EXPECT.get((name, dr))
            check(want is None or got == want,
                  f"{name} dynamic_red={dr}: {got} != reference {want}")
            emit(dict(phase="small_graph", graph=name, dynamic_red=dr,
                      cliques=res.cliques, calls=res.calls,
                      branches=res.branches, sum_px=res.sum_px,
                      oracle_cliques=len(truth),
                      reference_counters=want, seconds=secs))


def device_peel(dev, graphs):
    import numpy as np
    import torch
    from repro_torch.core.global_reduction import (_peel_rounds_np,
                                                   global_reduce_torch,
                                                   peel_low_degree)
    for name, g in graphs.items():
        src = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees())
        t0 = time.perf_counter()
        av, _ = global_reduce_torch(
            torch.from_numpy(src).to(dev),
            torch.from_numpy(g.indices.astype(np.int64)).to(dev), g.n)
        alive = av.cpu().numpy()
        secs = time.perf_counter() - t0
        check(np.array_equal(alive, _peel_rounds_np(g)),
              f"{name}: device peel alive mask differs from the host mirror")
        g_dev, rep_dev = peel_low_degree(g, use_device=True, device=dev)
        g_host, rep_host = peel_low_degree(g, use_device=False)
        check(np.array_equal(g_dev.indptr, g_host.indptr)
              and np.array_equal(g_dev.indices, g_host.indices)
              and list(rep_dev) == list(rep_host),
              f"{name}: device peel residual/reports differ")
        emit(dict(phase="device_peel", graph=name, n=g.n, m=g.m,
                  peeled=int((~alive).sum()), reports=len(rep_dev),
                  default_path_device=(g.n + 2 * g.m) >= 200_000,
                  seconds=secs))


def drive(dev, g, phase, graph, expect, kernels, stats=None, **kw):
    """One path of the port: `run(g, **kw)` on the card with the kernels'
    launch counts set to 0 just before and read just after; its counters
    (and, given, its scheduling stats) against the reference's, and every
    kernel of the path launched."""
    from repro_torch.core.engine import run
    from repro_torch.kernels.bitset_ops import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run(g, device=dev, **kw)
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    got = dict(cliques=res.cliques, calls=res.calls, branches=res.branches,
               sum_px=res.sum_px, pre_reported=res.pre_reported)
    line = dict(phase=phase, graph=graph, n=g.n, m=g.m, run_kwargs=kw, **got,
                iters_exhausted=res.iters_exhausted,
                prep_seconds=res.stats["prep_seconds"], seconds=secs,
                launches=launches)
    st = res.stats
    if "iters" in st:                         # the persistent lanes
        line.update({k: st[k] for k in PERSISTENT_STATS},
                    span_seconds=st["span_seconds"],
                    ms_per_trip=1e3 * sum(st["span_seconds"])
                    / max(st["iters"], 1),
                    occupancy=st["live_iters"] / max(st["lane_iters"], 1))
    else:
        line["buckets"] = [
            dict(b, seconds_per_step=b["seconds"] / max(b["steps"], 1))
            for b in st["buckets"]]
    emit(line)
    check(got == expect, f"{phase} counters {got} != {expect}")
    check(not res.iters_exhausted, f"{phase} truncated")
    for k, v in (stats or {}).items():
        check(st[k] == v, f"{phase} stat {k}: {st[k]} != reference {v}")
    for name in kernels:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {phase} path")
    return launches


def the_slice(dev, g):
    return drive(dev, g, "slice", "kron:scale=11,ef=16,seed=0",
                 SLICE11_EXPECT, ("frame_step", "and_popcount_rows",
                                  "and_popcount_argmax"))


def persistent_paths(dev, g):
    """The lane engine, its fused window walk, the per-root window walk
    and `auto` on the scale-12 graph; returns each path's launches."""
    graph = "kron:scale=12,ef=16,seed=0"
    row_kernels = ("frame_step", "and_popcount_rows", "and_popcount_argmax")
    out = {}
    out["persistent"] = drive(dev, g, "persistent", graph, SLICE_EXPECT,
                              row_kernels, PERSISTENT_STATS,
                              engine="persistent")
    out["persistent_window"] = drive(
        dev, g, "persistent_window", graph, WINDOW_EXPECT,
        ("dfs_step_window_lanes",), WINDOW_STATS, engine="persistent",
        dynamic_red=False, window_steps=16)
    out["perroot_window"] = drive(
        dev, g, "perroot_window", graph, WINDOW_EXPECT, ("dfs_step_window",),
        dynamic_red=False, window_steps=16)
    out["auto"] = drive(dev, g, "auto", graph, SLICE_EXPECT, row_kernels,
                        engine="auto")
    return out


def device_profile(run_once):
    """Where the time of `run_once()` goes: its wall time with the
    profiler off (after a warm-up) against the device's kernel time
    (torch.profiler's CUDA kernel events, profiler on). Returns (output,
    wall s, profiled wall s, device busy s, kernel count); the idle share
    is the part of the unprofiled wall time in which no kernel runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run_once()                                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_once()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    return out, plain_wall, wall, busy, len(kernels)


def step_profile(dev, prep, u=64, steps=64):
    """A batched per-root step of one slice bucket, over `steps` steps."""
    from repro_torch.core.engine import frames as fr
    from repro_torch.core.engine.loop import bucket_tensors, run_bucket
    b = next(b for b in prep.buckets if b.u_pad == u)
    args = bucket_tensors(b.a, b.p0, b.x_rows, b.x_alive0, b.rsz0, dev)
    cfg = fr.EngineConfig(max_iters=steps)
    out, plain_wall, wall, busy, n_k = device_profile(
        lambda: run_bucket(*args, cfg))
    n = out["steps"]
    emit(dict(phase="step_profile", bucket_u=u, roots=b.num_roots, steps=n,
              ms_per_step=1e3 * plain_wall / n,
              profiled_ms_per_step=1e3 * wall / n,
              device_busy_ms_per_step=1e3 * busy / n,
              kernels_per_step=n_k / n,
              device_idle_share=1.0 - busy / plain_wall))


def trip_profile(dev, prep, u=64, trips=64):
    """`step_profile` for the three new paths on the U=64 bucket: the
    first `trips` trips of the persistent lanes (min(64, roots) lanes)
    with the default and the fused-window config, and of the per-root
    window walk (cut at 16·trips frame-steps per root)."""
    from repro_torch.core.engine import frames as fr
    from repro_torch.core.engine.loop import (bucket_tensors, run_bucket,
                                              run_bucket_persistent)
    b = next(b for b in prep.buckets if b.u_pad == u)
    args = bucket_tensors(b.a, b.p0, b.x_rows, b.x_alive0, b.rsz0, dev)
    lanes = min(64, b.num_roots)
    win = dict(dynamic_red=False, window_steps=16)
    for path, run_once in (
            ("persistent", lambda: run_bucket_persistent(
                *args, fr.EngineConfig(max_iters=trips), lanes=lanes)),
            ("persistent_window", lambda: run_bucket_persistent(
                *args, fr.EngineConfig(max_iters=trips, **win),
                lanes=lanes)),
            ("perroot_window", lambda: run_bucket(
                *args, fr.EngineConfig(max_iters=16 * trips, **win)))):
        out, plain_wall, wall, busy, n_k = device_profile(run_once)
        n = out["iters"] if path != "perroot_window" else out["steps"]
        emit(dict(phase="trip_profile", path=path, bucket_u=u,
                  roots=b.num_roots, lanes=lanes, trips=n,
                  ms_per_trip=1e3 * plain_wall / n,
                  profiled_ms_per_trip=1e3 * wall / n,
                  device_busy_ms_per_trip=1e3 * busy / n,
                  kernels_per_trip=n_k / n,
                  device_idle_share=1.0 - busy / plain_wall))

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.engine.prepare import prepare
    from repro_torch.graph.generators import kronecker
    from repro_torch.kernels.bitset_ops import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name_power = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    emit(dict(phase="device", name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(),
              driver=nvidia_smi("driver_version"), name_power=name_power,
              torch=torch.__version__, cuda=torch.version.cuda,
              library=str(lib.relative_to(ROOT)),
              nvcc_seconds=build.build_seconds,
              build_and_load_seconds=time.perf_counter() - t0))

    n_edge = edge_cases(dev) + window_edge_cases(dev)
    g12 = kronecker(12, 16, seed=0)
    prep = prepare(g12, device=dev)
    kernel_lines = bucket_cases(prep, dev) + window_slice_cases(dev, prep)
    emit(dict(phase="kernels_done", edge_cases=n_edge,
              bucket_cases=len(kernel_lines),
              seconds=time.perf_counter() - t_start))

    small_graphs(dev)
    device_peel(dev, {"kron:scale=12,ef=16": g12,
                      "kron:scale=14,ef=16": kronecker(14, 16, seed=0)})
    launches = the_slice(dev, kronecker(11, 16, seed=0))
    step_profile(dev, prep)
    paths = persistent_paths(dev, g12)
    trip_profile(dev, prep)

    # kernel table: each kernel at the bucket shape the main path launches
    # it most often (the U=64 bucket: most steps and trips), the row
    # kernels in their adjacency-row form; launches over the path that
    # carries the kernel (the per-root slice for the row kernels, the
    # fused-window runs for the window walks)
    launches["dfs_step_window_lanes"] = \
        paths["persistent_window"]["dfs_step_window_lanes"]
    launches["dfs_step_window"] = paths["perroot_window"]["dfs_step_window"]
    us = {b.u_pad for b in prep.buckets}
    main_u = 64 if 64 in us else prep.buckets[0].u_pad
    table = []
    for name in REPLACES:
        line = next(ln for ln in kernel_lines
                    if ln["name"] == name and ln["bucket_u"] == main_u)
        table.append(dict(
            name=name, route="cuda", source=SOURCE,
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(ln["max_abs_err"] for ln in kernel_lines
                            if ln["name"] == name),
            ms=line["ms"], plain_ms=line["plain_ms"],
            bound_ms=line["bound_ms"], bound_by=line["bound_by"],
            library_ms=None, shape=line["shape"]))
    emit(dict(phase="done", seconds=time.perf_counter() - t_start,
              path_launches=paths,
              note="library_ms is null: no single PyTorch call computes "
                   "AND+popcount over bit words, nor a BK walk"))
    print(name_power, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
