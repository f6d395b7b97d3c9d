#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the MCE engine, the
substrate kernels, the serving and training paths of the substrate
models, the training path of the GNN family, and the sharding rules,
the pipeline and the dry-run cells on a world of one.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the Hopper kernels of every kernel package from
`src/repro_torch/kernels/<name>/csrc/` (one nvcc per source, all started
together) and then, printing one JSON line per phase:

1. device: the card, its software versions and power limit, and each
   library's build (nvcc seconds);
2. kernels: each bitset CUDA kernel held bit-exact against its plain
   PyTorch version on the same CUDA tensors, at edge shapes and at the
   shapes of the Graph500 scale-12 buckets (the row kernels on A and on
   the X0 rows; the Lemma-8 pass `lemma8_reduce` and the pivot select
   `pivot_select`, the engine's entry points on them, and the DFS step's
   branch half `branch_step` (on `frame_step`, the stack compared after
   its in-place write) and the rcd maximality test `rcd_dominated` (on
   `and_popcount_many`), at each bucket's roots and the lanes' 64, on
   random operands and on the U = 64 bucket's own, recorded from the
   engine's first launches, each line with its roots that have a full
   vertex, branch or are blocked; the hybrid census over A
   stacked on the X0 rows, through both its entry points, `clique_counts`
   and `hybrid_census`, at each bucket's roots and at the hybrid lanes'
   64, timed at each block size too; the rcd sweep of P against ~X0 rows
   stacked on ~A; the window walk on the windows the persistent and
   per-root engines launch it with), with CUDA-event times; each
   real-window line of the window walk with its launch geometry (warps per
   lane G, lanes per block, staged rows, pivot key) and its time at each G
   and at 0, 1 and 16 steps;
2b. substrate_kernels: `has_common_neighbor`, `embedding_bag_sum`,
   `dense_spmm` and `flash_attention` against their plain versions at the
   reference tests' edge shapes (for `dense_spmm`, each staging path, named
   in its line, and bfloat16 inputs) and at full width (scale 12's edges,
   the two-tower bags, the molecule cell, where `dense_spmm` must stage
   whole graphs by bulk copy, qwen3-14b's attention at train_4k),
   each entry point (`edge_common_neighbor`, `embedding_bag`,
   `densify_edges` + `dense_spmm`, `mha`) driven once with its launch
   count read, and the triangle test against the host Lemma-4 mask on
   scale 12's rows gathered beforehand and through `edge_common_neighbor`
   at scales 12 and 14 and on a triangle-poor bipartite graph with hubs
   (timed back to back and with L2 flushed); with CUDA-event (profiler,
   for that entry point) times beside the bound and one PyTorch call.
   Attention in bf16 at D = 64/128 takes the tensor-core kernel (`mha`
   at train_4k must launch it), bf16 at any other D and float32 the
   CUDA-core kernel; at train_4k the CUDA-core kernel is held to the
   plain version and timed beside it, and SDPA is held to the plain
   version as information;
3. small graphs: `run(g)` on the card with enumeration for the 'pivot',
   'hybrid' and 'rcd' backends, against the port's oracles (exact clique
   sets) and the reference's pivot and hybrid counters;
4. device peel: the degree-0/1 peel on the card against its host mirror;
5. the scale-11 paths on `kronecker(11, 16, seed=0)`: the per-root slice
   (`run()` defaults), the pivot lanes (`engine="persistent"`),
   `engine="auto"`, `backend="hybrid"` and `backend="rcd"` per root; and
   the rcd lanes on `kronecker(10, 16, seed=0)`; each against the
   reference's counters and, for the lanes, its scheduling stats;
6. the scale-12 paths on `kronecker(12, 16, seed=0)`: the hybrid lanes
   (`backend="hybrid", engine="persistent"`), the lanes' fused window walk
   (`window_steps=16`, dynamic reduction off) and the per-root window
   walk, against the reference's counters and stats;
7. step and trip profiles: where a per-root step's (pivot and rcd) and
   a persistent trip's time goes (host against device);
8. driver: `DistributedMCE(kronecker(11, 16, seed=0), chunk=512)` with
   mce_run's other defaults on one rank, against run()'s counters and the
   reference driver's occupancy pair, with its chunk and overlap stats
   (scale 11, cut from 12 for the time limit);
9. service: one `MCEService` on the scale-11 graph and three queries
   (pivot cold, hybrid and pivot with reuse_degrees=False from the
   cached buckets, which must pack nothing) against the reference
   service's counters and per-query stats;
10. serve: `launch/serve.py` at full width, each request after a warm-up
   one: `serve_lm("qwen3-14b", smoke=False)`'s path (40 layers, bfloat16,
   4 prompts of 2,048 tokens, 32 new tokens), whose prefill must launch
   the tensor-core flash kernel once per layer, the kernel then held
   against its plain version on the prefill's own first-layer q, k, v;
   qwen3-14b's build() at 2 layers on the card against the same weights
   on the CPU (prefill and 4 decode steps under the bf16 check); and
   `serve_recsys(smoke=False)`'s path (25.8 GB of tables, 512 users, 1e6
   candidates), whose bags must launch `embedding_bag_sum`, the
   retrieval's tag bag held against the plain version on its own
   operands, and the smoke config on the card against the CPU;
11. train: the training path (float32 master weights, AdamW,
   `data.TokenStream`, `lm_steps.make_train_step`,
   `recsys.make_train_step`, `launch/train.train`): qwen3-14b at build()
   widths cut to 2 layers, one sequence of 4,096 tokens, 3 steps, each
   of which must launch the tensor-core flash forward twice a layer
   (forward and remat's recompute) and the three backward kernels once a
   layer, one more backward reaching every parameter, the backward
   kernels then held against the plain backward on layer 0's own q, k,
   v; a narrow two-layer qwen3 with d_head 128 on the card against the
   CPU (every gradient under relative norm 2e-2); two-tower-retrieval at
   build() widths with 2^22 users and items and a batch of 16,384, 3
   steps, each launching the bag forward and backward kernels twice, the
   backward kernel then held against the plain version on a step's own
   history-bag operands; and `train()` at smoke for both archs, killed at
   step 6 and resumed from step 4 to the uninterrupted run's parameters
   within 1e-5. Every line carries the card's name and power limit;
12. gnn: the GNN family's training path (`models/gnn.py`,
   `models/gnn_steps.py`, `launch/train.train`): `train(arch,
   smoke=False, steps=3)` for MeshGraphNet, SchNet, DimeNet and MACE at
   build() widths on the launcher's batches, one more backward reaching
   every parameter; SchNet, DimeNet (203,668 triplets) and MACE at
   build() widths on the reference's molecule cell (128 molecules of 30
   atoms) and MeshGraphNet on the launcher's 4,096-node graph, 3 steps
   each with s a step, peak bytes and launches a step, and a profiled
   fourth step (busy ms, idle share, device ms by group: matrix
   products, `index_add_` / scatter, gathers, elementwise, AdamW); each
   arch's smoke config on the card against the CPU (forward, loss, every
   gradient; no TF32); `train()` for MACE killed at step 6 and resumed
   from step 4 to the uninterrupted run's parameters within 1e-5. This
   path launches none of the kernel table's thirteen kernels (its
   aggregations are PyTorch's `index_add_`, as the reference's are XLA's
   scatter), and the phase fails if it launches one. Every line carries
   the card's name and power limit;
13. sharding: the sharding rules and launch tools on a world of one
   (`launch/mesh.make_host_mesh`: this process, NCCL, a FileStore;
   a (1, 1) ("data", "model") mesh on it): (a) qwen3-14b at build()
   widths cut to 2 layers, 3 steps of `lm_steps.make_train_step` on one
   4,096-token sequence a step, unsharded and then with the parameters,
   the AdamW state and the tokens laid out by `sharding.lm_sharding`
   under each `shard_hints` variant (heads over "model", then context
   parallelism): losses and every gradient bit for bit and the same flash
   launches a step as the unsharded steps, with s a step, the model FLOPs
   (6·N·D) and the MFU share of 989 TFLOP/s; (b)
   `models.pipeline.make_pipeline_train_step` with one stage and 4
   microbatches of 1,024 tokens: the pipelined logits against the plain
   forward's under the bf16 check, the flash launches (4 a layer a
   forward, 12 a layer a backward); (c) `launch/cells.build_cell` for all
   40 runnable cells of `all_cells()` on meta: the card's allocated bytes
   must not move; (d) the rmce `web_sparse` cell's function on scale 11's
   U = 64 bucket (padded to the cell's 1,024 roots) against
   `run_bucket`'s counters, launching the row kernels;
14. lint: the port's analyzer (`python -m repro_torch.analysis
   src/repro_torch --strict`, a process that imports neither torch nor
   JAX) must find nothing;
15. dryrun: one cell a family (`qwen3-14b` `decode_32k`, `schnet`
   `full_graph_sm`, `two-tower-retrieval` `serve_p99`, `rmce`
   `web_sparse`) and DimeNet's and MACE's `molecule` through
   `launch/dryrun.run_cell` on a fake world of 512 ranks (2×16×16), each
   in a process of its own, all at once, on meta, no card: each must come
   out `ok`, with its per-rank terms and seconds, and the qwen3-14b and
   SchNet cells with the sandbox's terms under torch 2.13
   (`DRYRUN_EXPECT`: matrix-product flops within 1 %, all flops within
   5 %);
16. gloo: on 4 gloo ranks on the CPUs, a (2, 2) ("data", "model") mesh,
   DimeNet's and MACE's smoke steps with edges, triplets and atoms split
   over "data" against the unsharded step (loss and every gradient at
   relative norm 1e-5), and 20 qwen3-14b decode steps into a cache laid
   out by `cache_spec` (slots split over "model") against the plain
   decode. The last three phases launch no kernel.

Each path runs with the kernels' launch counts set to 0 just before it
and read just after, and fails if a kernel of that path was not launched
(the gnn phase: if any was).

Every check raises on failure (exit code 1). The last two lines are the
kernel table (the eleven kernels that replace the TPU's, launches summed
over every path; `serve_launches` and `train_launches` on rows 9 and 11,
the launches of the serve phase's measured requests and of the train
phase's measured steps, `sharding_launches` on rows 11 and 12 those of
the sharding phase's sharded and pipelined steps; then the two backward
kernels, launches in the train phase's measured steps) as JSON and `{"ok": true, "device":
{...}}`. It imports nothing of JAX or
of the reference package `repro`.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
# The data sheet's float32 rate off the tensor cores, 67 TFLOP/s: the
# operations bound of the float32 kernels (dense_spmm, the bag sums), and
# the stand-in for integer ALU work (AND, popcount, add, compare), which
# has no row in the peak table. bfloat16 attention uses BF16_OPS_PER_S.
OPS_PER_S = 67e12
SOURCE = "src/repro_torch/kernels/bitset_ops/csrc/bitset_ops.cu"
REPLACES = {
    "frame_step": "src/repro/kernels/bitset_ops/kernel.py:167",
    "and_popcount_rows": "src/repro/kernels/bitset_ops/kernel.py:67",
    "and_popcount_argmax": "src/repro/kernels/bitset_ops/kernel.py:103",
    "clique_counts": "src/repro/kernels/bitset_ops/kernel.py:225",
    "and_popcount_many": "src/repro/kernels/bitset_ops/kernel.py:277",
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
# On scale 11, engine="persistent" and engine="auto" give the same
# counters; the lanes' scheduling stats of engine="persistent" (r.stats):
#   r = run(kronecker(11, 16, seed=0), engine="persistent")
PERSISTENT11_STATS = dict(iters=4_001, live_iters=167_737,
                          lane_iters=256_064, steals=2_557, entry_terms=219,
                          window_spills=0, window_hits=0, spans=2)
# The 'hybrid' and 'rcd' backends on scale 11 (dynamic reduction on), per
# root and on the persistent lanes:
#   r = run(kronecker(11, 16, seed=0), backend="hybrid"); print(r.cliques,
#     r.calls, r.branches, r.sum_px, r.pre_reported)
HYBRID11_EXPECT = dict(cliques=122_478, calls=113_525, branches=112_296,
                       sum_px=687_144, pre_reported=1_031)
#   the same with backend="rcd"
RCD11_EXPECT = dict(cliques=122_478, calls=129_425, branches=128_196,
                    sum_px=862_088, pre_reported=1_031)
# The rcd lanes run on scale 10: they never steal, so their drain tail is
# long (10,052 trips on scale 11), and the whole script stays nearer its
# 10-minute target. Counters and stats of
#   r = run(kronecker(10, 16, seed=0), backend="rcd", engine="persistent");
#   print(r.cliques, r.calls, r.branches, r.sum_px, r.pre_reported, r.stats)
RCD10_EXPECT = dict(cliques=24_462, calls=25_421, branches=24_758,
                    sum_px=174_094, pre_reported=408)
RCD10_STATS = dict(iters=2_017, live_iters=34_532, lane_iters=100_136,
                   steals=0, entry_terms=144, window_spills=0, window_hits=0,
                   spans=2)
# kronecker(12, 16, seed=0) with dynamic reduction on: the per-root
# defaults, engine="persistent", engine="auto" and the 'hybrid' lanes give
# the same counters
SLICE_EXPECT = dict(cliques=807_367, calls=733_591, branches=731_284,
                    sum_px=4_290_765, pre_reported=2_558)
# ... and with dynamic_red=False, window_steps=16 (persistent or per-root)
WINDOW_EXPECT = dict(cliques=807_367, calls=1_905_948, branches=1_903_641,
                     sum_px=5_534_728, pre_reported=2_558)
# The reference's scheduling stats on scale 12 of
#   r = run(kronecker(12, 16, seed=0), backend="hybrid",
#           engine="persistent"); print(r.stats)
# (the pivot counters, SLICE_EXPECT, on another schedule than the pivot
# lanes': 23,646 trips against 22,700), and of engine="persistent" with
# dynamic_red=False, window_steps=16
HYBRID_STATS = dict(iters=23_646, live_iters=1_083_300,
                    lane_iters=1_404_253, steals=12_981, entry_terms=490,
                    window_spills=0, window_hits=0, spans=3)
WINDOW_STATS = dict(iters=5_071, live_iters=3_008_993, lane_iters=4_758_576,
                    steals=16_737, entry_terms=0, window_spills=117_930,
                    window_hits=139_058, spans=3)
# The driver and the service, with mce_run's defaults (streamed buckets of
# 1,024 roots, 512 roots a chunk, per root, pivot) on one shard, both on
# scale 11. Their counters are run()'s (SLICE11_EXPECT and
# HYBRID11_EXPECT); the reference service's per-query stats of
#   svc = MCEService(kronecker(11, 16, seed=0), chunk=512)
#   for cfg in (EngineConfig(), EngineConfig(backend="hybrid"),
#               EngineConfig(reuse_degrees=False)):
#       r = svc.query(cfg); print(r.cliques, r.calls, r.branches,
#                                 r.sum_px, r.pre_reported, r.stats)
# (repro.launch.mce_service): the third query, the paper's three sweeps
# (the pivot select sweeps A itself), finds the default's counters. The
# first query is one run of the reference's DistributedMCE with these
# defaults, so its stats are also the driver's occupancy pair
# (d.last_counters of DistributedMCE(kronecker(11, 16, seed=0), chunk=512)).
REUSE_OFF11_EXPECT = dict(cliques=122_478, calls=113_416, branches=112_187,
                          sum_px=683_947, pre_reported=1_031)
_NO_CHOICE = {"perroot": 0, "persistent": 0}
SERVICE11_STATS = {
    "pivot": dict(live_iters=164_961, lane_iters=1_448_820, truncated=0,
                  steals=0, entry_terms=0, window_spills=0, window_hits=0,
                  engine_choices=_NO_CHOICE),
    "hybrid": dict(live_iters=164_693, lane_iters=1_443_724, truncated=0,
                   steals=0, entry_terms=0, window_spills=0, window_hits=0,
                   engine_choices=_NO_CHOICE),
}
SERVICE11_STATS["pivot_reuse_off"] = SERVICE11_STATS["pivot"]
# The reference's pivot-backend rows of BENCH_branching.json
# (benchmarks/table3_ablation.py --branching: bucket_sizes (32, 64, 128,
# 256)), as (cliques, calls, branches, sum_px).
BRANCHING_EXPECT = {
    ("pivot", "ba_web", True): (13725, 339, 64, 1550),
    ("pivot", "ba_web", False): (13725, 1248, 973, 2396),
    ("pivot", "caveman_comm", True): (488, 538, 111, 2004),
    ("pivot", "caveman_comm", False): (488, 1299, 872, 3703),
    # ... and its hybrid rows
    ("hybrid", "ba_web", True): (13725, 339, 64, 1550),
    ("hybrid", "ba_web", False): (13725, 1041, 766, 2286),
    ("hybrid", "caveman_comm", True): (488, 538, 111, 2004),
    ("hybrid", "caveman_comm", False): (488, 718, 291, 2790),
}


KERNEL_PACKAGES = ("bitset_ops", "common_neighbor", "embedding_bag",
                   "segment_spmm", "flash_attention")


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

def kernel_cost(name, rows, mask, extra=()):
    """(bytes, operations) the function must move and do on these inputs:
    each input read once, each output written once."""
    R, K, W = (1,) * (3 - rows.dim()) + tuple(rows.shape)
    words = R * K * W
    if name == "clique_counts":
        nbytes = 4 * (words + R * W) + 2 * R * K + 8 * R
        ops = 3 * words + 4 * R * K           # + 2 compares, and, add
    elif name == "hybrid_census":             # rows: A; + the X0 rows
        x_rows, _, x_alive = extra
        K = K + x_rows.shape[-2]
        words = R * K * W
        nbytes = 4 * (words + 2 * R * W + x_alive.numel()) + 12 * R
        ops = 3 * words + 4 * R * K + 2 * R * W   # + selector bits, |P|
    elif name in ("lemma8_reduce", "pivot_select", "branch_step",
                  "rcd_dominated"):
        return frame_cost(name, rows, mask, extra)
    elif name == "and_popcount_many":
        M = mask.shape[-2]                    # mask: the (R, M, W) masks
        nbytes = 4 * (R * (M + K) * W + R * M * K)
        ops = 3 * R * M * K * W
    elif name == "and_popcount_rows":
        nbytes = 4 * (words + R * W + R * K)
        ops = 3 * words                       # and, popcount, add
    elif name == "and_popcount_argmax":
        nbytes = 4 * (words + R * W) + R * K + 8 * R
        ops = 3 * words + 2 * R * K           # + select, compare
    else:
        nbytes = 4 * (words + 3 * R * W + 2 * R * W + 2 * R * K)
        ops = 6 * words + 2 * R * W           # + lowest bit, partner sum
    return nbytes, ops


def alive_rows(x_rows, xal, roots=None):
    """X0 rows alive in xal (its bits below XC), over all roots or the
    roots selected by `roots` (R,) bool."""
    from repro_torch.kernels.bitset_ops import ops
    alive = ops.bits_to_mask(xal, x_rows.shape[-2])
    if roots is not None:
        alive = alive & roots.unsqueeze(-1)
    return int(alive.sum())


def frame_cost(name, a, P, extra):
    """(bytes, operations) of the engine's entry points on these inputs.
    lemma8_reduce: A, the frame's vectors in and out (P, Xp, Rb, xal, rsz),
    degP2 and n_full, and the alive X0 rows of the roots with a full
    vertex (what the Lemma-8 X-subset test must read); pivot_select: deg
    and n_full (or A for its own sweep), P, Xp and xal in, the alive X0
    rows, the pivot row and B out; branch_step and rcd_dominated:
    `step_cost`."""
    from repro_torch.kernels.bitset_ops import ref
    if name in ("branch_step", "rcd_dominated"):
        return step_cost(name, a, P, extra)
    R, U, W = (1,) * (3 - a.dim()) + tuple(a.shape)
    x_rows, Xp, xal = extra[:3]
    xcw = xal.shape[-1]
    if name == "lemma8_reduce":
        n_full = ref.lemma8_reduce(a, x_rows, P, Xp, xal, *extra[3:])[6]
        rows = alive_rows(x_rows, xal, n_full > 0)
        nbytes = 4 * (R * U * W + 6 * R * W + 2 * R * xcw + 2 * R
                      + R * U + R + rows * W)
        return nbytes, 3 * R * U * W + 2 * rows * W
    deg = extra[3]
    rows = alive_rows(x_rows, xal)
    nbytes = 4 * ((R * U + R if deg is not None else R * U * W)
                  + 2 * R * W + R * xcw + rows * W + 2 * R * W)
    return nbytes, 3 * rows * W + 3 * R * U * (1 if deg is not None else W)


def step_cost(name, a, P, extra):
    """(bytes, operations) of the DFS step's two entry points on these
    inputs. branch_step: A, the slot's P, B, Xp, Rb, rsz and xal, depth,
    live (and w), word w / 32 of each alive X0 row of the slot, the child
    frame, deg and partner out, and the three slot words of each branching
    root written back; its operations frame_step's over A. rcd_dominated:
    P, Xp and xal, the rows the test must read (every selected row of an
    unblocked root, one of a blocked one) and the two outputs."""
    import torch
    from repro_torch.kernels.bitset_ops import ref
    R, U, W = a.shape
    x_rows = extra[0]
    if name == "rcd_dominated":                # P: the mask
        Xp, xal = extra[1:3]
        blocked = ref.rcd_dominated(a, x_rows, P, Xp, xal)[0]
        sel = (ref.bits_to_mask(xal, x_rows.shape[1]).sum(-1)
               + ref.bits_to_mask(Xp, U).sum(-1))
        rows = int(torch.where(blocked, sel.clamp(max=1), sel).sum())
        nbytes = 4 * (2 * R * W + xal.numel() + rows * W + R) + R
        return nbytes, 2 * rows * W
    sxal, depth, live, w = extra[6:10]
    xal = sxal[torch.arange(R, device=a.device), depth.clamp(min=0)]
    hb = ref.branch_step(a, x_rows, *(t.clone() for t in extra[1:7]),
                         depth, live, w)[0]
    xcw = xal.shape[-1]
    nbytes = (4 * (R * U * W + 4 * R * W + R + R * xcw
                   + alive_rows(x_rows, xal)
                   + 3 * R * W + R * xcw + R + 2 * R * U
                   + 3 * int(hb.sum()) * W)
              + 8 * R + R + (4 * R if w is not None else 0) + R)
    return nbytes, 6 * R * U * W


def run_kernel(name, rows, mask, extra, impl, **kw):
    """One call of kernel `name` through `impl` (ops or ref); `kw` (the
    census's `threads`) goes to ops only. branch_step runs on a copy of
    the stack it is given (it writes the stack in place) and returns the
    copy's six buffers after its outputs; `fresh=False` runs it on the
    given stack itself, as the timing does."""
    fresh = kw.pop("fresh", True)
    if name == "branch_step":                 # rows: A, mask: unused
        x_rows, *stack, depth, live, w = extra
        if fresh:
            stack = [t.clone() for t in stack]
        return tuple(impl.branch_step(rows, x_rows, *stack, depth, live,
                                      w)) + tuple(stack)
    if name == "rcd_dominated":               # rows: A, mask: P
        x_rows, Xp, xal = extra
        return impl.rcd_dominated(rows, x_rows, mask, Xp, xal)
    if name == "and_popcount_rows":
        return (impl.and_popcount_rows(rows, mask),)
    if name == "clique_counts":
        return impl.clique_counts(rows, mask, extra[0], extra[1], **kw)
    if name == "hybrid_census":               # rows: A, mask: P
        return impl.hybrid_census(rows, extra[0], mask, extra[1], extra[2],
                                  **kw)
    if name == "lemma8_reduce":               # rows: A, mask: P
        x_rows, Xp, xal, Rb, rsz = extra
        return impl.lemma8_reduce(rows, x_rows, mask, Xp, xal, Rb, rsz)
    if name == "pivot_select":                # the reduced frame's scores
        x_rows, Xp, xal, deg, n_full = extra
        return (impl.pivot_select(rows, x_rows, mask, Xp, xal, deg, n_full),)
    if name == "and_popcount_many":
        return (impl.and_popcount_many(rows, mask),)
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


# the census's block sizes timed beside the library's own choice
CENSUS_THREADS = (32, 64, 128, 256, 512)


def compare(name, rows, mask, extra, timed=False):
    """Kernel vs plain version on the same CUDA tensors. Tolerance 0:
    every output is an integer or a bit pattern, so they must be equal.
    The census, timed, is held and timed at each of CENSUS_THREADS too."""
    from repro_torch.kernels.bitset_ops import ops, ref
    want = run_kernel(name, rows, mask, extra, ref)
    err = exact(name, run_kernel(name, rows, mask, extra, ops), want,
                rows.shape)
    out = dict(name=name, shape=list(rows.shape),
               mask_shape=list(mask.shape), max_abs_err=err, tolerance=0)
    if name in ("lemma8_reduce", "pivot_select"):
        # roots with a full vertex, and the alive X0 rows the kernel reads
        # (lemma8_reduce: those of these roots only)
        n_full = want[6] if name == "lemma8_reduce" else extra[4]
        full = None if n_full is None else n_full > 0
        out.update(xc=extra[0].shape[-2],
                   full_roots=None if full is None else int(full.sum()),
                   alive_x_rows=alive_rows(
                       extra[0], extra[2],
                       full if name == "lemma8_reduce" else None))
    if name == "branch_step":
        # roots that branch (their slot is written back in place), and the
        # alive X0 rows of the slots, whose column word w / 32 it reads
        import torch
        xal = extra[6][torch.arange(rows.shape[0], device=rows.device),
                       extra[7].clamp(min=0)]
        out.update(xc=extra[0].shape[-2], branching_roots=int(want[0].sum()),
                   alive_x_rows=alive_rows(extra[0], xal))
    if name == "rcd_dominated":
        out.update(xc=extra[0].shape[-2], blocked_roots=int(want[0].sum()),
                   alive_x_rows=alive_rows(extra[0], extra[2]))
    if timed and name in ("clique_counts", "hybrid_census"):
        threads_ms = {}
        for t in CENSUS_THREADS:
            def forced(t=t):
                return run_kernel(name, rows, mask, extra, ops, threads=t)
            exact(f"{name} threads={t}", forced(), want, rows.shape)
            threads_ms[t] = cuda_ms(forced)[0]
        out.update(threads_ms=threads_ms)
    if timed:
        nbytes, nops = kernel_cost(name, rows, mask, extra)
        # (branch_step: on the stack it was given, whose slots each call
        # writes; a root stops branching once its B or P is spent)
        ms, call_ms = cuda_ms(lambda: run_kernel(name, rows, mask, extra,
                                                 ops, fresh=False))
        plain_ms, plain_call_ms = cuda_ms(
            lambda: run_kernel(name, rows, mask, extra, ref, fresh=False))
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
    block, W = 1/4/32/40, tied scores, all-invalid roots."""
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
                    (4, 513, 4), (1, 2048, 2), (3, 70, 40)]:
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
        n += census_edge_cases(words, rng, dev, r, k, w)
    return n + frame_edge_cases(dev)


def frame_edge_cases(dev):
    """lemma8_reduce and pivot_select (every scoring mode and backend),
    and branch_step (pivot family and 'rcd') and rcd_dominated, at edge
    shapes: XC = 0, 1, 33 and 2,048, U off 32 and U = 128, W = 1-5,
    A and the X0 rows one word off the vector loads' alignment, an empty P
    and pool, P inside N(v) ∪ {v} (Lemma 8 fires), tied rows, xal with
    bits past XC."""
    import numpy as np
    import torch
    from repro_torch.kernels.bitset_ops import ops, ref
    rng = np.random.default_rng(2)

    def words(*shape, density=0.5):
        b = rng.random(shape + (32,)) < density
        return torch.from_numpy(np.packbits(b, axis=-1, bitorder="little")
                                .view(np.int32).reshape(shape)).to(dev)
    n = 0
    for r, u, xc, w in [(3, 7, 0, 1), (5, 50, 33, 2), (4, 96, 1, 3),
                        (4, 128, 2048, 4), (3, 160, 70, 5), (9, 32, 40, 1)]:
        below = ops.mask_to_bits(torch.ones(1, u, dtype=torch.bool,
                                            device=dev), w)
        a, x_rows = words(r, u, w) & below, words(r, xc, w) & below
        P = words(r, w, density=0.3) & below
        Xp = words(r, w, density=0.2) & below & ~P
        P[0], Xp[0] = 0, 0                               # empty pool
        v = int(rng.integers(u))                         # Lemma 8 fires
        a[1, v] &= ~ops.mask_to_bits(torch.arange(u, device=dev) == v, w)
        P[1] = (a[1, v] | ops.mask_to_bits(
            torch.arange(u, device=dev) == v, w)) & below[0]
        a[2] = a[2, :1]                                  # tied rows
        xal = words(r, max(-(-xc // 32), 1))             # bits past XC
        Rb = words(r, w, density=0.05) & ~P
        rsz = torch.from_numpy(rng.integers(0, 9, r).astype(np.int32)).to(dev)
        l8 = (x_rows, Xp, xal, Rb, rsz)
        compare("lemma8_reduce", a, P, l8)
        red = ref.lemma8_reduce(a, x_rows, P, Xp, xal, Rb, rsz)
        check(int(red[6][1]) > 0, "lemma8 edge case: no full vertex")
        compare("pivot_select", a, red[0],
                (x_rows, red[1], red[2], red[5], red[6]))
        n += 2
        for rows_a, rows_x in ((a, x_rows), (unaligned(a), unaligned(x_rows))):
            exact("lemma8_reduce unaligned",
                  ops.lemma8_reduce(rows_a, rows_x, P, Xp, xal, Rb, rsz),
                  red, a.shape)
            for deg, n_full in ((red[5], red[6]), (red[5], None),
                                (None, None)):
                for kw in ({}, {"revised": True}, {"hybrid": True}):
                    exact(f"pivot_select {kw}", (ops.pivot_select(
                        rows_a, rows_x, P, Xp, xal, deg, n_full, **kw),),
                        (ref.pivot_select(a, x_rows, P, Xp, xal, deg,
                                          n_full, **kw),), a.shape)
                    n += 1
        # the DFS step's entry points: branch_step for the pivot family and
        # for 'rcd' (w given; the stack compared after its in-place write),
        # and rcd_dominated
        for given in (False, True):
            step = stack_operands(a, x_rows, P, Xp, xal, Rb, rsz, r + u,
                                  w_given=given)
            want = run_kernel("branch_step", a, P, step, ref)
            for rows_a, rows_x in ((a, x_rows),
                                   (unaligned(a), unaligned(x_rows))):
                exact(f"branch_step w_given={given}", run_kernel(
                    "branch_step", rows_a, P, (rows_x,) + step[1:], ops),
                    want, a.shape)
                n += 1
        want = ref.rcd_dominated(a, x_rows, P, Xp, xal)
        for rows_a, rows_x in ((a, x_rows), (unaligned(a), unaligned(x_rows))):
            exact("rcd_dominated",
                  ops.rcd_dominated(rows_a, rows_x, P, Xp, xal), want,
                  a.shape)
            n += 1
    return n


def unaligned(t):
    """A contiguous copy of `t` one word past an aligned address (the
    kernels' word-by-word instances)."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def census_edge_cases(words, rng, dev, r, k, w):
    """clique_counts with an empty P, a P of one bit, rows that hold P or
    miss one of its bits, and all-false selectors; and_popcount_many with
    K = 1 against many masks, M = 1 and the general K."""
    import torch
    rows, mask = words(r, k, w), words(r, w)
    mask[0] = 0                                          # empty P
    if r > 1:
        mask[1] = 0
        mask[1, -1] = 1                                  # one bit
    pick = torch.from_numpy(rng.random((r, k))).to(dev)
    rows = torch.where((pick < 0.3).unsqueeze(-1), rows | mask.unsqueeze(1),
                       rows)
    # the lowest bit of P alone: the lowest of its first nonzero word
    first = (mask != 0).to(torch.int32).argmax(-1, keepdim=True)
    word = mask.gather(-1, first)
    low = torch.zeros_like(mask).scatter(-1, first, word & -word)
    rows = torch.where(((pick >= 0.3) & (pick < 0.6)).unsqueeze(-1),
                       mask.unsqueeze(1) ^ low.unsqueeze(1), rows)
    in_p = torch.from_numpy(rng.random((r, k)) < 0.5).to(dev)
    in_x = torch.from_numpy(rng.random((r, k)) < 0.5).to(dev)
    in_x[-1] = False                                     # all-false
    none = torch.zeros_like(in_p)
    masks = words(r, 2 * k + 3, w)
    # the hybrid census on the same rows cut into A (U rows, U not a
    # multiple of 32 where K allows) and X0 rows (XC = 0 on one cut), Xp
    # from the words, x_alive with bits past XC
    cuts = sorted({min(k, 32 * w), min(k, 32 * w, max(1, k // 3 + 5))})
    xp = words(r, w)
    for u in cuts:
        a, x_rows = rows[:, :u].contiguous(), rows[:, u:].contiguous()
        x_alive = words(r, max(-(-(k - u) // 32), 1))
        compare("hybrid_census", a, mask, (x_rows, xp, x_alive))
    for name, rr, mm, extra in [
            ("clique_counts", rows, mask, (in_p, in_x)),
            ("clique_counts", rows, mask, (none, none)),
            ("and_popcount_many", rows[:, :1].contiguous(), ~rows, ()),
            ("and_popcount_many", rows, masks, ()),
            ("and_popcount_many", rows, masks[:, :1].contiguous(), ())]:
        compare(name, rr, mm, extra)
    return 5 + len(cuts)


def bucket_operands(b, dev, rng):
    """One Graph500 bucket's rows on the card with P and Xp drawn from its
    p0 (Rb empty, rsz the roots' own), and the census's two forms of
    operands: the stacked rows with bool selectors (`clique_counts`) and
    x_alive as bits (`hybrid_census`, and the engine's other entry
    points)."""
    import numpy as np
    import torch
    from repro_torch.core.engine import frames as fr
    from repro_torch.core.engine.loop import bucket_tensors
    a, p0, x_rows, x_alive0, rsz0 = bucket_tensors(
        b.a, b.p0, b.x_rows, b.x_alive0, b.rsz0, dev)
    keep = torch.from_numpy(
        rng.integers(0, 2**32, p0.shape, dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(dev)
    P = p0 & keep
    Xp = p0 & ~keep
    U = a.shape[1]
    return dict(
        a=a, x_rows=x_rows, x_alive0=x_alive0, P=P, Xp=Xp, rsz=rsz0,
        Rb=torch.zeros_like(P),
        census=torch.cat([a, x_rows], 1),
        in_p=torch.cat([fr.bitset_to_mask(P, U),
                        torch.zeros_like(x_alive0)], -1),
        in_x=torch.cat([fr.bitset_to_mask(Xp, U), x_alive0], -1),
        xal=fr.mask_to_bitset(x_alive0, -(-x_rows.shape[1] // 32)))


def stack_operands(a, x_rows, P, Xp, xal, Rb, rsz, seed, w_given=False):
    """branch_step's operands around one frame a root: a DFS stack of
    D = U + 2 slots of random words holding (P, B, Xp, Rb, rsz, xal) at a
    random depth 0-3 of each root, B a random part of P; where R > 2 root
    0's B is empty (w clamps) and root 1 is dead at depth -1; live is
    depth >= 0, and w (R,) int32 below U when `w_given` ('rcd'), else
    None. Returns branch_step's `extra`: (x_rows, sP, sB, sXp, sRb, srsz,
    sxal, depth, live, w)."""
    import numpy as np
    import torch
    R, U, W = a.shape
    dev = a.device
    D = U + 2
    rng = np.random.default_rng(seed)

    def words(*shape):
        return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev)
    sP, sB, sXp, sRb = (words(R, D, W) for _ in range(4))
    srsz = torch.from_numpy(rng.integers(1, 9, (R, D)).astype(np.int32)) \
        .to(dev)
    sxal = words(R, D, xal.shape[-1])
    depth = torch.from_numpy(rng.integers(0, min(4, D), R)).to(dev)
    B = P & words(R, W)
    if R > 2:
        B[0] = 0
    ar = torch.arange(R, device=dev)
    for buf, v in zip((sP, sB, sXp, sRb, srsz, sxal), (P, B, Xp, Rb, rsz,
                                                        xal)):
        buf[ar, depth] = v
    if R > 2:
        depth[1] = -1
    w = (torch.from_numpy(rng.integers(0, U, R).astype(np.int32)).to(dev)
         if w_given else None)
    return (x_rows, sP, sB, sXp, sRb, srsz, sxal, depth, depth >= 0, w)


def bucket_cases(prep, dev):
    """Each Graph500 bucket's own rows, with masks drawn from its p0 — the
    shapes the slice's main path hands every kernel: the row kernels on A
    and on the X0 rows (the X-subset shape: ~X0 rows against P); the
    Lemma-8 pass and the pivot select on the engine's operands (the pivot
    select on the frame the pass reduced, as the engine calls it); the
    hybrid census over A stacked on the X0 rows (U + XC rows;
    `clique_counts` on the reference's contract, and `hybrid_census` on
    the engine's operands, which the engine calls), the two entry points
    held to each other; each at the bucket's roots and, where the lanes
    call it, at their 64 (form "lanes": the first 64 roots' rows); and
    the rcd maximality sweep of P (K = 1) against ~X0 rows stacked on ~A
    (M = XC + U)."""
    import numpy as np
    import torch
    from repro_torch.core.engine import frames as fr
    from repro_torch.kernels.bitset_ops import ops, ref
    rng = np.random.default_rng(1)
    lines = []
    for b in prep.buckets:
        o = bucket_operands(b, dev, rng)
        a, x_rows, x_alive0, P, Xp, census, in_p, in_x, xal, Rb, rsz = (
            o[k] for k in ("a", "x_rows", "x_alive0", "P", "Xp", "census",
                           "in_p", "in_x", "xal", "Rb", "rsz"))
        wrow = a[:, 0].contiguous()
        not_x = ~x_rows
        U = a.shape[1]
        not_nbrs = torch.cat([not_x, ~a], 1)
        L = min(64, b.num_roots)

        def lanes(*ts):
            return tuple(t[:L].contiguous() for t in ts)
        hybrid = (a, P, (x_rows, Xp, xal))
        l8 = (x_rows, Xp, xal, Rb, rsz)
        red = ref.lemma8_reduce(a, x_rows, P, Xp, xal, Rb, rsz)
        piv = (x_rows, red[1], red[2], red[5], red[6])
        step = stack_operands(a, x_rows, P, Xp, xal, Rb, rsz, U)
        step_lanes = stack_operands(*lanes(a, x_rows, P, Xp, xal, Rb, rsz),
                                    U + 1)
        for name, rows, mask, extra, form in [
                ("frame_step", a, P, (Xp, wrow), "roots"),
                ("branch_step", a, P, step, "roots"),
                ("branch_step", *lanes(a, P), step_lanes, "lanes"),
                ("rcd_dominated", a, P, (x_rows, Xp, xal), "roots"),
                ("rcd_dominated", *lanes(a, P), lanes(x_rows, Xp, xal),
                 "lanes"),
                ("and_popcount_rows", a, P, (), "roots"),
                ("and_popcount_rows", not_x, P, (), "x_subset"),
                ("and_popcount_argmax", x_rows, P, (x_alive0,), "roots"),
                ("lemma8_reduce", a, P, l8, "roots"),
                ("lemma8_reduce", *lanes(a, P), lanes(*l8), "lanes"),
                ("pivot_select", a, red[0], piv, "roots"),
                ("pivot_select", *lanes(a, red[0]), lanes(*piv), "lanes"),
                ("clique_counts", census, P, (in_p, in_x), "roots"),
                ("clique_counts", *lanes(census, P),
                 lanes(in_p, in_x), "lanes"),
                ("hybrid_census", *hybrid, "roots"),
                ("hybrid_census", *lanes(a, P), lanes(x_rows, Xp, xal),
                 "lanes"),
                ("and_popcount_many", P.unsqueeze(1), not_nbrs, (),
                 "roots")]:
            line = compare(name, rows, mask, extra, timed=True)
            line.update(phase="kernels", bucket_u=b.u_pad, bucket_xc=b.x_pad,
                        roots=b.num_roots, form=form, operands="random")
            emit(line)
            lines.append(line)
        # the two census entry points agree on the engine's operands
        got = ops.hybrid_census(a, x_rows, P, Xp, xal)
        for g, w in zip(got, ops.clique_counts(census, P, in_p, in_x)
                        + (fr.popcount(P),)):
            check(torch.equal(g, w), f"hybrid_census and clique_counts "
                  f"disagree at U = {U}")
    return lines


def launched(names, drive):
    """The inputs of every launch of each `ops.<name>` while `drive()`
    runs the engine, cloned as the engine handed them over: {name: [(args,
    kwargs), ...]}."""
    import torch
    from repro_torch.kernels.bitset_ops import ops
    real = {name: getattr(ops, name) for name in names}
    seen = {name: [] for name in names}

    def recorder(name):
        def record(*args, **kw):
            seen[name].append(tuple(
                t.clone() if isinstance(t, torch.Tensor) else t
                for t in args) + (dict(kw),))
            return real[name](*args, **kw)
        return record
    for name in names:
        setattr(ops, name, recorder(name))
    try:
        drive()
    finally:
        for name in names:
            setattr(ops, name, real[name])
    return seen


def real_frames(dev, prep, u=64, first=8):
    """The engine's own operands of lemma8_reduce and pivot_select at the U
    = 64 bucket, recorded from their first `first` launches in the per-root
    slice (`run_bucket`, run() defaults; form "roots") and on 64 persistent
    lanes (form "lanes"): random P rarely has a full vertex, the engine's
    often does. Of each form, the lemma8_reduce launch whose roots have
    the most full vertices (the later on a tie) and the pivot_select
    launch of the same call entry, as (bucket, form, lemma8 args, pivot
    args)."""
    from repro_torch.core.engine import frames as fr
    from repro_torch.core.engine import loop
    from repro_torch.core.engine.loop import bucket_tensors
    from repro_torch.kernels.bitset_ops import ref
    b = next(b for b in prep.buckets if b.u_pad == u)
    args = bucket_tensors(b.a, b.p0, b.x_rows, b.x_alive0, b.rsz0, dev)
    cfg = fr.EngineConfig(max_iters=first)
    for form, drive in (
            ("roots", lambda: loop.run_bucket(*args, cfg)),
            ("lanes", lambda: loop.run_bucket_persistent(
                *args, cfg, lanes=min(64, b.num_roots)))):
        seen = launched(("lemma8_reduce", "pivot_select"), drive)
        l8 = seen["lemma8_reduce"][:first]
        full = [int((ref.lemma8_reduce(*c[:7])[6] > 0).sum()) for c in l8]
        i = max(range(len(l8)), key=lambda i: (full[i], i))
        yield b, form, l8[i][:7], seen["pivot_select"][i][:7]


def real_steps(dev, prep, u=64, first=8):
    """The engine's own operands of the DFS step's entry points at the U =
    64 bucket: branch_step from the pivot slice (`run_bucket`, run()
    defaults; form "roots") and the pivot lanes (64 persistent lanes;
    form "lanes"), rcd_dominated from the same two with backend="rcd";
    each the last of its first `first` launches (max_iters = first), its
    inputs as the engine handed them over (the stack before the launch's
    in-place write), as (bucket, form, name, (rows, mask, extra)) for
    `compare`."""
    from repro_torch.core.engine import frames as fr
    from repro_torch.core.engine import loop
    from repro_torch.core.engine.loop import bucket_tensors
    b = next(b for b in prep.buckets if b.u_pad == u)
    args = bucket_tensors(b.a, b.p0, b.x_rows, b.x_alive0, b.rsz0, dev)
    for backend, name in (("pivot", "branch_step"), ("rcd", "rcd_dominated")):
        cfg = fr.EngineConfig(backend=backend, max_iters=first)
        for form, drive in (
                ("roots", lambda: loop.run_bucket(*args, cfg)),
                ("lanes", lambda: loop.run_bucket_persistent(
                    *args, cfg, lanes=min(64, b.num_roots)))):
            seen = launched((name,), drive)[name]
            a, x_rows, *rest = seen[min(first, len(seen)) - 1][:-1]
            if name == "branch_step":         # rest: the stack, depth, live, w
                yield b, form, name, (a, rest[0], (x_rows, *rest))
            else:                             # rest: P, Xp, xal
                yield b, form, name, (a, rest[0], (x_rows, *rest[1:]))


def real_frame_cases(dev, prep):
    """lemma8_reduce and pivot_select (`real_frames`), and branch_step and
    rcd_dominated (`real_steps`), on the engine's own operands, each held
    bit for bit to its plain version and timed; each line says how many
    roots had a full vertex, branched or were blocked."""
    lines = []

    def run(b, form, name, rows, mask, extra):
        line = compare(name, rows, mask, extra, timed=True)
        line.update(phase="kernels", bucket_u=b.u_pad, bucket_xc=b.x_pad,
                    roots=b.num_roots, form=form, operands="real")
        emit(line)
        lines.append(line)
    for b, form, l8, piv in real_frames(dev, prep):
        for name, (a, x_rows, P, *rest) in (("lemma8_reduce", l8),
                                           ("pivot_select", piv)):
            run(b, form, name, a, P, (x_rows, *rest))
    for b, form, name, call in real_steps(dev, prep):
        run(b, form, name, *call)
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


def lanes_of(args):
    """(L, U, XC, T, W) of a window walk's inputs (any leading dims)."""
    T, W = args[3].shape[-2:]
    return (args[3].numel() // (T * W), args[0].shape[-2],
            args[1].shape[-2], T, W)


def compare_window(name, args, steps, timed=False):
    """Window kernel vs its plain version on the same CUDA tensors.
    Tolerance 0: windows are bit patterns and ctl holds integers. Timed,
    each G in (1, 2, 4) is held to the plain version and timed too, and
    the kernel is timed at 0 steps (a copy-through: the launch and the
    window's bytes) and 1 step (staging and one step) beside `steps`."""
    from repro_torch.kernels.bitset_ops import ops, ref

    def call(impl):
        return getattr(impl, name)(*args, steps=steps)
    got = call(ops)
    want = call(ref)
    err = exact(name, got, want, args[3].shape)
    ctl = got[-1]
    L, U, XC, T, W = lanes_of(args)
    out = dict(name=name, shape=list(args[0].shape), xc=XC,
               window=list(args[3].shape), steps=steps, max_abs_err=err,
               tolerance=0, steps_done=int(ctl[..., 5].sum()),
               calls=int(ctl[..., 1].sum()),
               geometry=ops.window_geometry(
                   L, U, XC, T, W, ops._sms(args[0].device))._asdict())
    if timed:
        nbytes, nops = window_cost(args, ctl)
        ms, call_ms = cuda_ms(lambda: call(ops))
        plain_ms, plain_call_ms = cuda_ms(lambda: call(ref), reps=5,
                                          inner=3)
        group_ms = {}
        for g in ops.WINDOW_GROUPS:
            geo = ops.window_geometry(L, U, XC, T, W,
                                      ops._sms(args[0].device), group=g)

            def forced(geo=geo):
                return ops._window_walk(name, *args, steps, geometry=geo)
            exact(f"{name} G={g}", forced(), want, args[3].shape)
            group_ms[g] = cuda_ms(forced)[0]
        steps_ms = {str(k): cuda_ms(lambda k=k: getattr(ops, name)(
            *args, steps=k))[0] for k in (0, 1)}
        out.update(
            ms=ms, plain_ms=plain_ms, call_ms=call_ms,
            plain_call_ms=plain_call_ms, group_ms=group_ms,
            steps_ms=dict(steps_ms, **{str(steps): ms}),
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
    vertex clamps); W = 1, 2, 3 and 4 and W = 7 (the runtime-W instance);
    lane slices off 16 bytes (XC = 1 with W = 2, XC = 50 with W = 3: plain
    loads); rows too large to stage (U = 256, XC = 7,000, W = 8); K = 0, 1
    and 64; L = 1 (the single-root form); L off the lanes per block, whose
    blocks hold lanes that stop at different steps (301 lanes, 2 a block;
    1,663 lanes, 4 a block); XC = 2,048 (G = 4 on 64 lanes, G = 2 on
    1,663). Every forced launch geometry is held in the card tests
    (tests/test_torch_cuda_kernels.py)."""
    n = 0
    for i, (L, U, XC, W, edge, steps) in enumerate([
            (3, 64, 40, 2, "dead", 16), (3, 64, 40, 2, "blocked", 16),
            (3, 32, 64, 1, "empty_b", 16), (4, 96, 50, 3, "none", 16),
            (4, 64, 1, 2, "none", 16), (4, 64, 40, 2, "none", 1),
            (4, 64, 40, 2, "none", 64), (4, 128, 128, 4, "none", 16),
            (3, 200, 70, 7, "none", 16), (2, 256, 7000, 8, "none", 16),
            (4, 64, 40, 2, "none", 0), (301, 64, 40, 2, "blocked", 16),
            (64, 32, 2048, 1, "empty_b", 16),
            (1663, 32, 2048, 1, "dead", 16)]):
        args = window_inputs(dev, L, U, XC, W, edge, seed=i)
        compare_window("dfs_step_window_lanes", args, steps)
        compare_window("dfs_step_window", args, steps)
        compare_window("dfs_step_window", [t[1] for t in args], steps)
        n += 3
    return n


def real_windows(dev, prep):
    """Each Graph500 bucket's real windows, as (bucket, kernel name,
    inputs, live lanes): those of the launch with the most live lanes
    (dloc >= 0; the later on a tie) among the first four trips of the
    fused-window persistent engine (lane form) and of the windowed
    per-root walk (per-root form)."""
    from repro_torch.core.engine import frames as fr
    from repro_torch.core.engine import loop
    from repro_torch.core.engine.loop import bucket_tensors
    cfg = fr.EngineConfig(dynamic_red=False, window_steps=16, max_iters=4)
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
            seen = [c[:-1] for c in launched((name,), drive)[name][:4]]
            live = [int((w[-1] >= 0).sum()) for w in seen]
            yield (b, name, seen[max(range(len(seen)),
                                     key=lambda i: (live[i], i))], max(live))


def window_slice_cases(dev, prep):
    """The window walk on each bucket's real windows (`real_windows`).
    Each line carries the launch geometry and the time at each G."""
    lines = []
    for b, name, wargs, live in real_windows(dev, prep):
        line = compare_window(name, wargs, 16, timed=True)
        line.update(phase="kernels", bucket_u=b.u_pad, bucket_xc=b.x_pad,
                    roots=b.num_roots, live=live)
        emit(line)
        lines.append(line)
    return lines

# --------------------------------------------------------------------------
# phase 2b: the substrate kernels against their plain versions
# --------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12       # H100 SXM bf16 dense tensor-core rate
# kernel -> (package, its CUDA source, the TPU kernel it replaces)
SUBSTRATE = {
    "has_common_neighbor": (
        "common_neighbor",
        "src/repro_torch/kernels/common_neighbor/csrc/common_neighbor.cu",
        "src/repro/kernels/common_neighbor/kernel.py:30"),
    "embedding_bag_sum": (
        "embedding_bag",
        "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
        "src/repro/kernels/embedding_bag/kernel.py:47"),
    "dense_spmm": (
        "segment_spmm",
        "src/repro_torch/kernels/segment_spmm/csrc/segment_spmm.cu",
        "src/repro/kernels/segment_spmm/kernel.py:32"),
    "flash_attention": (
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:82"),
}


def substrate_modules(name):
    """(ops, ref) of a substrate kernel's package."""
    import importlib
    pkg = f"repro_torch.kernels.{SUBSTRATE[name][0]}"
    return (importlib.import_module(f"{pkg}.ops"),
            importlib.import_module(f"{pkg}.ref"))


def bound(nbytes, nops, ops_per_s=OPS_PER_S):
    """(bound ms, what bounds it): the larger of bytes over the memory
    rate and operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def close(got, want, rtol, atol):
    """(max error, relative norm, within): |got - want| <= atol + rtol *
    |want| everywhere and ||got - want|| <= rtol * ||want|| over the whole
    output."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    rel = float(diff.norm() / w.norm()) if float(w.norm()) else 0.0
    return err, rel, bool((diff <= atol + rtol * w.abs()).all()) \
        and rel <= rtol


def substrate_compare(name, call, args, rtol, atol, shape, cost=None,
                      library=None, plain_reps=(21, 10),
                      phase="substrate_kernels"):
    """Kernel (`call(ops, *args)`) against its plain version (`call(ref,
    *args)`) on the same CUDA tensors: equal for a bool output, else
    |got - want| <= atol + rtol * |want| everywhere and ||got - want|| <=
    rtol * ||want|| over the whole output, so that a fault confined to
    outputs smaller than atol still fails. With `cost` (bytes,
    operations, peak rate) the kernel, the plain version and `library` (one
    PyTorch call of the same function, or None) are timed."""
    import torch
    ops, ref = substrate_modules(name)
    got, want = call(ops, *args), call(ref, *args)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name}: {got.dtype}{tuple(got.shape)} vs "
          f"{want.dtype}{tuple(want.shape)}")
    if got.dtype == torch.bool:
        err = int((got != want).sum())
        check(err == 0, f"{name} differs from its plain version on {err} "
              f"rows at {shape}")
    else:
        check(bool(torch.isfinite(got).all()),
              f"{name}: non-finite at {shape}")
        err, rel, ok = close(got, want, rtol, atol)
        check(ok, f"{name} differs from its plain version by {err} "
              f"(relative norm {rel}) at {shape} (rtol {rtol}, atol {atol})")
    out = dict(phase=phase, name=name, shape=list(shape),
               max_abs_err=err, rtol=rtol, atol=atol)
    if got.dtype != torch.bool:
        out.update(rel_norm_err=rel)
    if cost is not None:
        nbytes, nops, rate = cost
        ms, call_ms = cuda_ms(lambda: call(ops, *args))
        plain_ms, plain_call_ms = cuda_ms(lambda: call(ref, *args),
                                          *plain_reps)
        lib_ms = cuda_ms(library)[0] if library is not None else None
        bound_ms, bound_by = bound(nbytes, nops, rate)
        out.update(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   plain_call_ms=plain_call_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   operations=nops)
    emit(out)
    return out


def drive_entry(name, entry):
    """One entry point of the substrate path, with its kernel's launch count
    set to 0 just before and read just after; fails if it did not launch."""
    import torch
    ops, _ = substrate_modules(name)
    ops.LAUNCHES.reset()
    out = entry()
    torch.cuda.synchronize()
    launches = ops.LAUNCHES[name]
    check(launches > 0, f"kernel {name} was not launched by its entry point")
    return out, launches


L2_FLUSH_BYTES = 256 << 20    # written before a cold call: 5x the 50 MB L2


def kernel_ms(fn, calls=20, flush=None):
    """(device ms, wall ms) a call of `fn`: its kernels' time summed
    (torch.profiler's CUDA kernel events, the mean of `calls` calls) and
    the host's clock around the call and a sync. Copies and fills are
    left out. With `flush`, run before every call (and left out of both),
    the call finds a cold L2. For entry points that wait for their own
    launches, where CUDA events would time the host's launch gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(calls):
        if flush is not None:
            flush()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))
               and "FillFunctor" not in e.name)
    return 1e-3 * busy / calls, 1e3 * statistics.median(walls)


def l2_flush(dev):
    """A function that writes L2_FLUSH_BYTES (a fill kernel, which
    kernel_ms leaves out), evicting what the L2 held."""
    import torch
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    return buf.zero_


def triangle_table(dev, g):
    """(padded table, edges, real entries a row) of a graph on the card:
    `pad_adjacency(g)` at the width of its largest degree, `g.edges()`."""
    import torch
    from repro_torch.kernels.common_neighbor import ops
    padded = ops.pad_adjacency(g.indptr, g.indices, int(g.degrees().max()))
    return (torch.from_numpy(padded).to(dev),
            torch.from_numpy(g.edges()).to(dev),
            torch.from_numpy(g.degrees()).to(dev))


def bipartite_hubs(n, m, seed=0, inner=0.01):
    """A triangle-poor graph with hubs: `m` edges drawn between two halves
    of `n` vertices, each end by a power-law weight ((rank + 1) ** -0.6,
    the top hub of degree about m / 92 at n = 16,384), and `inner` * m
    edges drawn uniformly inside the first half, the only ones that can
    close a triangle; duplicates dropped."""
    import numpy as np
    from repro_torch.graph.csr import from_edge_list
    rng = np.random.default_rng(seed)
    half = n // 2
    w = (np.arange(half) + 1.0) ** -0.6
    w /= w.sum()
    ends = np.stack([rng.choice(half, m, p=w),
                     half + rng.choice(half, m, p=w)], 1)
    within = rng.integers(0, half, (int(inner * m), 2))
    return from_edge_list(n, np.concatenate([ends, within]))


def swept_bytes(au, av):
    """(least bytes, staged bytes) of the rows gathered beforehand: `least
    bytes`, what any design must read, one 32-byte sector of each row for
    an edge with a common entry and both rows whole for one without (the
    bound); `staged bytes`, adj_u's rows whole and adj_v's each up to the
    128-byte chunk of its first entry that adj_u's row holds (whole where
    there is none), what a kernel that stages adj_u whole before it sweeps
    adj_v must read."""
    import torch
    e, d = av.shape
    su = torch.sort(au, 1).values
    idx = torch.searchsorted(su, av).clamp_(max=max(d - 1, 0))
    hit = (av >= 0) & (su.gather(1, idx) == av)
    del su, idx
    first = hit.int().argmax(1)
    met = hit.any(1)
    chunks = torch.where(met, (first // 32 + 1) * 128,
                         torch.full_like(first, 4 * d))
    swept = int(chunks.clamp(max=4 * d).sum())
    misses = e - int(met.sum())
    return (64 * (e - misses) + 8 * d * misses + e,
            4 * e * d + swept + e)


def common_neighbor_entry(dev, label, g, flush, host):
    """`edge_common_neighbor(pad_adjacency(g), g.edges())` as a user calls
    it: driven once with its launches read, held to the host Lemma-4 mask
    `host`, then timed back to back (the table stays in L2 where it fits)
    and with L2 flushed before each call. Bound: the table read once, the
    edges and the output."""
    import numpy as np
    from repro_torch.kernels.common_neighbor import ops
    padded, edges, deg = triangle_table(dev, g)
    tri, launches = drive_entry("has_common_neighbor",
                                lambda: ops.edge_common_neighbor(padded,
                                                                 edges))
    check(launches == 3, f"edge_common_neighbor made {launches} launches, "
          f"not 3 (count, edge groups, queued edges)")
    check(np.array_equal(tri.cpu().numpy(), host),
          f"edge_common_neighbor differs from the host Lemma-4 mask at "
          f"{label}")
    (n, d), e = padded.shape, edges.shape[0]
    nbytes = 4 * n * d + 8 * e + e
    nops = int((deg[edges[:, 0].long()] + deg[edges[:, 1].long()]).sum())

    def call():
        return ops.edge_common_neighbor(padded, edges)
    ms, wall_ms = kernel_ms(call)
    cold_ms, cold_wall_ms = kernel_ms(call, flush=flush)
    line = dict(
        phase="substrate_kernels", name="edge_common_neighbor", graph=label,
        shape=[n, d, e], launches=launches, equal_host_mask=True,
        max_abs_err=0, triangle_share=float(host.mean()),
        ms=ms, wall_ms=wall_ms, cold_ms=cold_ms, cold_wall_ms=cold_wall_ms,
        bytes=nbytes, operations=nops,
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, nops))))
    emit(line)
    return line


# the triangle-poor graph of the common-neighbour phase and its label
BIPARTITE = dict(n=1 << 14, m=1 << 18, seed=0)
BIPARTITE_LABEL = "bipartite_hubs:n=16384,m=262144,seed=0"


def common_neighbor_cases(dev, g12, g14):
    """The reference test's (E, D) shapes, rows past one staged tile, then
    scale 12's edges, gathered beforehand (`has_common_neighbor`, the
    reference kernel's contract, against its plain version; bound counted
    from the data) and through the entry point `edge_common_neighbor` at
    scales 12 and 14 and on a triangle-poor graph with hubs
    (`common_neighbor_entry`), each held to the port's host Lemma-4 mask.
    No plain version runs past scale 12."""
    import numpy as np
    import torch
    from repro_torch.core.global_reduction import _triangle_edge_mask
    from repro_torch.kernels.common_neighbor import ops

    def call(impl, au, av):
        return impl.has_common_neighbor(au, av)
    lines = []
    for e, d in [(1, 4), (10, 8), (130, 16), (257, 5), (40, 1500),
                 (9, 3582)]:
        rng = np.random.default_rng(e * 31 + d)
        au, av = (torch.from_numpy(rng.integers(-1, 40 if d < 100 else 4 * d,
                                                (e, d)).astype(np.int32))
                  .to(dev) for _ in range(2))
        lines.append(substrate_compare("has_common_neighbor", call, (au, av),
                                       0, 0, (e, d)))
    flush = l2_flush(dev)
    host12 = _triangle_edge_mask(g12)
    t0 = time.perf_counter()
    host14 = _triangle_edge_mask(g14)
    host14_s = time.perf_counter() - t0
    gbp = bipartite_hubs(**BIPARTITE)
    hostbp = _triangle_edge_mask(gbp)
    entry = {"scale12": common_neighbor_entry(
                 dev, "kron:scale=12,ef=16,seed=0", g12, flush, host12),
             "scale14": common_neighbor_entry(
                 dev, "kron:scale=14,ef=16,seed=0", g14, flush, host14),
             "bipartite": common_neighbor_entry(
                 dev, BIPARTITE_LABEL, gbp, flush, hostbp)}
    padded, edges, deg = triangle_table(dev, g12)
    au = padded[edges[:, 0].long()]
    av = padded[edges[:, 1].long()]
    e, d = au.shape
    real = int((deg[edges[:, 0].long()] + deg[edges[:, 1].long()]).sum())
    check(torch.equal(ops.has_common_neighbor(au, av).cpu(),
                      torch.from_numpy(host12)),
          "has_common_neighbor differs from the host Lemma-4 mask")
    # any design: a sector of each row where they meet, else both whole;
    # this design: adj_u's row whole, adj_v's up to its first match
    least, staged = swept_bytes(au, av)
    line = substrate_compare("has_common_neighbor", call, (au, av), 0, 0,
                             (e, d), cost=(least, real, OPS_PER_S),
                             plain_reps=(2, 1))
    line.update(
        graph="kron:scale=12,ef=16,seed=0",
        launches=entry["scale12"]["launches"],
        triangle_share=float(host12.mean()), real_entries=real,
        bound_ms_staged_design=bound(staged, real)[0], staged_bytes=staged,
        bound_ms_both_rows_whole=bound(2 * e * d * 4 + e, real)[0],
        entry_point={k: {f: v[f] for f in ("ms", "cold_ms", "wall_ms",
                                           "cold_wall_ms", "bound_ms",
                                           "launches", "shape")}
                     for k, v in entry.items()})
    emit(line)
    emit(dict(phase="substrate_kernels", check="triangle_mask",
              edges=len(host12), equal=True,
              triangle_share=float(host12.mean()),
              scale14_edges=len(host14), scale14_equal=True,
              scale14_triangle_share=float(host14.mean()),
              scale14_host_mask_seconds=host14_s,
              bipartite_edges=len(hostbp), bipartite_equal=True,
              bipartite_triangle_share=float(hostbp.mean())))
    del au, av, flush
    torch.cuda.empty_cache()
    return lines + list(entry.values()) + [line]


def embedding_bag_cases(dev):
    """The reference test's (V, D, B, L) shapes with ids past the
    vocabulary, then the two-tower bags at full width on the card: the
    item-history bag (V = 2^24, D = 128, B = 65,536, L = 32, 8 GiB table)
    through `embedding_bag` as a user calls it, and the tag bag (V =
    100,000, D = 32, L = 8)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import ops

    def call(impl, table, ids):
        return impl.embedding_bag(table, ids, "sum")
    lines = []
    for v, d, b, l in [(64, 8, 16, 4), (512, 32, 100, 8), (1000, 16, 33, 12),
                       (2048, 64, 256, 1), (500, 16, 64, 6), (300, 13, 40, 40)]:
        rng = np.random.default_rng(v + d + b + l)
        table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32))
        ids = np.where(rng.random((b, l)) < 0.8, rng.integers(0, v, (b, l)),
                       -1).astype(np.int32)
        ids[0, 0] = v                                  # out of contract
        lines.append(substrate_compare(
            "embedding_bag_sum", call,
            (table.to(dev), torch.from_numpy(ids).to(dev)), 1e-5, 1e-5,
            (v, d, b, l)))
    gen = torch.Generator(device=dev).manual_seed(0)
    for v, d, l, main in [(1 << 24, 128, 32, True), (100_000, 32, 8, False)]:
        b = 65_536
        table = torch.randn(v, d, generator=gen, device=dev)
        ids = torch.randint(0, v, (b, l), generator=gen, device=dev,
                            dtype=torch.int32)
        lens = torch.randint(1, l + 1, (b, 1), generator=gen, device=dev)
        ids[torch.arange(l, device=dev)[None, :] >= lens] = -1
        real = int((ids >= 0).sum())
        safe, weight = ids.clamp(min=0), (ids >= 0).float()
        line = substrate_compare(
            "embedding_bag_sum", call, (table, ids), 1e-5, 1e-5, (v, d, b, l),
            cost=(4 * (b * l + real * d + b * d), real * d, OPS_PER_S),
            library=lambda: F.embedding_bag(safe, table, mode="sum",
                                            per_sample_weights=weight),
            plain_reps=(5, 3))
        if main:
            out, launches = drive_entry(
                "embedding_bag_sum", lambda: ops.embedding_bag(table, ids))
            check(out.shape == (b, d) and bool(torch.isfinite(out).all()),
                  "embedding_bag: bad output")
            line.update(launches=launches)
        line.update(real_ids=real)
        lines.append(line)
        del table, ids, lens, safe, weight
        torch.cuda.empty_cache()
    return lines


def dense_spmm_cases(dev):
    """The reference test's (B, N, F) shapes, N past 32, the kernel's
    two-stage ring (N = 400; with column chunks at N = 300, F = 200) and
    plain-load paths (N = 7 with F = 3; N = 333), bfloat16 inputs cast by
    the wrapper, then the molecule cell (128 graphs of 30 nodes, 64
    undirected edges each) through `densify_edges` and `dense_spmm` as a
    user calls them, held against the sparse `segment_spmm`, at F = 128
    (MeshGraphNet's d_hidden) and F = 32 (the cell's d_feat), where the
    kernel must stage whole graphs by bulk copy in one stage. Each line
    names the path the kernel took. Plain version and `torch.bmm` in full
    float32 (TF32 off)."""
    import numpy as np
    import torch
    from repro_torch.kernels.segment_spmm import ops
    torch.backends.cuda.matmul.allow_tf32 = False

    def call(impl, adj, x):
        # the plain version takes the float32 the wrapper casts to
        if impl is not ops:
            adj, x = adj.float(), x.float()
        return impl.dense_spmm(adj, x)
    lines = []
    for b, n, f, dtype in [(1, 8, 4, None), (8, 30, 16, None),
                           (17, 12, 32, None), (3, 70, 40, None),
                           (2, 100, 130, None), (4, 7, 3, None),
                           (3, 400, 128, None), (2, 300, 200, None),
                           (2, 40, 136, None),
                           (2, 333, 64, None),
                           (8, 30, 16, torch.bfloat16)]:
        rng = np.random.default_rng(b * n + f)
        adj = torch.from_numpy((rng.random((b, n, n)) < 0.3).astype(
            np.float32)).to(dev, dtype)
        x = torch.from_numpy(rng.normal(size=(b, n, f)).astype(
            np.float32)).to(dev, dtype)
        line = substrate_compare("dense_spmm", call, (adj, x), 1e-5, 1e-5,
                                 (b, n, f, str(adj.dtype)))
        line.update(path=ops.kernel_path(adj.float(), x.float()))
        lines.append(line)
    rng = np.random.default_rng(3)
    graphs, npg, und = 128, 30, 64
    pairs = np.stack([rng.choice(npg, 2, replace=False)
                      for _ in range(graphs * und)])
    gid = np.repeat(np.arange(graphs), und)
    src = np.concatenate([pairs[:, 0], pairs[:, 1]]) + np.tile(gid, 2) * npg
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]]) + np.tile(gid, 2) * npg
    src, dst, gid2 = (torch.from_numpy(a).to(dev)
                      for a in (src, dst, np.tile(gid, 2)))
    for f, main in [(128, True), (32, False)]:
        x = torch.from_numpy(rng.normal(size=(graphs, npg, f)).astype(
            np.float32)).to(dev)
        adj = ops.densify_edges(src, dst, graphs * npg, gid2, graphs, npg)
        path = ops.kernel_path(adj, x)
        check(path["bulk"] and not path["ring"],
              f"dense_spmm does not stage whole graphs by bulk copy at the "
              f"molecule cell (F = {f}): {path}")
        line = substrate_compare(
            "dense_spmm", call, (adj, x), 1e-5, 1e-5, (graphs, npg, f),
            cost=(4 * (graphs * npg * npg + 2 * graphs * npg * f),
                  2 * graphs * npg * npg * f, OPS_PER_S),
            library=lambda: torch.bmm(adj, x))
        line.update(path=path)
        if main:
            out, launches = drive_entry("dense_spmm", lambda: ops.dense_spmm(
                ops.densify_edges(src, dst, graphs * npg, gid2, graphs, npg),
                x))
            sparse = ops.segment_spmm(x.reshape(graphs * npg, f), src, dst,
                                      graphs * npg)
            check(bool(torch.allclose(out.reshape(graphs * npg, f), sparse,
                                      rtol=1e-5, atol=1e-5)),
                  "dense_spmm differs from segment_spmm on the molecules")
            line.update(launches=launches)
        line.update(tf32=torch.backends.cuda.matmul.allow_tf32)
        lines.append(line)
    return lines


# bfloat16 attention against its plain version: both read the same bf16
# inputs and compute in float32 (TF32 off), so they differ by the output's
# rounding (one bf16 ulp, at most 2^-7 of the value) and summation order.
# The typical output of a late causal row is about 0.03, so atol stays
# well under it, and the relative-norm check fails a kernel that is wrong
# only on the late rows.
BF16_RTOL, BF16_ATOL = 1e-2, 1e-3


def flash_attention_cases(dev):
    """The reference test's (BH, Sq, Sk, D, causal) shapes in float32,
    causal with Sq != Sk, bfloat16 at D = 64 (the tensor-core kernel) and
    at D = 48, 96 and 200 (the CUDA-core kernel's three bf16 versions),
    each checked for the kernel it took, then qwen3-14b's attention at
    `train_4k` (40 query heads over 8 kv heads expanded in `repeat_kv`'s
    order, D = 128, S = 4,096, batch 1, bfloat16, causal) through `mha` as
    a user calls it, which must take the tensor-core kernel. There the
    CUDA-core kernel, launched through the library at the same shape, is
    held to the plain version under the bf16 check and timed, and SDPA is
    held to the plain version under the same check, as information."""
    import math
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels._build import stream
    from repro_torch.kernels.flash_attention import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False

    def call(causal):
        return lambda impl, q, k, v: impl.flash_attention(q, k, v,
                                                          causal=causal)
    lines = []
    for bh, sq, sk, d, causal, dtype in [
            (2, 128, 128, 64, True, np.float32),
            (3, 100, 100, 32, True, np.float32),
            (1, 256, 256, 128, False, np.float32),
            (4, 64, 192, 64, False, np.float32),
            (2, 33, 70, 16, False, np.float32),
            (2, 33, 70, 16, True, np.float32),
            (2, 150, 40, 48, True, np.float32),
            (2, 128, 128, 64, True, "bf16"),
            (2, 150, 40, 48, True, "bf16"),
            (2, 100, 100, 96, True, "bf16"),
            (1, 90, 90, 200, True, "bf16")]:
        rng = np.random.default_rng(bh * sq + d)
        qkv = [torch.from_numpy(rng.normal(size=(bh, s, d)).astype(
            np.float32)).to(dev) for s in (sq, sk, sk)]
        rtol = atol = 2e-5
        if dtype == "bf16":
            qkv = [t.to(torch.bfloat16) for t in qkv]
            rtol, atol = BF16_RTOL, BF16_ATOL
        before = ops.LAUNCHES["flash_attention_wgmma"]
        lines.append(substrate_compare(
            "flash_attention", call(causal), qkv, rtol, atol,
            (bh, sq, sk, d, causal, str(qkv[0].dtype))))
        check(ops.LAUNCHES["flash_attention_wgmma"] - before
              == int(dtype == "bf16" and d in (64, 128)),
              f"flash_attention at {(bh, sq, sk, d, dtype)} took the wrong "
              f"kernel")
    b, s, h, kv, d = 1, 4096, 40, 8, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, s, kv, d, generator=gen, device=dev)
            .to(torch.bfloat16)[:, :, :, None, :]
            .expand(b, s, kv, h // kv, d).reshape(b, s, h, d)
            for _ in range(2))
    out, launches = drive_entry("flash_attention",
                                lambda: ops.mha(q, k, v, causal=True))
    wgmma_launches = ops.LAUNCHES["flash_attention_wgmma"]
    check(wgmma_launches == launches,
          "mha at train_4k did not take the tensor-core kernel")
    check(out.shape == (b, s, h, d) and bool(torch.isfinite(out).all()),
          "mha: bad output")
    qf, kf, vf = (t.transpose(1, 2).reshape(b * h, s, d).contiguous()
                  for t in (q, k, v))
    pairs = s * (s + 1) // 2                      # top-left causal pairs
    qh, kh, vh = (t.view(b, h, s, d) for t in (qf, kf, vf))
    shape = [b * h, s, s, d, True, "torch.bfloat16"]
    lib, core_out = ops.LIBRARY.load(), torch.empty_like(qf)

    def cuda_cores():
        err = lib.flash_attention_fwd(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), core_out.data_ptr(),
            b * h, s, s, d, 1.0 / math.sqrt(d), 1, 0, 1, stream())
        check(err == 0, f"the CUDA-core kernel's launch failed ({err})")

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    want = ref.flash_attention(qf, kf, vf, causal=True)
    cuda_cores()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(core_out).all()),
          f"the CUDA-core kernel: non-finite at {shape}")
    err, rel, ok = close(core_out, want, BF16_RTOL, BF16_ATOL)
    check(ok, f"the CUDA-core kernel differs from the plain version by "
          f"{err} (relative norm {rel}) at {shape}")
    core = dict(phase="substrate_kernels", name="flash_attention",
                kernel="CUDA-core (flash_attention_fwd)", shape=shape,
                max_abs_err=err, rel_norm_err=rel, rtol=BF16_RTOL,
                atol=BF16_ATOL)
    err, rel, ok = close(sdpa().view(b * h, s, d), want, BF16_RTOL,
                         BF16_ATOL)
    emit(dict(phase="substrate_kernels", check="sdpa_vs_plain", shape=shape,
              max_abs_err=err, rel_norm_err=rel, within_bf16_check=ok))
    del want
    line = substrate_compare(
        "flash_attention", call(True), (qf, kf, vf), BF16_RTOL, BF16_ATOL,
        tuple(shape),
        cost=(4 * b * h * s * d * 2, 4 * b * h * pairs * d, BF16_OPS_PER_S),
        library=sdpa, plain_reps=(3, 2))
    core["ms"] = cuda_ms(cuda_cores, 5, 3)[0]
    torch.cuda.synchronize()
    emit(core)
    line.update(launches=launches, wgmma_launches=wgmma_launches,
                earlier_ms=core["ms"], earlier="CUDA-core kernel",
                half_bound_reached=line["ms"] <= 2 * line["bound_ms"],
                model="qwen3-14b", cell="train_4k")
    lines.append(line)
    del q, k, v, qf, kf, vf, qh, kh, vh, out, core_out
    torch.cuda.empty_cache()
    return lines


def substrate_kernels(dev, g12, g14):
    """The four substrate kernels: each against its plain version at edge
    shapes and at full width, its entry point driven once with its launch
    count read. Returns the lines by kernel; frees the full-width tensors
    (the 8 GiB table, the 2.7 GB score matrix) before the engine phases."""
    import torch
    t0 = time.perf_counter()
    lines = {"has_common_neighbor": common_neighbor_cases(dev, g12, g14),
             "embedding_bag_sum": embedding_bag_cases(dev),
             "dense_spmm": dense_spmm_cases(dev),
             "flash_attention": flash_attention_cases(dev)}
    torch.cuda.empty_cache()
    emit(dict(phase="substrate_kernels_done",
              cases={k: len(v) for k, v in lines.items()},
              seconds=time.perf_counter() - t0))
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
        for backend, dr in itertools.product(("pivot", "hybrid", "rcd"),
                                             (True, False)):
            t0 = time.perf_counter()
            res = run(g, backend=backend, dynamic_red=dr,
                      enumerate_cliques=True,
                      bucket_sizes=(32, 64, 128, 256), device=dev)
            secs = time.perf_counter() - t0
            got = (res.cliques, res.calls, res.branches, res.sum_px)
            what = f"{name} backend={backend} dynamic_red={dr}"
            check(not res.overflow and not res.iters_exhausted,
                  f"{what}: overflow/truncated")
            check(len(res.enumerated) == res.cliques
                  and set(res.enumerated) == truth,
                  f"{what}: clique set differs from oracle")
            want = BRANCHING_EXPECT.get((backend, name, dr))
            check(want is None or got == want,
                  f"{what}: {got} != reference {want}")
            emit(dict(phase="small_graph", graph=name, backend=backend,
                      dynamic_red=dr, cliques=res.cliques, calls=res.calls,
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
    ops.LAUNCHES.reset()
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
        line.update({k: st[k] for k in WINDOW_STATS},
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


ROW_KERNELS = ("frame_step", "and_popcount_rows", "and_popcount_argmax")
HYBRID_KERNELS = ROW_KERNELS + ("clique_counts",)
RCD_KERNELS = ("frame_step", "and_popcount_rows", "and_popcount_many")


def scale11_paths(dev, g):
    """The per-root slice, the pivot lanes, `auto`, and the 'hybrid' and
    'rcd' backends per root on the scale-11 graph, then the 'rcd' lanes
    on scale 10; returns each path's launches."""
    from repro_torch.graph.generators import kronecker
    graph = "kron:scale=11,ef=16,seed=0"
    out = {}
    out["slice"] = drive(dev, g, "slice", graph, SLICE11_EXPECT, ROW_KERNELS)
    out["persistent"] = drive(dev, g, "persistent", graph, SLICE11_EXPECT,
                              ROW_KERNELS, PERSISTENT11_STATS,
                              engine="persistent")
    out["auto"] = drive(dev, g, "auto", graph, SLICE11_EXPECT, ROW_KERNELS,
                        engine="auto")
    out["hybrid_perroot"] = drive(dev, g, "hybrid_perroot", graph,
                                  HYBRID11_EXPECT, HYBRID_KERNELS,
                                  backend="hybrid")
    out["rcd_perroot"] = drive(dev, g, "rcd_perroot", graph, RCD11_EXPECT,
                               RCD_KERNELS, backend="rcd")
    out["rcd_persistent"] = drive(
        dev, kronecker(10, 16, seed=0), "rcd_persistent",
        "kron:scale=10,ef=16,seed=0", RCD10_EXPECT, RCD_KERNELS, RCD10_STATS,
        backend="rcd", engine="persistent")
    return out


def scale12_paths(dev, g):
    """The 'hybrid' lanes and the fused window walks (lanes and per root)
    on the scale-12 graph; returns each path's launches."""
    graph = "kron:scale=12,ef=16,seed=0"
    out = {}
    out["hybrid_persistent"] = drive(
        dev, g, "hybrid_persistent", graph, SLICE_EXPECT, HYBRID_KERNELS,
        HYBRID_STATS, backend="hybrid", engine="persistent")
    out["persistent_window"] = drive(
        dev, g, "persistent_window", graph, WINDOW_EXPECT,
        ("dfs_step_window_lanes",), WINDOW_STATS, engine="persistent",
        dynamic_red=False, window_steps=16)
    out["perroot_window"] = drive(
        dev, g, "perroot_window", graph, WINDOW_EXPECT, ("dfs_step_window",),
        dynamic_red=False, window_steps=16)
    return out


def driver_path(dev, g):
    """The driver path: `DistributedMCE(g, device=dev, chunk=512)` with
    mce_run's other defaults (streamed, per root, pivot) on the scale-11
    graph, on one rank, with the kernels' launch counts set to 0 just
    before and read just after; its counters against run()'s and the
    reference driver's occupancy pair, and the row kernels launched."""
    from repro_torch.core.driver import DistributedMCE
    from repro_torch.kernels.bitset_ops import ops
    ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    drv = DistributedMCE(g, device=dev, chunk=512)
    res = drv.run()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    got = dict(cliques=res.cliques, calls=res.calls, branches=res.branches,
               sum_px=res.sum_px, pre_reported=res.pre_reported)
    lc, st = drv.last_counters, drv.stats
    emit(dict(phase="driver", graph="kron:scale=11,ef=16,seed=0", n=g.n,
              m=g.m, chunk=drv.chunk, shards=drv.n_shards,
              device=str(drv.device), **got,
              iters_exhausted=res.iters_exhausted, seconds=secs,
              buckets=drv.stream.num_buckets, chunks=st["chunks"],
              device_wait_s=st["device_wait_s"],
              host_pack_s=st["host_pack_s"], dispatch_s=st["dispatch_s"],
              overlap_fraction=drv.overlap_fraction,
              lane_occupancy=lc["live_iters"] / max(lc["lane_iters"], 1),
              counters=lc, prep_timings=dict(drv.stream.timings),
              launches=launches))
    check(got == SLICE11_EXPECT,
          f"driver counters {got} != {SLICE11_EXPECT}")
    check(not res.iters_exhausted, "driver truncated")
    for k, v in SERVICE11_STATS["pivot"].items():
        if k != "engine_choices":
            check(lc[k] == v,
                  f"driver counter {k}: {lc[k]} != reference {v}")
    for name in ROW_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the driver path")
    return launches


def service_paths(dev, g):
    """One `MCEService` on the scale-11 graph (chunk 512) and three
    queries: pivot (cold: streams and packs), hybrid and pivot with
    reuse_degrees=False (both cached: they must pack nothing, so the
    stream's timings and bucket count stay as the first query left them).
    Each query is a path: launch counts set to 0 just before and read
    just after, counters and per-query stats against the reference's."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.kernels.bitset_ops import ops
    from repro_torch.launch.mce_service import MCEService
    svc = MCEService(g, device=dev, chunk=512)
    out, packed = {}, None
    for label, cfg, expect, kernels in (
            ("pivot", {}, SLICE11_EXPECT, ROW_KERNELS),
            ("hybrid", dict(backend="hybrid"), HYBRID11_EXPECT,
             HYBRID_KERNELS),
            ("pivot_reuse_off", dict(reuse_degrees=False),
             REUSE_OFF11_EXPECT, ROW_KERNELS)):
        ops.LAUNCHES.reset()
        t0 = time.perf_counter()
        res = svc.query(EngineConfig(**cfg))
        secs = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        got = dict(cliques=res.cliques, calls=res.calls,
                   branches=res.branches, sum_px=res.sum_px,
                   pre_reported=res.pre_reported)
        pack = dict(timings=dict(svc.stream.timings),
                    num_buckets=svc.stream.num_buckets)
        emit(dict(phase="service", graph="kron:scale=11,ef=16,seed=0",
                  query=label, cfg=cfg, cold=packed is None, **got,
                  stats=res.stats, seconds=secs,
                  occupancy=res.stats["live_iters"]
                  / max(res.stats["lane_iters"], 1),
                  stream=pack, launches=launches))
        check(got == expect, f"service {label} counters {got} != {expect}")
        check(res.stats == SERVICE11_STATS[label],
              f"service {label} stats {res.stats} != reference "
              f"{SERVICE11_STATS[label]}")
        if packed is None:
            packed = pack
        check(pack == packed, f"service {label} packed again: {pack}")
        for name in kernels:
            check(launches[name] > 0,
                  f"kernel {name} was not launched on service {label}")
        out[f"service_{label}"] = launches
    return out


# --------------------------------------------------------------------------
# phase 10: serving the substrate models
# --------------------------------------------------------------------------

# the full-width serving requests: qwen3-14b's four prompts of 2,048 tokens
# and 32 new tokens; the two-tower model's serve_p99 batch (512) and
# retrieval_cand corpus (1,000,000), configs/two_tower_retrieval.py:23-26
LM_SERVE = dict(batch=4, prompt_len=2048, new_tokens=32)
RECSYS_SERVE = dict(batch=512, n_candidates=1_000_000, top_k=10)


def bf16_logits_check(got, want, what):
    """The bf16 check of two runs of one model: relative norm <= 2e-2, and
    greedy picks equal wherever `want`'s top-2 margin exceeds 2e-2 of the
    row's largest |logit|. Returns (relative norm, rows compared)."""
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    rel = float((got - want).norm() / want.norm())
    check(rel <= 2e-2, f"{what}: logits relative norm {rel} > 2e-2")
    top2 = want.topk(2, dim=-1).values
    sure = top2[..., 0] - top2[..., 1] > 2e-2 * want.abs().amax(-1)
    check(torch.equal(got.argmax(-1)[sure], want.argmax(-1)[sure]),
          f"{what}: greedy picks differ where the margin is wide")
    return rel, int(sure.sum())


class Recorder:
    """Wraps a module's function while in a `with`: counts its calls in
    `n` and keeps the arguments of the first call for which `keep(*args)`
    is true in `args`."""

    def __init__(self, module, name, keep=lambda *a: True):
        self.module, self.name, self.keep = module, name, keep
        self.real, self.n, self.args = getattr(module, name), 0, None

    def __enter__(self):
        def wrapper(*args, **kw):
            self.n += 1
            if self.args is None and self.keep(*args):
                self.args = args
            return self.real(*args, **kw)
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def serve_lm_full_width(dev):
    """qwen3-14b at build() (40 layers, bfloat16, random weights from seed
    0) served through `serve_lm` as a user calls it: a warm-up request,
    then LM_SERVE with the launch counts set to 0 just before. The
    prefill must launch the tensor-core flash kernel once per layer; the
    kernel is then held against its plain version on the prefill's own
    first-layer q, k_exp, v_exp. Returns the serve line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = get_arch("qwen3-14b").build()
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = torch.cuda.memory_allocated(dev)
    serve.serve_lm("qwen3-14b", **{**LM_SERVE, "new_tokens": 2}, device=dev,
                   params=model)                                # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    ops.LAUNCHES.reset()
    with Recorder(ops, "mha") as rec:
        res = serve.serve_lm("qwen3-14b", **LM_SERVE, device=dev,
                             params=model)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    gen = res["generated"]
    check(gen.shape == (LM_SERVE["batch"], LM_SERVE["new_tokens"])
          and gen.min() >= 0 and gen.max() < cfg.vocab,
          f"serve_lm: bad tokens {gen.shape}")
    check(launches["flash_attention_wgmma"] == cfg.n_layers
          == launches["flash_attention"] == rec.n,
          f"serve_lm: the prefill launched {launches} for {cfg.n_layers} "
          f"layers")
    profiles = lm_profiles(dev, cfg, model)
    q, k, v = rec.args
    del rec
    b, s, h, d = q.shape
    qf, kf, vf = (t.transpose(1, 2).reshape(b * h, s, d).contiguous()
                  for t in (q, k, v))
    qh, kh, vh = (t.view(b, h, s, d) for t in (qf, kf, vf))
    pairs = s * (s + 1) // 2
    check_line = substrate_compare(
        "flash_attention",
        lambda impl, q_, k_, v_: impl.flash_attention(q_, k_, v_,
                                                      causal=True),
        (qf, kf, vf), BF16_RTOL, BF16_ATOL, (b * h, s, s, d, True,
                                              str(q.dtype)),
        cost=(4 * b * h * s * d * 2, 4 * b * h * pairs * d, BF16_OPS_PER_S),
        library=lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       is_causal=True),
        plain_reps=(3, 2), phase="serve")
    del q, k, v, qf, kf, vf, qh, kh, vh, model
    torch.cuda.empty_cache()
    p = LM_SERVE
    n, tokens = LM_SERVE["batch"], LM_SERVE["batch"] * LM_SERVE["prompt_len"]
    matrix_params = cfg.param_count() - 2 * cfg.vocab * cfg.d_model
    attn_ops = cfg.n_layers * 4 * n * cfg.n_heads * pairs * d
    # decode: every weight but the embedding table once a token (bf16),
    # and the cache at its longest
    cache_bytes = 2 * 2 * cfg.n_layers * n * (p["prompt_len"]
                                              + p["new_tokens"]) \
        * cfg.n_kv_heads * cfg.d_head
    return dict(
        phase="serve", model="qwen3-14b", config="build()",
        depth=cfg.n_layers, reduced=None, dtype=cfg.dtype,
        params=cfg.param_count(), weight_bytes=weight_bytes, init_s=init_s,
        **p, prefill_s=res["prefill_s"], decode_s=res["decode_s"],
        tok_per_s=res["tok_per_s"],
        decode_ms_per_step=1e3 * res["decode_s"] / p["new_tokens"],
        peak_bytes=peak, launches=launches, profiles=profiles,
        prefill_bound_s=(2 * tokens * matrix_params + attn_ops)
        / BF16_OPS_PER_S,
        decode_bound_ms=1e3 * (2 * (cfg.param_count()
                                    - cfg.vocab * cfg.d_model)
                               + cache_bytes) / HBM_BYTES_PER_S,
        flash_check=dict((k, check_line[k]) for k in (
            "max_abs_err", "rel_norm_err", "ms", "plain_ms", "library_ms",
            "bound_ms")),
        generated_head=gen[:, :8].tolist())


def lm_profiles(dev, cfg, model):
    """Where a request's time goes (`device_profile`): one decode step at
    the conversation's last position and one prefill of LM_SERVE's
    shape, each the card's kernel time against the host's wall time."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_steps import make_prefill_step
    p = LM_SERVE
    total = p["prompt_len"] + p["new_tokens"]
    cache = T.init_cache(cfg, p["batch"], total, device=dev)
    cache["pos"] = total - 1
    tok = torch.zeros(p["batch"], 1, dtype=torch.int64, device=dev)
    prompts = torch.zeros(p["batch"], p["prompt_len"], dtype=torch.int32,
                          device=dev)
    out = {}
    for name, run_once in (
            ("decode_step", lambda: T.decode_step(cfg, model, cache, tok)),
            ("prefill", lambda: make_prefill_step(cfg)(model, prompts))):
        _, wall, profiled, busy, n_k, _ = device_profile(run_once)
        out[name] = dict(ms=1e3 * wall, profiled_ms=1e3 * profiled,
                         busy_ms=1e3 * busy, kernels=n_k,
                         device_idle_share=1.0 - busy / wall)
    del cache
    return out


def serve_lm_against_cpu(dev):
    """qwen3-14b's build() cut to 2 layers, one set of weights made from a
    seed on the card and copied to the host: batch 2, prompt 64, then 4
    decode steps fed the CPU's greedy tokens, on the card and on the CPU;
    every step under the bf16 check."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_steps import make_prefill_step
    cfg = dataclasses.replace(get_arch("qwen3-14b").build(), n_layers=2)
    card = T.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    host = copy.deepcopy(card).to("cpu")
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    t0 = time.perf_counter()
    runs = {}
    for name, model, device in (("cpu", host, "cpu"), ("card", card, dev)):
        logits, cache = make_prefill_step(cfg)(model, prompts.to(device))
        full = T.init_cache(cfg, 2, 68, device=device)
        full["k"][:, :, :64] = cache["k"]
        full["v"][:, :, :64] = cache["v"]
        cache = dict(k=full["k"], v=full["v"], pos=64)
        steps = [logits.float().cpu()]
        for i in range(4):
            tok = runs["cpu"][i].argmax(-1)[:, None] if name == "card" \
                else steps[-1].argmax(-1)[:, None]
            logits, cache = T.decode_step(cfg, model, cache, tok.to(device))
            steps.append(logits[:, -1].float().cpu())
        runs[name] = steps
        if name == "cpu":
            cpu_s = time.perf_counter() - t0
    rels, compared = [], 0
    for i, (got, want) in enumerate(zip(runs["card"], runs["cpu"])):
        rel, n = bf16_logits_check(got, want, f"qwen3-14b 2 layers, step {i}")
        rels.append(rel)
        compared += n
    del card, host
    torch.cuda.empty_cache()
    return dict(config="build(), n_layers=2", batch=2, prompt_len=64,
                decode_steps=4, rel_norm_err=rels, greedy_rows_compared=compared,
                rows=10, cpu_s=cpu_s)


def serve_recsys_full_width(dev):
    """two-tower-retrieval at build() (25.8 GB of float32 tables, random
    weights from seed 0) through `serve_recsys` as a user calls it: a
    warm-up, then RECSYS_SERVE with the bag kernel's count set to 0 just
    before; the retrieval's tag bag held against the plain version on its
    own operands; the smoke config on the card against the same weights
    on the CPU. Returns the serve line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.launch import serve
    from repro_torch.models import recsys as R
    cfg = get_arch("two-tower-retrieval").build()
    t0 = time.perf_counter()
    model = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = torch.cuda.memory_allocated(dev)
    serve.serve_recsys(**RECSYS_SERVE, device=dev, params=model)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    ops.LAUNCHES.reset()
    n_cand = RECSYS_SERVE["n_candidates"]
    with Recorder(ops, "embedding_bag",
                  lambda table, ids, *a: ids.shape[0] == n_cand) as rec:
        res = serve.serve_recsys(**RECSYS_SERVE, device=dev, params=model)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    # retrieval: the user's history bag and the candidates' tag bag;
    # online scoring: the history bag
    check(launches["embedding_bag_sum"] == rec.n == 3
          and rec.args is not None,
          f"serve_recsys launched {launches} in {rec.n} bags")
    check(res["top_idx"].shape == (RECSYS_SERVE["top_k"],)
          and bool((res["top_scores"][:-1] >= res["top_scores"][1:]).all()),
          "serve_recsys: bad top-k")
    table, ids = rec.args[0].detach(), rec.args[1]
    del rec
    b, l = ids.shape
    real = int((ids >= 0).sum())
    count = (ids >= 0).sum(1, keepdim=True).clamp(min=1)
    safe, weight = ids.clamp(min=0), ((ids >= 0) / count).float()
    tag_line = substrate_compare(
        "embedding_bag_sum",
        lambda impl, t, i: impl.embedding_bag(t, i, "mean"), (table, ids),
        1e-5, 1e-5, (table.shape[0], table.shape[1], b, l, "mean"),
        cost=(4 * (b * l + real * table.shape[1] + b * table.shape[1]),
              real * table.shape[1], OPS_PER_S),
        library=lambda: F.embedding_bag(safe, table, mode="sum",
                                        per_sample_weights=weight),
        plain_reps=(5, 3), phase="serve")
    del table, ids, safe, weight, count, model
    torch.cuda.empty_cache()
    # the smoke config: one set of weights, the card against the CPU
    scfg = get_arch("two-tower-retrieval").build_smoke()
    small = R.init_params(scfg, torch.Generator().manual_seed(0))
    want = serve.serve_recsys(device="cpu", params=small)
    got = serve.serve_recsys(device=dev, params=small.to(dev))
    check(bool((got["top_idx"] == want["top_idx"]).all()),
          f"two-tower smoke top-k on the card {got['top_idx']} != CPU "
          f"{want['top_idx']}")
    smoke_err = {}
    for key in ("top_scores", "serve_scores"):
        err = float(abs(got[key] - want[key]).max())
        check(err <= 1e-5 + 1e-5 * float(abs(want[key]).max()),
              f"two-tower smoke {key}: card against CPU {err}")
        smoke_err[key] = err
    p = RECSYS_SERVE
    return dict(
        phase="serve", model="two-tower-retrieval", config="build()",
        reduced=None, params=cfg.param_count(), weight_bytes=weight_bytes,
        init_s=init_s, **p, retrieval_s=res["retrieval_s"],
        serve_s=res["serve_s"], qps=res["qps"], peak_bytes=peak,
        launches=launches, top_idx=res["top_idx"].tolist(),
        tag_bag_check=dict((k, tag_line[k]) for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms")),
        smoke_card_vs_cpu=dict(top_idx_equal=True, **smoke_err))


def serve_phase(dev):
    """The serving path of the substrates at full width: qwen3-14b's prefill
    on the flash kernel and decode, checked against the CPU at two layers;
    the two-tower retrieval and online scoring on the bag kernel. Returns
    the kernels' launches in the two measured requests."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = serve_lm_full_width(dev)
    lm["cpu_check"] = serve_lm_against_cpu(dev)
    emit(lm)
    rec = serve_recsys_full_width(dev)
    emit(rec)
    secs = time.perf_counter() - t0
    emit(dict(phase="serve_done", seconds=secs))
    return {"flash_attention": lm["launches"]["flash_attention"],
            "embedding_bag_sum": rec["launches"]["embedding_bag_sum"]}


# --------------------------------------------------------------------------
# phase 11: training the substrate models
# --------------------------------------------------------------------------

# qwen3-14b at build() widths cut to 2 of its 40 layers, one sequence of
# the train_4k cell's 4,096 tokens (its global batch of 256 cut to 1);
# two-tower-retrieval at build() widths with 2^22 users and items (dense
# AdamW over the full 25.8 GB of tables would need about 103 GB) and a
# batch of 16,384 (train_batch's 65,536 makes 17 GB of in-batch logits)
LM_TRAIN = dict(n_layers=2, batch=1, seq=4096, steps=3)
RECSYS_TRAIN = dict(n_users=1 << 22, n_items=1 << 22, batch=16_384, steps=3)
# the backward kernels: kernel -> (package, source, the reference function
# whose XLA-differentiated gradient it computes; no TPU kernel)
BACKWARD = {
    "flash_attention_bwd": (
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/models/layers.py:93"),
    "embedding_bag_sum_bwd": (
        "embedding_bag",
        "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
        "src/repro/models/recsys.py:72"),
}


def train_steps(step, dev, batches, n):
    """`n` calls of `step(batch(i))` (the step updates its model in place),
    each with every substrate kernel's count set to 0 just before and read
    just after. Returns (losses, seconds, launches) a step."""
    import torch
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    losses, secs, launches = [], [], []
    for i in range(n):
        batch = batches(i)
        for ops in (flash_ops, bag_ops):
            ops.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        launches.append({**flash_ops.LAUNCHES, **bag_ops.LAUNCHES})
    check(all(map(math.isfinite, losses)), f"non-finite losses {losses}")
    return losses, secs, launches


def train_kernel_group(name):
    """A training step's kernels by what they compute: the substrate
    kernels by name (the tensor-core backward's three passes are
    `bwd90::rows_kernel`, `dkdv_kernel` and `dq_kernel`; the CUDA-core
    backward's first pass is the CUDA-core forward's STATS instance:
    `flash_attention_kernel<T, D, true>`, mangled `...ELb1E...`), cuBLAS's
    products, the rest (elementwise, reductions, copies, AdamW)."""
    if "bwd90" in name or "dkdv_kernel" in name or "dq_kernel" in name or (
            "flash_attention_kernel" in name
            and ("Lb1E" in name or ", true>" in name)):
        return "flash_attention_bwd"
    for kernel in ("flash_attention", "embedding_bag_sum_bwd",
                   "embedding_bag_sum"):
        if kernel in name:
            return kernel
    low = name.lower()
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matrix products"
    return "other"


def train_profile(one, batch):
    """One more training step under `device_profile`: wall and busy ms,
    the idle share, the busy ms by `train_kernel_group` and of the eight
    kernels that take the most."""
    _, plain_wall, wall, busy, n, by_name = device_profile(
        lambda: one(batch))
    split = {}
    for name, sec in by_name.items():
        group = train_kernel_group(name)
        split[group] = split.get(group, 0.0) + sec

    def ms(d, k=None):
        return {name[:90]: 1e3 * v for name, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:k]}
    return dict(ms=1e3 * plain_wall, profiled_ms=1e3 * wall,
                busy_ms=1e3 * busy, kernels=n,
                device_idle_share=1.0 - busy / plain_wall,
                busy_ms_by_group=ms(split), top_kernels_ms=ms(by_name, 8))


def every_gradient(model, loss):
    """Backward of `loss`; fails unless every parameter of `model` has a
    finite gradient with a non-zero norm. Returns the norms by name."""
    import torch
    for p in model.parameters():
        p.grad = None
    loss.backward()
    norms = {}
    for name, p in model.named_parameters():
        check(p.grad is not None, f"{name} has no gradient")
        norms[name] = float(p.grad.float().norm())
        check(math.isfinite(norms[name]) and norms[name] > 0,
              f"{name}: gradient norm {norms[name]}")
        p.grad = None
    torch.cuda.synchronize()
    return norms


def flash_bwd_check(dev, q, k, v, name_power):
    """The backward kernels against the plain backward on layer 0's own q,
    k, v of a training step (GQA-expanded, (B, S, H, D) bf16) and a seeded
    dO, under the bf16 check: the tensor-core passes (what the step runs)
    and the CUDA-core passes forced on the same inputs. Timed in turns
    (tensor cores, CUDA cores, CUDA cores, tensor cores) beside the bound
    (5 Sq Sk D BH FLOP, causal, at the bf16 rate), the plain version and
    SDPA's backward through autograd. Returns the kernel-table line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    b, s, h, d = q.shape
    qf, kf, vf = (t.detach().transpose(1, 2).reshape(b * h, s, d)
                  .contiguous() for t in (q, k, v))
    gen = torch.Generator(device=dev).manual_seed(3)
    do = torch.randn(qf.shape, generator=gen, device=dev).to(qf.dtype)

    def new():
        return ops.flash_attention_bwd(qf, kf, vf, do, causal=True)

    def old():
        return ops._backward(qf, kf, vf, do, True, cuda_cores=True)
    want = ref.flash_attention_bwd(qf, kf, vf, do, causal=True)
    errors = {}
    for label, fn, tc in (("tensor cores", new, 3), ("CUDA cores", old, 0)):
        before = ops.LAUNCHES["flash_attention_bwd_wgmma"]
        got = fn()
        torch.cuda.synchronize()
        check(ops.LAUNCHES["flash_attention_bwd_wgmma"] - before == tc,
              f"flash_attention_bwd ({label}) took the wrong kernels")
        errs, rels = [], []
        for g, w, what in zip(got, want, ("dq", "dk", "dv")):
            check(g.dtype == w.dtype == qf.dtype
                  and bool(torch.isfinite(g).all()),
                  f"flash_attention_bwd ({label}) {what}: {g.dtype} or "
                  f"non-finite")
            err, rel, ok = close(g, w, BF16_RTOL, BF16_ATOL)
            check(ok, f"flash_attention_bwd ({label}) {what} differs from "
                  f"the plain backward by {err} (relative norm {rel})")
            errs.append(err)
            rels.append(rel)
        errors[label] = (errs, rels)
        del got
    again = new()
    check(all(bool(torch.equal(a, b)) for a, b in zip(again, new())),
          "flash_attention_bwd: two calls differ")
    del want, again
    torch.cuda.empty_cache()
    lq, lk, lv = (t.view(b, h, s, d).detach().requires_grad_()
                  for t in (qf, kf, vf))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    lib_do = do.view(b, h, s, d)
    turns = [cuda_ms(new, 5, 3)[0], cuda_ms(old, 3, 1)[0],
             cuda_ms(old, 3, 1)[0], cuda_ms(new, 5, 3)[0]]
    plain_ms = cuda_ms(lambda: ref.flash_attention_bwd(qf, kf, vf, do,
                                                       causal=True), 3, 2)[0]
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (lq, lk, lv), lib_do, retain_graph=True), 5, 3)[0]
    bound_ms, bound_by = bound(0, 5 * s * s * d * b * h, BF16_OPS_PER_S)
    ms, earlier_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    check(ms < earlier_ms, f"the tensor-core backward ({ms} ms) is not "
          f"faster than the CUDA-core one ({earlier_ms} ms)")
    line = dict(phase="train", check="flash_attention_bwd",
                shape=[b * h, s, s, d, True, str(qf.dtype)],
                max_abs_err=max(errors["tensor cores"][0]),
                rel_norm_err=errors["tensor cores"][1],
                earlier_max_abs_err=max(errors["CUDA cores"][0]),
                earlier_rel_norm_err=errors["CUDA cores"][1],
                rtol=BF16_RTOL, atol=BF16_ATOL, deterministic=True, ms=ms,
                earlier_ms=earlier_ms,
                earlier="CUDA-core backward, forced",
                in_turns_ms=dict(order="new, old, old, new", ms=turns),
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, name_power=name_power)
    emit(line)
    del lib_out, lq, lk, lv
    torch.cuda.empty_cache()
    return line


def train_lm_full_width(dev, name_power):
    """qwen3-14b at build() widths cut to LM_TRAIN's depth, float32 master
    weights from seed 0, bf16 compute, the default remat: LM_TRAIN's
    steps of `lm_steps.make_train_step` on `data.TokenStream`'s batches.
    Each step must launch the flash forward twice a layer (forward and
    remat's recompute, the tensor-core kernel) and the backward's three
    tensor-core passes once a layer; one more backward must reach every
    parameter
    (wq, wk, wv, q_norm and k_norm through the backward kernels); then
    the backward kernels are held against the plain backward on layer 0's
    own q, k, v. Returns (the line, the flash_attention_bwd table line)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_steps import make_train_step
    from repro_torch.optim import adamw_init
    p = LM_TRAIN
    cfg = dataclasses.replace(get_arch("qwen3-14b").build(),
                              n_layers=p["n_layers"])
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          dtype=torch.float32)
    opt = adamw_init(dict(model.named_parameters()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stream = TokenStream(cfg.vocab, p["seq"], p["batch"], seed=0)
    step = make_train_step(cfg)
    state = dict(model=model, opt=opt)

    def one(batch):
        state["model"], state["opt"], loss = step(state["model"],
                                                  state["opt"], *batch)
        return loss

    def batches(i):
        return tuple(torch.from_numpy(a).to(dev) for a in stream.batch(i))
    torch.cuda.reset_peak_memory_stats(dev)
    with Recorder(ops, "mha") as rec:
        losses, secs, launches = train_steps(one, dev, batches, p["steps"])
    peak = torch.cuda.max_memory_allocated(dev)
    n = cfg.n_layers
    for got in launches:
        check(got["flash_attention"] == got["flash_attention_wgmma"] == 2 * n
              and got["flash_attention_bwd"]
              == got["flash_attention_bwd_wgmma"] == 3 * n,
              f"qwen3-14b train step launched {got} for {n} layers")
    profile = train_profile(one, batches(p["steps"]))
    norms = every_gradient(model, T.lm_loss(cfg, model, *batches(p["steps"])))
    q, k, v = (t.detach() for t in rec.args)
    del rec, state, opt, model
    torch.cuda.empty_cache()
    witness = train_lm_witness(dev, cfg, batches, losses)
    table_line = flash_bwd_check(dev, q, k, v, name_power)
    del q, k, v
    torch.cuda.empty_cache()
    tokens = p["batch"] * p["seq"]
    return dict(
        phase="train", model="qwen3-14b", config="build()",
        depth=cfg.n_layers, reduced=dict(n_layers="40 -> 2",
                                         global_batch="256 -> 1"),
        storage="float32", compute=cfg.dtype, remat=cfg.remat,
        params=cfg.param_count(), init_s=init_s, **p, losses=losses,
        step_s=secs, tok_per_s=[tokens / t for t in secs], peak_bytes=peak,
        launches_per_step=launches, witness=witness,
        profile=profile, attention_grad_norms={
            k: v for k, v in norms.items()
            if k.split(".")[-1] in ("wq", "wk", "wv", "q_norm", "k_norm")},
        name_power=name_power), table_line


def train_lm_witness(dev, cfg, batches, losses):
    """Two more runs of LM_TRAIN's steps from the same weights (seed 0)
    and batches, against the kernel run's `losses`: the attention on the
    plain `blockwise_attention`, forward and backward by autograd (the
    reference's training attention; no flash launch), and the kernels at
    a tenth of the learning rate. Each loss of the plain run must be the
    kernel run's within 1e-2 relative (the same weights, the attention
    rounded otherwise). Returns the losses of both."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_steps import make_train_step
    from repro_torch.optim import adamw_init
    out = {}
    for name, lr, flash in (("plain_attention", 3e-4, False),
                            ("lr_3e-5", 3e-5, True)):
        gen = torch.Generator(device=dev).manual_seed(0)
        model = T.init_params(cfg, gen, dtype=torch.float32)
        state = dict(model=model,
                     opt=adamw_init(dict(model.named_parameters())))
        step = make_train_step(cfg, lr=lr)

        def one(batch):
            state["model"], state["opt"], loss = step(state["model"],
                                                      state["opt"], *batch)
            return loss
        takes_flash = T.takes_flash
        if not flash:
            T.takes_flash = lambda *a, **kw: False
        try:
            got, secs, launches = train_steps(one, dev, batches,
                                              LM_TRAIN["steps"])
        finally:
            T.takes_flash = takes_flash
        for n in launches:
            check((n["flash_attention"] > 0) == flash,
                  f"qwen3-14b {name} run launched {n}")
        out[name] = dict(losses=got, step_s=secs)
        del state, model, step
        torch.cuda.empty_cache()
    plain = out["plain_attention"]["losses"]
    check(all(abs(p - k) <= 1e-2 * abs(k) for p, k in zip(plain, losses)),
          f"qwen3-14b losses {losses} on the kernels, {plain} on the plain "
          f"attention")
    return out


def train_lm_against_cpu(dev):
    """A two-layer narrow qwen3 (d_head 128, so the card's forward takes
    the tensor-core kernel; float32 master weights, bf16 compute), one set
    of weights made on the CPU from a seed: the loss and every parameter's
    gradient on the card against the CPU, each gradient under relative
    norm 2e-2."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch("qwen3-14b").build_smoke(),
                              d_model=256, n_heads=4, n_kv_heads=2,
                              d_head=128, d_ff=512, vocab=1024)
    host = T.init_params(cfg, torch.Generator().manual_seed(1),
                         dtype=torch.float32)
    card = copy.deepcopy(host).to(dev)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 256)).astype(np.int32))
    grads, losses = [], []
    for model, device in ((host, "cpu"), (card, dev)):
        ops.LAUNCHES.reset()
        loss = T.lm_loss(cfg, model, toks.to(device),
                         toks.roll(-1, 1).to(device))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters()})
    check(ops.LAUNCHES["flash_attention_wgmma"] == 2 * cfg.n_layers
          and ops.LAUNCHES["flash_attention_bwd"]
          == ops.LAUNCHES["flash_attention_bwd_wgmma"] == 3 * cfg.n_layers,
          f"the narrow config's card run launched {dict(ops.LAUNCHES)}")
    rels = {}
    for name, want in grads[0].items():
        rels[name] = float((grads[1][name] - want).norm() / want.norm())
        check(rels[name] <= 2e-2, f"narrow qwen3 gradient {name}: card "
              f"against CPU relative norm {rels[name]} > 2e-2")
    return dict(config="build_smoke(), d_model=256, 4 heads over 2, "
                       "d_head=128, d_ff=512, vocab=1024",
                batch=2, seq=256, losses=dict(cpu=losses[0], card=losses[1]),
                worst_rel_norm=max(rels.values()),
                worst=max(rels, key=rels.get))


def bag_bwd_check(dev, table, args, name_power):
    """The bag backward kernel against the plain version on a training
    step's own history-bag operands (grad_out, ids, V) at rtol = atol =
    1e-5 (atomics add in another order), timed beside the bound (what
    any design must move: the (V, D) gradient written once, grad_out and
    the ids read once), the plain version and F.embedding_bag's backward;
    this design's own traffic (the gradient zeroed, then a read-modify-
    write of every row touched) beside it. Returns the kernel-table
    line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import ops, ref
    grad_out, ids, v = args
    (b, d), l = grad_out.shape, ids.shape[1]
    got = ops.embedding_bag_sum_bwd(grad_out, ids, v)
    want = ref.embedding_bag_sum_bwd(grad_out, ids, v)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "embedding_bag_sum_bwd: "
          "non-finite")
    err, rel, ok = close(got, want, 1e-5, 1e-5)
    check(ok, f"embedding_bag_sum_bwd differs from the plain version by "
          f"{err} (relative norm {rel})")
    del got, want
    real = ids >= 0
    touched = int(torch.unique(ids[real].clamp(max=v - 1)).numel())
    safe = ids.clamp(min=0).long()
    leaf = table.detach().requires_grad_()
    lib_out = F.embedding_bag(safe, leaf, mode="sum",
                              per_sample_weights=real.float())
    ms = cuda_ms(lambda: ops.embedding_bag_sum_bwd(grad_out, ids, v), 5, 3)[0]
    plain_ms = cuda_ms(lambda: ref.embedding_bag_sum_bwd(grad_out, ids, v),
                       3, 2)[0]
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, leaf, grad_out, retain_graph=True), 5, 3)[0]
    nbytes = 4 * (v * d + b * d + b * l)
    atomic = nbytes + 4 * 2 * touched * d
    bound_ms, bound_by = bound(nbytes, int(real.sum()) * d)
    line = dict(phase="train", check="embedding_bag_sum_bwd",
                shape=[v, d, b, l], real_ids=int(real.sum()),
                touched_rows=touched, max_abs_err=err, rel_norm_err=rel,
                rtol=1e-5, atol=1e-5, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, bound_ms_atomic_design=bound(atomic, 0)[0],
                atomic_design_bytes=atomic, name_power=name_power)
    emit(line)
    del lib_out, leaf
    torch.cuda.empty_cache()
    return line


def train_recsys_full_width(dev, name_power):
    """two-tower-retrieval at build() widths with RECSYS_TRAIN's cuts:
    RECSYS_TRAIN's steps of `recsys.make_train_step` on `synth_batch`'s
    batches. Each step must launch the bag forward and backward kernels
    twice (the history bag, the tag bag); one more backward must reach
    every parameter (item_id_table and tag_table through the bag
    backward); the backward kernel is then held against the plain version
    on the last step's history-bag operands. Returns (the line, the
    embedding_bag_sum_bwd table line)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import recsys as R
    from repro_torch.optim import adamw_init
    p = RECSYS_TRAIN
    cfg = dataclasses.replace(get_arch("two-tower-retrieval").build(),
                              n_users=p["n_users"], n_items=p["n_items"])
    t0 = time.perf_counter()
    model = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(dict(model.named_parameters()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = R.make_train_step(cfg)
    state = dict(model=model, opt=opt)

    def one(batch):
        state["model"], state["opt"], loss = step(state["model"],
                                                  state["opt"], batch)
        return loss

    def batches(i):
        return R.to_device(R.synth_batch(cfg, p["batch"], seed=i), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with Recorder(ops, "embedding_bag_sum_bwd",
                  lambda g, ids, v: v == cfg.n_items) as rec:
        losses, secs, launches = train_steps(one, dev, batches, p["steps"])
    peak = torch.cuda.max_memory_allocated(dev)
    for got in launches:
        check(got["embedding_bag_sum"] == got["embedding_bag_sum_bwd"] == 2,
              f"two-tower train step launched {got}")
    profile = train_profile(one, batches(p["steps"]))
    every_gradient(model, R.retrieval_loss(cfg, model, batches(p["steps"])))
    args = rec.args
    del rec, state, opt
    torch.cuda.empty_cache()
    table_line = bag_bwd_check(dev, model.item_id_table, args, name_power)
    del model, args
    torch.cuda.empty_cache()
    return dict(
        phase="train", model="two-tower-retrieval", config="build()",
        reduced=dict(n_users="2^25 -> 2^22", n_items="2^24 -> 2^22",
                     batch="65,536 -> 16,384"),
        params=cfg.param_count(), init_s=init_s, **p, losses=losses,
        step_s=secs, examples_per_s=[p["batch"] / t for t in secs],
        peak_bytes=peak, launches_per_step=launches, profile=profile,
        name_power=name_power), table_line


def train_launcher_on_card(dev, name_power,
                           archs=("qwen3-14b", "two-tower-retrieval"),
                           phase="train"):
    """`launch/train.train` at smoke on the card for each of `archs`: 8
    steps with checkpoints every 4, a run that fails at step 6, and a
    resume that must restore step 4 and end with the uninterrupted run's
    parameters within 1e-5 (the bags' and the segment sums' atomics make
    the last bits run-dependent)."""
    import tempfile
    import torch
    from repro_torch.launch.train import train
    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for arch in archs:
            t0 = time.perf_counter()
            full = train(arch, steps=8, ckpt_dir=f"{tmp}/{arch}-a",
                         ckpt_every=4, log_every=4, device=dev)
            try:
                train(arch, steps=8, ckpt_dir=f"{tmp}/{arch}-b",
                      ckpt_every=4, fail_at_step=6, log_every=4, device=dev)
                check(False, f"train({arch}) did not fail at step 6")
            except RuntimeError as e:
                check("simulated node failure" in str(e), repr(e))
            resumed = train(arch, steps=8, ckpt_dir=f"{tmp}/{arch}-b",
                            ckpt_every=4, resume=True, log_every=4,
                            device=dev)
            check(resumed["restored_from"] == 4,
                  f"{arch}: resumed from {resumed['restored_from']}")
            got = dict(resumed["params"].named_parameters())
            worst = 0.0
            for name, p in full["params"].named_parameters():
                diff = float((p - got[name]).detach().abs().max())
                check(diff <= 1e-5, f"{arch} resume: {name} differs by {diff}")
                worst = max(worst, diff)
            check(full["final_loss"] < full["losses"][0][1],
                  f"{arch}: loss did not decrease {full['losses']}")
            out[arch] = dict(losses=full["losses"], restored_from=4,
                             resume_max_abs_diff=worst,
                             seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return dict(phase=phase, check="launch/train.train smoke", **out,
                name_power=name_power)


def train_phase(dev, name_power):
    """The training path of the substrates: qwen3-14b at full width (2
    layers, 4,096 tokens) and its narrow form against the CPU, the
    two-tower model at full widths, and `train()` at smoke with a kill and
    a resume. Returns the backward kernels' table lines and the substrate
    kernels' launches in the measured steps."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm, flash_line = train_lm_full_width(dev, name_power)
    lm["cpu_check"] = train_lm_against_cpu(dev)
    emit(lm)
    rec, bag_line = train_recsys_full_width(dev, name_power)
    emit(rec)
    emit(train_launcher_on_card(dev, name_power))
    emit(dict(phase="train_done", seconds=time.perf_counter() - t0))
    launches = {}
    for line in (lm, rec):
        for got in line["launches_per_step"]:
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
    flash_line["launches"] = launches["flash_attention_bwd"]
    flash_line["wgmma_launches"] = launches["flash_attention_bwd_wgmma"]
    bag_line["launches"] = launches["embedding_bag_sum_bwd"]
    return {"flash_attention_bwd": flash_line,
            "embedding_bag_sum_bwd": bag_line}, launches


GNN_ARCHS = ("meshgraphnet", "schnet", "dimenet", "mace")
# The reference's molecule shape cell (configs/gnn_shapes.py): 128
# molecules of 30 atoms, d_feat 32; batch_molecules(128, 30, 32) gives
# 25,234 edges and, with triplets at the cap of 16, 203,668 triplets
MOLECULE_CELL = dict(n_graphs=128, atoms=30, d_feat=32, edges=25_234,
                     triplets=203_668)


def kernel_launches(reset=False):
    """Every kernel package's launch counts by kernel name (the thirteen
    rows of the kernel table and the counters beside them); `reset` sets
    them to 0 first."""
    import importlib
    out = {}
    for name in KERNEL_PACKAGES:
        counts = importlib.import_module(
            f"repro_torch.kernels.{name}.ops").LAUNCHES
        if reset:
            counts.reset()
        out.update(counts)
    return out


def gnn_kernel_group(name):
    """A GNN step's kernels by what they compute: cuBLAS's products,
    `index_add_` (the segment sums, and the gathers' backward), the
    gathers (`index_select`), and the rest (elementwise, reductions,
    copies). AdamW's kernels are split off by time (`gnn_step_profile`)."""
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
        return "matrix products"
    if any(t in low for t in ("indexfunc", "scatter", "index_put")):
        return "index_add_ / scatter"
    if any(t in low for t in ("indexselect", "gather", "index_elementwise")):
        return "gathers"
    return "elementwise"


def gnn_step_profile(arch, cfg, model, state, batch, n_graphs):
    """Where a GNN training step's device time goes: a warm-up step and a
    step timed without the profiler (`make_gnn_train_step`), then the same
    step under torch.profiler with a synchronise before AdamW, whose
    update runs inside `record_function("adamw")`: every kernel that
    starts after that range opens is AdamW's. The idle share is the part
    of the unprofiled step in which no kernel runs. Returns (the profile,
    the new AdamW state)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models.gnn_steps import gnn_loss, make_gnn_train_step
    from repro_torch.optim import AdamWConfig, adamw_update
    step = make_gnn_train_step(arch, cfg, n_graphs)
    named = dict(model.named_parameters())
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, _ = step(model, state, batch)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gnn_loss(arch, cfg, model, batch, n_graphs).backward()
        torch.cuda.synchronize()
        with record_function("adamw"):
            # make_gnn_train_step's update: lr 1e-3, no weight decay
            _, state = adamw_update(
                named, {n: p.grad for n, p in named.items()}, state, 1e-3,
                AdamWConfig(weight_decay=0.0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for p in named.values():
        p.grad = None
    events = prof.events()
    t_adamw = min(e.time_range.start for e in events if e.name == "adamw"
                  and e.device_type == DeviceType.CPU)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name != "adamw"]
    busy, groups, by_name = 0.0, {}, {}
    for e in kernels:
        ms = e.time_range.elapsed_us() * 1e-3
        busy += ms
        group = ("AdamW" if e.time_range.start >= t_adamw
                 else gnn_kernel_group(e.name))
        groups[group] = groups.get(group, 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    check(groups.get("AdamW", 0.0) > 0, f"{arch}: no AdamW kernel {groups}")

    def top(d, k=None):
        return {n[:90]: v for n, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:k]}
    return dict(ms=1e3 * plain_wall, profiled_ms=1e3 * wall, busy_ms=busy,
                kernels=len(kernels),
                device_idle_share=1.0 - busy / (1e3 * plain_wall),
                busy_ms_by_group=top(groups),
                top_kernels_ms=top(by_name, 8)), state


def gnn_cell(dev, name_power, arch, cfg, batch_np, n_graphs, d_feat, **line):
    """3 steps of `make_gnn_train_step` on one batch at `cfg`'s widths,
    weights from seed 0 made on the card: each step timed with its kernel
    launches read (the GNN path launches none of the kernel table's
    kernels), the peak of device memory over the 3 steps, then a profiled
    fourth step (`gnn_step_profile`)."""
    import torch
    from repro_torch.models.gnn_steps import (FORWARD, make_gnn_train_step,
                                              to_device)
    from repro_torch.optim import adamw_init
    batch = to_device(batch_np, dev)
    model = FORWARD[arch][1](cfg, torch.Generator(device=dev).manual_seed(0),
                             d_feat)
    state = adamw_init(dict(model.named_parameters()))
    step = make_gnn_train_step(arch, cfg, n_graphs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs, launches = [], [], []
    for _ in range(3):
        kernel_launches(reset=True)
        t0 = time.perf_counter()
        _, state, loss = step(model, state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        launches.append(sum(kernel_launches().values()))
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(map(math.isfinite, losses)), f"{arch}: losses {losses}")
    check(not any(launches), f"{arch}: kernel launches {launches}")
    profile, state = gnn_step_profile(arch, cfg, model, state, batch,
                                      n_graphs)
    params = sum(p.numel() for p in model.parameters())
    del model, state, batch
    torch.cuda.empty_cache()
    return dict(phase="gnn", arch=arch, **line, params=params,
                nodes=len(batch_np["node_feat"]), edges=len(batch_np["src"]),
                triplets=len(batch_np.get("trip_kj", ())), losses=losses,
                step_s=secs, peak_bytes=peak, launches_per_step=launches,
                profile=profile, name_power=name_power)


def gnn_launcher_full_width(dev, name_power):
    """`launch/train.train(arch, smoke=False, steps=3)` for each GNN arch at
    build() widths on the launcher's batch: finite losses, no launch of a
    kernel of the table, and one more backward on the trained weights
    must give every parameter a finite, non-zero gradient."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import gnn_batch, train
    from repro_torch.models.gnn_steps import gnn_loss, to_device
    out = {}
    for arch in GNN_ARCHS:
        kernel_launches(reset=True)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run = train(arch, steps=3, smoke=False, log_every=1, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = sum(kernel_launches().values())
        check(launches == 0, f"train({arch}) launched {kernel_launches()}")
        losses = [v for _, v in run["losses"]]
        check(len(losses) == 3 and all(map(math.isfinite, losses)),
              f"train({arch}) losses {losses}")
        batch_np, n_graphs, _ = gnn_batch(arch, smoke=False)
        norms = every_gradient(run["params"], gnn_loss(
            arch, get_arch(arch).build(), run["params"],
            to_device(batch_np, dev), n_graphs))
        out[arch] = dict(losses=losses, seconds=seconds,
                         peak_bytes=torch.cuda.max_memory_allocated(dev),
                         launches=launches, gradients=len(norms),
                         min_gradient_norm=min(norms.values()))
        del run
        torch.cuda.empty_cache()
    return dict(phase="gnn", check="launch/train.train(smoke=False, "
                "steps=3)", **out, name_power=name_power)


def gnn_against_cpu(dev):
    """Each GNN arch at build_smoke() on the launcher's smoke batch, one
    set of weights made on the CPU from a seed and copied to the card:
    the forward and the loss at rtol = atol = 1e-4, every gradient at
    rtol 1e-4 with an atol of 1e-3 of each tensor's largest entry (float32
    sums in another order: cuBLAS against the CPU's, the segment sums'
    atomics), matrix products in full float32 (no TF32)."""
    import copy
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import gnn_batch
    from repro_torch.models.gnn_steps import FORWARD, gnn_loss, to_device
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for arch in GNN_ARCHS:
            cfg = get_arch(arch).build_smoke()
            batch_np, n_graphs, d_feat = gnn_batch(arch, smoke=True)
            host = FORWARD[arch][1](cfg, torch.Generator().manual_seed(1),
                                    d_feat)
            card = copy.deepcopy(host).to(dev)
            res = []
            for model, device in ((host, "cpu"), (card, dev)):
                batch = to_device(batch_np, device)
                fwd = FORWARD[arch][2](cfg, model, batch)
                loss = gnn_loss(arch, cfg, model, batch, n_graphs)
                loss.backward()
                res.append((fwd.detach().cpu(), float(loss.detach()),
                            {n: p.grad.cpu()
                             for n, p in model.named_parameters()}))
            (f0, l0, g0), (f1, l1, g1) = res
            fwd_err = float((f1 - f0).abs().max())
            check(torch.allclose(f1, f0, rtol=1e-4, atol=1e-4),
                  f"{arch} forward: card against CPU max {fwd_err}")
            check(abs(l1 - l0) <= 1e-4 * (1 + abs(l0)),
                  f"{arch} loss: card {l1} against CPU {l0}")
            worst = 0.0
            for name, want in g0.items():
                scale = float(want.abs().max())
                err = float((g1[name] - want).abs().max())
                check(torch.allclose(g1[name], want, rtol=1e-4,
                                     atol=1e-3 * scale),
                      f"{arch} gradient {name}: max error {err}, scale "
                      f"{scale}")
                worst = max(worst, err / max(scale, 1e-30))
            out[arch] = dict(forward_max_abs_err=fwd_err,
                             loss=dict(cpu=l0, card=l1),
                             worst_gradient_err_over_scale=worst)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out


def gnn_phase(dev, name_power):
    """The GNN family's training path on the card: `train()` at full width
    for the four archs; SchNet, DimeNet and MACE at build() widths on the
    molecule cell and MeshGraphNet on the launcher's graph, each with s a
    step, peak and a profiled step; the smoke configs against the CPU;
    `train()` killed and resumed for MACE. No kernel of the table is
    launched (the aggregations are PyTorch's `index_add_`): returns the
    launch counts, all 0."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import gnn_batch
    from repro_torch.models.gnn_steps import batch_molecules
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernel_launches(reset=True)
    emit(gnn_launcher_full_width(dev, name_power))
    batch_np, n_graphs, d_feat = gnn_batch("meshgraphnet", smoke=False)
    emit(gnn_cell(dev, name_power, "meshgraphnet",
                  get_arch("meshgraphnet").build(), batch_np, n_graphs,
                  d_feat, cell="launcher: random_geometric(4096, seed=0)",
                  config="build()"))
    c = MOLECULE_CELL
    for arch in ("schnet", "dimenet", "mace"):
        batch_np = batch_molecules(c["n_graphs"], c["atoms"], c["d_feat"],
                                   with_triplets=(arch == "dimenet"))
        check(len(batch_np["src"]) == c["edges"] and (
            arch != "dimenet" or len(batch_np["trip_kj"]) == c["triplets"]),
            f"{arch}: molecule cell sizes")
        emit(gnn_cell(dev, name_power, arch, get_arch(arch).build(),
                      batch_np, c["n_graphs"], c["d_feat"],
                      cell="molecule: batch_molecules(128, 30, 32)",
                      config="build()"))
    emit(dict(phase="gnn", check="build_smoke() on the card against the CPU",
              **gnn_against_cpu(dev), name_power=name_power))
    emit(train_launcher_on_card(dev, name_power, archs=("mace",),
                                phase="gnn"))
    launches = kernel_launches()
    check(not any(launches.values()), f"the gnn phase launched {launches}")
    emit(dict(phase="gnn_done", seconds=time.perf_counter() - t0,
              launches=launches, name_power=name_power))
    return launches


# --------------------------------------------------------------------------
# phase 13: sharding and the launch tools on a world of one
# --------------------------------------------------------------------------

SHARDING = dict(n_layers=2, seq=4096, steps=3, lr=3e-4, pp_microbatches=4,
                pp_seq=1024)
# the layouts of the sharded step: the rules' own, no hints (the cells'
# layout: every weight product pinned, `layers.pinned_matmul`); then the
# hint variants, heads over "model" (40 % 1 == 0) and the query rows over
# "model" (context parallelism)
SHARD_HINTS = {"rules": None,
               "heads_tp": (("data",), "model", True),
               "ctx": (("data",), "model", False, True)}
H100_BF16_FLOPS = 989e12      # dense bf16 peak (data sheet, SXM, 700 W)
FLASH = ("flash_attention", "flash_attention_wgmma", "flash_attention_bwd",
         "flash_attention_bwd_wgmma")


class GradientTap:
    """While in a `with`: every `optim.adamw.adamw_update` call hands its
    gradients to `on_grads(step, grads)` before the update (the gradients
    as AdamW sees them: laid out as their parameters), and the seconds it
    took are kept in `seconds` to be taken off the step's time."""

    def __init__(self, on_grads):
        from repro_torch.optim import adamw
        self.module, self.on_grads = adamw, on_grads
        self.real, self.step, self.seconds = adamw.adamw_update, 0, 0.0

    def __enter__(self):
        def tapped(params, grads, *args, **kw):
            import torch
            torch.cuda.synchronize()        # the backward counts as step
            t0 = time.perf_counter()
            self.on_grads(self.step, {
                n: self.module.laid_out_as(grads[n], p)
                for n, p in params.items()})
            self.seconds += time.perf_counter() - t0
            self.step += 1
            return self.real(params, grads, *args, **kw)
        self.module.adamw_update = tapped
        return self

    def __exit__(self, *exc):
        self.module.adamw_update = self.real


def sharded_lm_steps(dev, cfg, mesh, on_grads, sharded=False, hints=None):
    """SHARDING's steps of `lm_steps.make_train_step` on qwen3-14b at 2
    layers (float32 master weights from seed 0, bf16 compute, remat), one
    `train_4k` sequence a step from `data.TokenStream`. `sharded`: the
    parameters and the AdamW state laid out by `lm_sharding` on `mesh`
    and the tokens by its token spec, with `shard_hints` = `hints`.
    `on_grads(step, grads)` sees each step's gradients. Returns (losses,
    seconds a step without the tap's, flash launches a step)."""
    import dataclasses
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.lm import (lm_sharding, shard_opt_state,
                                         shard_transformer)
    from repro_torch.sharding.spec import distribute
    p = SHARDING
    cfg = dataclasses.replace(cfg, shard_hints=hints)
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          dtype=torch.float32)
    opt = adamw_init(dict(model.named_parameters()))
    stream = TokenStream(cfg.vocab, p["seq"], 1, seed=0)

    def batch(i):
        return [torch.from_numpy(a).to(dev) for a in stream.batch(i)]
    if sharded:
        sh = lm_sharding(cfg, mesh)
        shard_transformer(model, sh)
        opt = shard_opt_state(opt, sh, cfg.n_layers)
        plain = batch

        def batch(i):
            return [distribute(t, mesh, sh.token_spec(1)) for t in plain(i)]
    step = make_train_step(cfg, lr=p["lr"])
    losses, secs, launches = [], [], []
    with GradientTap(on_grads) as tap:
        for i in range(p["steps"]):
            tokens, targets = batch(i)
            kernel_launches(reset=True)
            tapped = tap.seconds
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, opt, loss = step(model, opt, tokens, targets)
            if isinstance(loss, DTensor):
                loss = loss.full_tensor()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0 - (tap.seconds - tapped))
            losses.append(float(loss))
            launches.append({k: kernel_launches()[k] for k in FLASH})
    del model, opt
    torch.cuda.empty_cache()
    return losses, secs, launches


def sharding_train(dev, mesh, name_power):
    """(a): the unsharded steps, their gradients kept on the host, then the
    same steps with the rules' layout and each hint variant: losses and
    every gradient bit for bit, the same flash launches a step."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("qwen3-14b").build(),
                              n_layers=SHARDING["n_layers"])
    kept = []

    def keep(i, grads):
        kept.append({n: g.detach().cpu() for n, g in grads.items()})
    base = sharded_lm_steps(dev, cfg, mesh, keep)
    tokens = SHARDING["seq"]
    # model FLOPs of a step: launch/cells.py's LM rule, 6·N·D
    model_flops = 6.0 * cfg.active_param_count() * tokens
    out = dict(phase="sharding", check="(a) sharded train step",
               model="qwen3-14b", config="build()",
               reduced=dict(n_layers="40 -> 2", global_batch="256 -> 1"),
               mesh="(1, 1) (data, model), a world of one (NCCL, FileStore)",
               tokens=tokens, model_flops=model_flops,
               unsharded=dict(losses=base[0], step_s=base[1],
                              mfu=[model_flops / t / H100_BF16_FLOPS
                                   for t in base[1]],
                              flash_launches=base[2]))
    for name, hints in SHARD_HINTS.items():
        unequal = []

        def compare(i, grads):
            for n, g in grads.items():
                g = g.full_tensor().detach()
                if not torch.equal(g, kept[i][n].to(g.device)):
                    unequal.append((i, n))
        losses, secs, launches = sharded_lm_steps(dev, cfg, mesh, compare,
                                                  True, hints)
        out[name] = dict(
            shard_hints=repr(hints), losses=losses, step_s=secs,
            mfu=[model_flops / t / H100_BF16_FLOPS for t in secs],
            flash_launches=launches, gradients=len(kept[0]),
            unequal_gradients=unequal[:8])
        check(losses == base[0],
              f"sharded ({name}) losses {losses} != unsharded {base[0]}")
        check(not unequal, f"sharded ({name}) gradients differ: {unequal[:8]}")
        check(launches == base[2],
              f"sharded ({name}) flash launches {launches} != {base[2]}")
    for got in base[2]:
        check(got["flash_attention_wgmma"] == 2 * cfg.n_layers
              and got["flash_attention_bwd_wgmma"] == 3 * cfg.n_layers,
              f"train step launched {got}")
    del kept
    out["name_power"] = name_power
    return out


def sharding_pipeline(dev, name_power):
    """(b): `make_pipeline_train_step` with S = 1 (a "pp" mesh of the world
    of one) and M microbatches: the pipelined logits against the plain
    forward's under the bf16 check, the step's loss against the plain
    forward's to 1e-5 relative, the flash launches (M a layer a forward;
    3·M a layer a backward)."""
    import dataclasses
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.models.pipeline import (_nll_mean,
                                             make_pipeline_train_step,
                                             pipeline_forward, stack_stages,
                                             stage_parameters)
    from repro_torch.optim import adamw_init
    p = SHARDING
    m = p["pp_microbatches"]
    cfg = dataclasses.replace(get_arch("qwen3-14b").build(),
                              n_layers=p["n_layers"])
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pp",))
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          dtype=torch.float32)
    tokens, targets = (torch.from_numpy(a).to(dev) for a in TokenStream(
        cfg.vocab, p["pp_seq"], m, seed=0).batch(0))
    with torch.no_grad():
        plain, _ = T.forward(cfg, model, tokens)
        want_loss = float(_nll_mean(plain, targets))
        model.layers = stack_stages(model.layers, 1)
        kernel_launches(reset=True)
        piped = pipeline_forward(cfg, model, tokens, mesh=mesh,
                                 n_microbatches=m)
        fwd_launches = {k: kernel_launches()[k] for k in FLASH}
    rel, rows = bf16_logits_check(piped, plain, "pipelined forward")
    del plain, piped
    opt = adamw_init(stage_parameters(model, mesh))
    step = make_pipeline_train_step(cfg, mesh, m, lr=p["lr"])
    kernel_launches(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, opt, loss = step(model, opt, tokens, targets)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: kernel_launches()[k] for k in FLASH}
    n = cfg.n_layers
    check(fwd_launches["flash_attention_wgmma"] == m * n,
          f"pipelined forward launched {fwd_launches}")
    check(launches["flash_attention_wgmma"] == m * n
          and launches["flash_attention_bwd_wgmma"] == 3 * m * n,
          f"pipelined step launched {launches}")
    # the same kernels on the same rows (S = 1): the loss to float32's
    # rounding of a mean in another order
    check(abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss),
          f"pipelined loss {float(loss)} against the plain {want_loss}")
    del model, opt
    torch.cuda.empty_cache()
    return dict(phase="sharding", check="(b) pipelined step", stages=1,
                microbatches=m, tokens_per_microbatch=p["pp_seq"],
                logits_rel_norm=rel, rows_compared=rows,
                loss=float(loss), plain_loss=want_loss, step_s=secs,
                forward_flash_launches=fwd_launches,
                step_flash_launches=launches, name_power=name_power), launches


def cell_tensors(args):
    """Every tensor of a cell's arguments: a module's parameters, a dict's
    values (one level of nesting), the tensors themselves (a decode
    cache's position is the int `decode_step` takes, not a tensor)."""
    out = []
    for a in args:
        if hasattr(a, "parameters"):
            out.extend(a.parameters())
        elif isinstance(a, dict):
            for v in a.values():
                out.extend(v.values() if isinstance(v, dict) else [v])
        else:
            out.append(a)
    return [t for t in out if not isinstance(t, int)]


def sharding_cells(dev, mesh, name_power):
    """(c): `build_cell` for every runnable cell of `all_cells()` on the
    (1, 1) mesh of the world of one: arguments on meta, so the card's
    allocated bytes do not move."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.cells import all_cells, build_cell
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    built, meta = [], True
    for arch, cell, skip in all_cells():
        if skip:
            continue
        prog = build_cell(arch, cell, mesh)
        built.append(dict(arch=arch, cell=cell, kind=prog.kind,
                          model_flops=prog.model_flops))
        meta &= all(isinstance(t, DTensor) and t.to_local().is_meta
                    for t in cell_tensors(prog.args))
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated(dev)
    check(len(built) == 40, f"{len(built)} runnable cells, not 40")
    check(meta, "a cell argument is not a meta DTensor")
    check(after == before, f"building the cells moved the card's allocated "
          f"bytes {before} -> {after}")
    return dict(phase="sharding", check="(c) cells on meta",
                cells=len(built), seconds=secs, allocated_before=before,
                allocated_after=after, model_flops={
                    f"{c['arch']}/{c['cell']}": c["model_flops"]
                    for c in built}, name_power=name_power)


# The rmce web_sparse cell's counters on scale 11's U = 64 bucket (196
# roots, 256 X rows) padded to the cell's 1,024 roots with the driver's
# no-op roots (`core.driver._shard_batch`): the reference's cell function
# on the CPU (`repro.launch.cells.build_cell("rmce", "web_sparse",
# jax.make_mesh((1, 1), ("data", "model"))).fn` on those arrays with a
# leading shard dim), which the port's `run_bucket` on the CPU gives too.
# tests/test_torch_cells.py holds the two cell functions equal on a small
# bucket; the phase holds the cell to `run_bucket` in the same run, then
# `run_bucket` to these counts
RMCE_CELL_EXPECT = dict(cliques=108_659, calls=102_629, branches=101_605,
                        sum_px=608_592, truncated=0, live_iters=149_734,
                        lane_iters=7_058_432, steals=0, entry_terms=0,
                        window_spills=0, window_hits=0)


def sharding_mce_cell(dev, mesh, name_power):
    """(d): the `rmce` `web_sparse` cell's function (1,024 roots a shard,
    U = 64) on scale 11's U = 64 bucket, its 196 roots padded to the
    cell's 1,024 with the driver's no-op roots, at the bucket's 256 X rows
    (the cell's 64 would drop alive rows), laid out over "data": its
    counters against the port's `run_bucket` on the same roots in the
    same run, and those against the reference's (RMCE_CELL_EXPECT).
    Returns the line and the bitset kernels' launches of the cell's
    run."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.driver import _shard_batch
    from repro_torch.core.engine.loop import bucket_tensors, run_bucket
    from repro_torch.core.engine.prepare import prepare
    from repro_torch.graph.generators import kronecker
    from repro_torch.kernels.bitset_ops import ops
    from repro_torch.launch.cells import build_cell, mce_engine_config
    from repro_torch.sharding.spec import P, distribute
    prog = build_cell("rmce", "web_sparse", mesh)
    r = prog.args[0].shape[1]
    bucket = next(b for b in prepare(kronecker(11, 16, seed=0),
                                     device=dev).buckets if b.u_pad == 64)
    n_real = len(bucket.rsz0)
    check((r, n_real, bucket.x_rows.shape[1]) == (1024, 196, 256),
          f"rmce cell on {n_real} roots of {bucket.x_rows.shape} padded to {r}")
    args = bucket_tensors(*_shard_batch(bucket, np.arange(n_real), r), dev)
    ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    got = prog.fn(*(distribute(t[None], mesh, P(("data",))) for t in args))
    got = {k: int(v) for k, v in got.items()}
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for name in ROW_KERNELS:
        check(launches[name] > 0, f"the rmce cell launched no {name}")
    t0 = time.perf_counter()
    out = run_bucket(*args, mce_engine_config(get_arch("rmce").build()))
    it = out["iters"]
    plain = {k: int(out[k].sum()) for k in
             ("cliques", "calls", "branches", "sum_px", "truncated")}
    plain.update(live_iters=int(it.sum()), lane_iters=int(it.max()) * r,
                 steals=0, entry_terms=0, window_spills=0, window_hits=0)
    plain_secs = time.perf_counter() - t0
    check(got == plain,
          f"rmce cell counters {got} != run_bucket's {plain} on its roots")
    check(plain == RMCE_CELL_EXPECT,
          f"run_bucket's counters {plain} != the reference's "
          f"{RMCE_CELL_EXPECT}")
    return dict(phase="sharding", check="(d) rmce web_sparse cell",
                graph="kron:scale=11,ef=16,seed=0", bucket_u=64,
                real_roots=n_real, roots=r, x_rows=int(args[2].shape[1]),
                counters=got, run_bucket_counters=plain, seconds=secs,
                run_bucket_seconds=plain_secs, launches=launches,
                name_power=name_power), launches


# the query rows of a rank past the first under context parallelism at
# train_4k (DTensor's split: ceil(S / n) rows a rank): rank 1 of 2 (an
# offset of whole 128-row tiles) and rank 1 of 3 (an offset inside a tile)
CTX_RANKS = ((2, 1), (3, 1))


def sharding_ctx_offsets(dev, name_power):
    """(e): the flash kernels at the query offsets of context parallelism's
    ranks past the first (the (1, 1) mesh of (a) has none), at qwen3-14b's
    train_4k attention (40 heads after GQA expansion, D = 128, bf16, one
    sequence of 4,096): `mha` forward and backward at the rank's rows and
    offset against autograd through the plain version at that offset
    (`ref.flash_attention`, float32 inside) under the bf16 checks, then
    timed (forward + backward) against the blockwise attention such a rank
    ran before the kernels took an offset."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models import layers as L
    b, s, h, d = 1, SHARDING["seq"], 40, 128
    gen = torch.Generator(device=dev).manual_seed(5)

    def draw(rows):
        return torch.randn(b, rows, h, d, generator=gen, device=dev).to(
            torch.bfloat16)
    k, v = draw(s), draw(s)
    ranks = []
    for n, rank in CTX_RANKS:
        rows = -(-s // n)
        off = rank * rows
        rows = min(rows, s - off)
        q, do = draw(rows), draw(rows)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ops.LAUNCHES.reset()
        out = ops.mha(*leaves, causal=True, q_offset=off)
        out.backward(do)
        torch.cuda.synchronize()
        launches = {key: ops.LAUNCHES[key] for key in FLASH}
        check(launches == dict(flash_attention=1, flash_attention_wgmma=1,
                               flash_attention_bwd=3,
                               flash_attention_bwd_wgmma=3),
              f"mha at offset {off} launched {launches}")
        got = [out.detach()] + [t.grad for t in leaves]
        for t in leaves:
            t.grad = None
        flat = [t.transpose(1, 2).reshape(b * h, -1, d) for t in leaves]
        want = ref.flash_attention(*flat, causal=True, q_offset=off)
        want = want.reshape(b, h, rows, d).transpose(1, 2)
        want.backward(do)
        errs = {}
        for name, g, w in zip(("out", "dq", "dk", "dv"), got,
                              [want.detach()] + [t.grad for t in leaves]):
            err, rel, ok = close(g, w, BF16_RTOL, BF16_ATOL)
            check(ok, f"mha at offset {off}: {name} differs from the plain "
                  f"version by {err} (relative norm {rel})")
            errs[name] = dict(max_abs_err=err, rel_norm_err=rel)
        del got, want, flat
        for t in leaves:
            t.grad = None
        torch.cuda.empty_cache()

        def kernel():
            ops.mha(*leaves, causal=True, q_offset=off).backward(do)

        def blockwise():
            L.blockwise_attention(*leaves, causal=True,
                                  q_offset=off).backward(do)
        ms = cuda_ms(kernel, 7, 3)[0]
        plain_ms = cuda_ms(blockwise, 5, 2)[0]
        # forward 4 and backward 10 FLOP a visible (query, key) pair a
        # head dim; every byte of q, k, v, dO, out, dq, dk, dv once
        pairs = sum(min(off + i + 1, s) for i in range(rows))
        bound_ms, bound_by = bound(2 * b * h * d * (4 * rows + 4 * s),
                                   14 * h * pairs * d, BF16_OPS_PER_S)
        ranks.append(dict(ranks=n, rank=rank, q_offset=off, rows=rows,
                          keys=s, launches=launches, errors=errs,
                          rtol=BF16_RTOL, atol=BF16_ATOL,
                          fwd_bwd_ms=ms, blockwise_fwd_bwd_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by))
        del leaves, q, do
        torch.cuda.empty_cache()
    return dict(phase="sharding", check="(e) ctx ranks past offset 0",
                shape=[b, s, h, d, "torch.bfloat16"], ranks=ranks,
                name_power=name_power)


def sharding_phase(dev, name_power):
    """Sharding and the launch tools on a world of one (`make_host_mesh`:
    this process, NCCL, a FileStore): (a) the sharded qwen3-14b train step
    in the rules' own layout and under both hint variants against the
    unsharded one, (b) the pipelined step, (c) every runnable cell built
    on meta, (d) the rmce cell's function, (e) the flash kernels at
    context parallelism's query offsets. Returns (the bitset kernels'
    launches, the flash launches of the measured sharded and pipelined
    steps)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = make_host_mesh()
    check(host.size() == 1, f"host mesh of {host.size()} ranks")
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    train = sharding_train(dev, mesh, name_power)
    emit(train)
    pipe, pipe_launches = sharding_pipeline(dev, name_power)
    emit(pipe)
    emit(sharding_cells(dev, mesh, name_power))
    mce, bitset = sharding_mce_cell(dev, mesh, name_power)
    emit(mce)
    emit(sharding_ctx_offsets(dev, name_power))
    flash = dict(pipe_launches)
    for name in SHARD_HINTS:
        for got in train[name]["flash_launches"]:
            for k, v in got.items():
                flash[k] += v
    emit(dict(phase="sharding_done", seconds=time.perf_counter() - t0,
              flash_launches=flash, bitset_launches=bitset,
              name_power=name_power))
    return bitset, flash


def lint_phase(name_power):
    """The port's analyzer on its own source, under --strict, in a process
    that must import neither torch nor JAX."""
    t0 = time.perf_counter()
    code = ("import json, sys\n"
            "from repro_torch.analysis.cli import analyze, main\n"
            "rc = main(['src/repro_torch', '--strict', '--format', 'json'])\n"
            "heavy = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax'))\n"
            "print(json.dumps(dict(rc=rc, heavy=heavy)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"lint: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    tail = json.loads(lines[-1])
    report = json.loads("\n".join(lines[:-1]))
    check(tail["rc"] == 0 and report["counts"]["active"] == 0,
          f"lint: findings {report['findings'][:5]}")
    check(tail["heavy"] == [], f"lint imported {tail['heavy']}")
    emit(dict(phase="lint", modules=report["modules_checked"],
              findings=report["counts"]["active"],
              suppressed=report["counts"]["suppressed"],
              seconds=time.perf_counter() - t0, name_power=name_power))


DRYRUN_CELLS = (("qwen3-14b", "decode_32k"), ("schnet", "full_graph_sm"),
                ("two-tower-retrieval", "serve_p99"), ("rmce", "web_sparse"),
                ("dimenet", "molecule"), ("mace", "molecule"),
                ("chatglm3-6b", "train_4k"), ("chatglm3-6b", "prefill_32k"))
# Per-rank terms on 2x16x16 under torch 2.13 (the CPU sandbox), of
#   PYTHONPATH=src python -c "from repro_torch.launch import dryrun;
#   r = dryrun.run_cell(ARCH, CELL, True); print(r.flops_ca,
#   r.flops_per_device)"
# (matrix-product flops a rank, all flops a rank): shape arithmetic of the
# port's layout, which this machine's torch must give too, flops_ca within
# 1 % and flops_per_device within 5 %.
DRYRUN_EXPECT = {
    ("qwen3-14b", "decode_32k"): (32_580_239_360, 39_385_848_836),
    ("schnet", "full_graph_sm"): (382_787_584, 392_822_978),
    ("chatglm3-6b", "train_4k"): (122_148_869_898_240, 122_436_629_737_678),
    ("chatglm3-6b", "prefill_32k"): (57_784_523_292_672, 58_253_642_841_346),
}
# One dry-run cell in a process of its own: its record as one JSON line
DRYRUN_CELL = """
import dataclasses, json, sys, time
import torch
from repro_torch.launch import dryrun
t = time.perf_counter()
rec = dryrun.run_cell(sys.argv[1], sys.argv[2], True)
out = {k: v for k, v in dataclasses.asdict(rec).items() if k != "error"}
out.update(error=(rec.error or "")[-1500:], wall=time.perf_counter() - t,
           torch=torch.__version__)
print(json.dumps(out), flush=True)
"""


def dryrun_phase(name_power):
    """One dry-run cell a family, DimeNet's and MACE's too, and an LM
    train and prefill cell (their weight products pinned to the rules'
    layout), on a fake world of 512 ranks, each in a process of its own
    (a fake world is one a process; this one holds a real group), all at
    once: each must come out `ok`, and the cells of DRYRUN_EXPECT with the
    terms torch 2.13 gives on a CPU (`equal`: to the last digit)."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", DRYRUN_CELL, arch, cell],
                              cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for arch, cell in DRYRUN_CELLS]
    recs = []
    try:
        for (arch, cell), p in zip(DRYRUN_CELLS, procs):
            out, err = p.communicate(timeout=600)
            check(p.returncode == 0, f"dryrun {arch}/{cell}: {err[-2000:]}")
            recs += [json.loads(ln) for ln in out.splitlines()
                     if ln.startswith("{")]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(len(recs) == len(DRYRUN_CELLS), f"dryrun: {len(recs)} records")
    for rec in recs:
        key = (rec["arch"], rec["cell"])
        check(rec["ok"], f"dryrun {key}: {rec['error']}")
        if key in DRYRUN_EXPECT:
            ca, flops = DRYRUN_EXPECT[key]
            check(abs(rec["flops_ca"] - ca) <= 0.01 * ca
                  and abs(rec["flops_per_device"] - flops) <= 0.05 * flops,
                  f"dryrun {key} under torch {rec['torch']}: flops_ca "
                  f"{rec['flops_ca']} against {ca}, flops_per_device "
                  f"{rec['flops_per_device']} against {flops}")
        emit(dict(phase="dryrun_cell", name_power=name_power, **{
            k: rec[k] for k in (
                "arch", "cell", "kind", "mesh", "n_devices", "compile_s",
                "wall", "flops_per_device", "bytes_per_device",
                "argument_bytes", "link_bytes_per_device", "model_flops",
                "flops_ca", "t_compute", "t_memory", "t_collective",
                "bottleneck", "torch")},
            expect=DRYRUN_EXPECT.get(key),
            equal=DRYRUN_EXPECT.get(key) == (rec["flops_ca"],
                                             rec["flops_per_device"])))
    emit(dict(phase="dryrun", cells=len(recs),
              seconds=time.perf_counter() - t0, name_power=name_power))


# The hint-less sharded LM train steps of `gloo_phase` (the cells' own
# layout): a dense model, then MoEs with their experts over "model" and
# with 3 experts, which do not divide it, so d_ff splits (as mixtral's 8
# on 16); token groups of 16 over "data"
GLOO_TRAIN = (("chatglm3-6b", {}),
              ("phi3.5-moe-42b-a6.6b", dict(moe_group_size=16)),
              ("mixtral-8x7b", dict(n_experts=3, moe_group_size=16)))
# One rank of `gloo_phase`: DimeNet and MACE at smoke widths on
# `batch_molecules(4, 10, 8)` (edges, triplets and atoms split over "data"
# of a (2, 2) ("data", "model") mesh), their loss and gradients against the
# port's unsharded step; then qwen3-14b at smoke widths (float32, two
# layers): a 16-token prefill (its logits and stacked cache), and 20
# tokens decoded into a 32-slot cache laid out by `cache_spec` (batch over
# "data", slots over "model": the new tokens cross from one model rank's
# slots into the other's), against the plain steps; then GLOO_TRAIN's
# models at smoke widths (float32, two layers, batch 2 of 16 tokens): the
# loss and every gradient of the sharded step, and the parameters after
# one `make_train_step`, against the unsharded ones.
GLOO_RANK = """
import dataclasses, json, os
GLOO_TRAIN = %r
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=os.environ["GLOO_INIT"],
                        rank=int(os.environ["RANK"]), world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_arch
from repro_torch.models import gnn_steps as S
from repro_torch.models import transformer as T
from repro_torch.models.lm_steps import make_prefill_step
from repro_torch.sharding import gnn_sharding, lm_sharding
from repro_torch.sharding.lm import shard_transformer
from repro_torch.sharding.spec import P, distribute, shard_parameters
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def rel(got, want):
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


for arch in ("dimenet", "mace"):
    cfg = get_arch(arch).build_smoke()
    batch = S.batch_molecules(4, 10, 8, seed=0,
                              with_triplets=arch == "dimenet")
    build = lambda: S.FORWARD[arch][1](cfg, torch.Generator().manual_seed(0), 8)
    plain = build()
    want = S.gnn_loss(arch, cfg, plain, {k: torch.from_numpy(v)
                                         for k, v in batch.items()}, 4)
    want.backward()
    model = build()
    shard_parameters(model, mesh, {n: P() for n, _ in
                                   model.named_parameters()})
    meta = dict(n_nodes=batch["node_feat"].shape[0],
                n_edges=batch["src"].shape[0],
                n_triplets=batch["trip_kj"].shape[0] if "trip_kj" in batch
                else 0)
    sh = gnn_sharding(mesh, meta)
    bd = {k: distribute(torch.from_numpy(v), mesh, sh.batch_specs[k])
          for k, v in batch.items()}
    loss = S.gnn_loss(arch, cfg, model, bd, 4)
    loss.backward()
    grads = dict(plain.named_parameters())
    print(json.dumps(dict(
        arch=arch, loss=float(full(loss).detach()), want=float(want.detach()),
        loss_rel=abs(float(full(loss).detach()) - float(want.detach()))
        / abs(float(want.detach())),
        grad_rel=max(rel(full(p.grad), grads[n].grad)
                     for n, p in model.named_parameters()),
        placements={k: repr(bd[k].placements) for k in ("src", "trip_kj")
                    if k in bd})), flush=True)

cfg = dataclasses.replace(get_arch("qwen3-14b").build_smoke(),
                          dtype="float32", n_layers=2)
build = lambda: T.init_params(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.float32)
plain = build()
sh = lm_sharding(cfg, mesh)
model = shard_transformer(build(), sh)
prompt = torch.from_numpy(np.random.default_rng(2).integers(
    0, cfg.vocab, (2, 16)).astype(np.int32))
prefill = make_prefill_step(cfg)
want, cache = prefill(plain, prompt)
got, dcache = prefill(model, distribute(prompt, mesh, sh.token_spec(2)))
print(json.dumps(dict(
    arch="qwen3-14b prefill", prefill_rel=rel(full(got), want),
    cache_rel=max(rel(full(dcache[n]), cache[n]) for n in ("k", "v")),
    placements={"cache": repr(dcache["k"].placements)})), flush=True)
cache = T.init_cache(cfg, 2, 32)
spec = sh.cache_spec(cfg, 2, 32)
dcache = {n: distribute(cache[n].clone(), mesh, spec[n]) for n in ("k", "v")}
dcache["pos"] = 0
toks = torch.from_numpy(np.random.default_rng(3).integers(
    0, cfg.vocab, (20, 2, 1)).astype(np.int32))
worst = 0.0
with torch.no_grad():
    for t in toks:
        want, cache = T.decode_step(cfg, plain, cache, t)
        got, dcache = T.decode_step(cfg, model, dcache,
                                    distribute(t, mesh, sh.token_spec(2)))
        worst = max(worst, rel(full(got), want))
print(json.dumps(dict(
    arch="qwen3-14b", decode_rel=worst, pos=dcache["pos"],
    cache_rel=max(rel(full(dcache[n]), cache[n]) for n in ("k", "v")),
    placements={"cache": repr(dcache["k"].placements)})), flush=True)

from repro_torch.models.lm_steps import make_train_step
from repro_torch.optim import adamw_init
from repro_torch.sharding.lm import shard_opt_state
for arch, changes in GLOO_TRAIN:
    cfg = dataclasses.replace(get_arch(arch).build_smoke(), dtype="float32",
                              n_layers=2, **changes)
    build = lambda: T.init_params(cfg, torch.Generator().manual_seed(0),
                                  dtype=torch.float32)
    plain = build()
    sh = lm_sharding(cfg, mesh)
    model = shard_transformer(build(), sh)
    toks, tgts = (torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)) for seed in (4, 5))
    dtoks, dtgts = (distribute(t, mesh, sh.token_spec(2))
                    for t in (toks, tgts))
    want = T.lm_loss(cfg, plain, toks, tgts)
    want.backward()
    loss = T.lm_loss(cfg, model, dtoks, dtgts)
    loss.backward()
    grads = dict(plain.named_parameters())
    worst = max((rel(full(p.grad), grads[n].grad), n)
                for n, p in model.named_parameters())
    # the embedding's and the norms' gradients stay partial sums until
    # AdamW lays them out (`optim.adamw.laid_out_as`)
    loose = ("embed", "ln_final") + T.NORM_WEIGHTS
    not_laid_out = [n for n, p in model.named_parameters()
                    if p.grad.placements != p.placements
                    and n.split(".")[-1] not in loose]
    step = make_train_step(cfg)
    plain, _, _ = step(plain, adamw_init(dict(plain.named_parameters())),
                       toks, tgts)
    model, _, _ = step(model, shard_opt_state(adamw_init(dict(
        model.named_parameters())), sh, cfg.n_layers), dtoks, dtgts)
    params = dict(plain.named_parameters())
    print(json.dumps(dict(
        arch=f"{arch} train", changes=changes,
        loss_rel=abs(float(full(loss).detach()) - float(want.detach()))
        / abs(float(want.detach())), grad_rel=worst[0], worst_grad=worst[1],
        not_laid_out=not_laid_out,
        step_rel=max(rel(full(p).detach(), params[n].detach())
                     for n, p in model.named_parameters()),
        placements={n: repr(p.placements) for n, p in
                    model.named_parameters() if n.startswith("layers.0.w")})),
        flush=True)
dist.destroy_process_group()
"""


def gloo_phase(name_power):
    """The sharded GNN steps, the sharded decode and the hint-less sharded
    LM train steps under this machine's torch, on 4 gloo ranks on its
    CPUs (no card): `GLOO_RANK` in 4 processes of one group on a
    FileStore. Each rank's DimeNet and MACE loss and gradients must match
    the unsharded step at relative norm 1e-5 with the triplets or edges
    split (`Shard(dim=0)`), the decode's logits and cache the plain
    decode's, and each LM train step's loss and updated parameters the
    unsharded step's at 1e-5, its gradients at 5e-4 (each matrix's laid
    out as its parameter)."""
    import tempfile
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1", GLOO_INIT=f"file://{tmp}/store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", GLOO_RANK % (GLOO_TRAIN,)], cwd=ROOT,
            text=True, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for r in range(4)]
        outs = []
        try:
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=600)
                check(p.returncode == 0, f"gloo rank {r}: {err[-3000:]}")
                outs.append([json.loads(ln) for ln in out.splitlines()
                             if ln.startswith("{")])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for r, lines in enumerate(outs):
        check(len(lines) == 4 + len(GLOO_TRAIN),
              f"gloo rank {r}: {len(lines)} results")
        for ln in lines:
            if ln["arch"].endswith(" train"):
                # gradients: tests/test_torch_train_lm.py's relative norm
                # (a norm weight's sum over the tokens, added in another
                # order, reads 1.2e-5)
                check(ln["loss_rel"] <= 1e-5 and ln["grad_rel"] <= 5e-4
                      and ln["step_rel"] <= 1e-5 and not ln["not_laid_out"],
                      f"gloo rank {r}: {ln}")
                check(any("Shard" in p for p in ln["placements"].values()),
                      f"gloo rank {r}: {ln['placements']}")
                continue
            if ln["arch"] == "qwen3-14b prefill":
                check(ln["prefill_rel"] <= 1e-5 and ln["cache_rel"] <= 1e-5,
                      f"gloo rank {r}: {ln}")
                continue
            if ln["arch"] == "qwen3-14b":
                check(ln["decode_rel"] <= 1e-5 and ln["cache_rel"] <= 1e-5
                      and ln["pos"] == 20, f"gloo rank {r}: {ln}")
                check("Shard(dim=1)" in ln["placements"]["cache"]
                      and "Shard(dim=2)" in ln["placements"]["cache"],
                      f"gloo rank {r}: cache {ln['placements']}")
                continue
            check(ln["loss_rel"] <= 1e-5 and ln["grad_rel"] <= 1e-5,
                  f"gloo rank {r}: {ln}")
            for k, p in ln["placements"].items():
                check("Shard(dim=0)" in p, f"gloo rank {r}: {k} {p}")
    import torch
    emit(dict(phase="gloo", ranks=4, mesh="(2, 2) (data, model), gloo",
              torch=torch.__version__, results=outs[0],
              worst={k: max(ln[k] for lines in outs for ln in lines
                            if k in ln)
                     for k in ("loss_rel", "grad_rel", "prefill_rel",
                               "decode_rel", "cache_rel", "step_rel")},
              seconds=time.perf_counter() - t0, name_power=name_power))


def device_profile(run_once):
    """Where the time of `run_once()` goes: its wall time with the
    profiler off (after a warm-up) against the device's kernel time
    (torch.profiler's CUDA kernel events, profiler on). Returns (output,
    wall s, profiled wall s, device busy s, kernel count, busy s by kernel
    name); the idle share is the part of the unprofiled wall time in
    which no kernel runs."""
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
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() * 1e-6)
    return out, plain_wall, wall, busy, len(kernels), by_name


def step_profile(dev, prep, u=64, steps=64, backend="pivot"):
    """A batched per-root step of one slice bucket, over `steps` steps,
    with the slice's defaults and `backend`."""
    from repro_torch.core.engine import frames as fr
    from repro_torch.core.engine.loop import bucket_tensors, run_bucket
    b = next(b for b in prep.buckets if b.u_pad == u)
    args = bucket_tensors(b.a, b.p0, b.x_rows, b.x_alive0, b.rsz0, dev)
    cfg = fr.EngineConfig(backend=backend, max_iters=steps)
    out, plain_wall, wall, busy, n_k, _ = device_profile(
        lambda: run_bucket(*args, cfg))
    n = out["steps"]
    emit(dict(phase="step_profile", backend=backend, bucket_u=u,
              roots=b.num_roots, steps=n,
              ms_per_step=1e3 * plain_wall / n,
              profiled_ms_per_step=1e3 * wall / n,
              device_busy_ms_per_step=1e3 * busy / n,
              kernels_per_step=n_k / n,
              device_idle_share=1.0 - busy / plain_wall))


def trip_profile(dev, prep, u=64, trips=64, paths=None):
    """`step_profile` for the lane and window paths on the U=64 bucket:
    the first `trips` trips of the persistent lanes (min(64, roots)
    lanes) with the default config, the 'hybrid' and 'rcd' backends and
    the fused-window config, and of the per-root window walk (cut at
    16·trips frame-steps per root); `paths` picks some of them."""
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
            ("hybrid_persistent", lambda: run_bucket_persistent(
                *args, fr.EngineConfig(backend="hybrid", max_iters=trips),
                lanes=lanes)),
            ("rcd_persistent", lambda: run_bucket_persistent(
                *args, fr.EngineConfig(backend="rcd", max_iters=trips),
                lanes=lanes)),
            ("persistent_window", lambda: run_bucket_persistent(
                *args, fr.EngineConfig(max_iters=trips, **win),
                lanes=lanes)),
            ("perroot_window", lambda: run_bucket(
                *args, fr.EngineConfig(max_iters=16 * trips, **win)))):
        if paths is not None and path not in paths:
            continue
        out, plain_wall, wall, busy, n_k, _ = device_profile(run_once)
        n = out["iters"] if path != "perroot_window" else out["steps"]
        emit(dict(phase="trip_profile", path=path, bucket_u=u,
                  roots=b.num_roots, lanes=lanes, trips=n,
                  ms_per_trip=1e3 * plain_wall / n,
                  profiled_ms_per_trip=1e3 * wall / n,
                  device_busy_ms_per_trip=1e3 * busy / n,
                  kernels_per_trip=n_k / n,
                  device_idle_share=1.0 - busy / plain_wall))


def build_libraries():
    """Every kernel package's library, nvcc runs started together (one per
    source); returns {package: library}."""
    import importlib
    from concurrent.futures import ThreadPoolExecutor
    libs = {name: importlib.import_module(
        f"repro_torch.kernels.{name}.ops").LIBRARY
        for name in KERNEL_PACKAGES}
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.build) for lib in libs.values()]:
            fut.result()
    for lib in libs.values():
        lib.load()
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.engine.prepare import prepare
    from repro_torch.graph.generators import kronecker

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name_power = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    libs = build_libraries()
    emit(dict(phase="device", name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(),
              driver=nvidia_smi("driver_version"), name_power=name_power,
              torch=torch.__version__, cuda=torch.version.cuda,
              libraries={n: str(lib.path().relative_to(ROOT))
                         for n, lib in libs.items()},
              nvcc_seconds={n: lib.build_seconds for n, lib in libs.items()},
              build_and_load_seconds=time.perf_counter() - t0))

    n_edge = edge_cases(dev) + window_edge_cases(dev)
    g12 = kronecker(12, 16, seed=0)
    prep = prepare(g12, device=dev)
    kernel_lines = (bucket_cases(prep, dev) + real_frame_cases(dev, prep)
                    + window_slice_cases(dev, prep))
    emit(dict(phase="kernels_done", edge_cases=n_edge,
              bucket_cases=len(kernel_lines),
              seconds=time.perf_counter() - t_start))
    g14 = kronecker(14, 16, seed=0)
    substrate = substrate_kernels(dev, g12, g14)

    small_graphs(dev)
    device_peel(dev, {"kron:scale=12,ef=16": g12, "kron:scale=14,ef=16": g14})
    g11 = kronecker(11, 16, seed=0)
    paths = scale11_paths(dev, g11)
    step_profile(dev, prep)
    step_profile(dev, prep, backend="rcd")
    paths.update(scale12_paths(dev, g12))
    trip_profile(dev, prep)
    paths["driver"] = driver_path(dev, g11)
    paths.update(service_paths(dev, g11))
    serve_launches = serve_phase(dev)
    backward, train_launches = train_phase(dev, name_power)
    paths["gnn"] = gnn_phase(dev, name_power)
    paths["sharding"], sharding_launches = sharding_phase(dev, name_power)
    lint_phase(name_power)
    dryrun_phase(name_power)
    gloo_phase(name_power)

    # kernel table: each kernel at the bucket shape the main path launches
    # it most often (the U=64 bucket: most steps and trips), the row
    # kernels in their adjacency-row form; launches summed over every
    # path that launches the kernel (each path's are in path_launches)
    launches = {name: sum(p.get(name, 0) for p in paths.values())
                for name in REPLACES}
    us = {b.u_pad for b in prep.buckets}
    main_u = 64 if 64 in us else prep.buckets[0].u_pad
    table = []

    def at_main(name, form="roots", operands="random"):
        return next(ln for ln in kernel_lines
                    if ln["name"] == name and ln["bucket_u"] == main_u
                    and ln.get("form", "roots") == form
                    and ln.get("operands", "random") == operands)

    def timing(line):
        return {k: line[k] for k in ("shape", "xc", "full_roots",
                                     "branching_roots", "blocked_roots",
                                     "alive_x_rows", "ms", "plain_ms",
                                     "call_ms", "bound_ms", "bound_by")
                if k in line}
    # each kernel's engine entry point, counted under its name
    entry = {"frame_step": "branch_step",
             "and_popcount_rows": "lemma8_reduce",
             "and_popcount_argmax": "pivot_select",
             "clique_counts": "hybrid_census",
             "and_popcount_many": "rcd_dominated"}
    for name in REPLACES:
        line = at_main(name)
        # the census: row 4 keeps the reference's contract at the bucket's
        # roots; the hybrid lanes' shape and the engine's entry point
        # (`hybrid_census`, the same kernel) stand beside it. Rows 1-3 and
        # 5 likewise keep their reference form (A against P; the X0 rows'
        # argmax; P against the stacked complements) beside their engine
        # entry points on the engine's own operands and on random ones,
        # and row 2 beside the X-subset shape
        census = name == "clique_counts"
        table.append(dict(
            name=name, route="cuda", source=SOURCE,
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(ln["max_abs_err"] for ln in kernel_lines
                            if ln["name"] in (name, entry.get(name))),
            ms=line["ms"], plain_ms=line["plain_ms"],
            bound_ms=line["bound_ms"], bound_by=line["bound_by"],
            library_ms=None, shape=line["shape"],
            mask_shape=line.get("mask_shape"),
            **({"geometry": line["geometry"],
                "group_ms": line["group_ms"]} if "geometry" in line
               else {}),
            **({"x_subset": timing(at_main(name, "x_subset"))}
               if name == "and_popcount_rows" else {}),
            **({entry[name]: {
                f"{form}_{ops_}": timing(at_main(entry[name], form, ops_))
                for form in ("roots", "lanes")
                for ops_ in ("real", "random")}}
               if name in ("frame_step", "and_popcount_rows",
                           "and_popcount_argmax", "and_popcount_many")
               else {}),
            **({"lanes_ms": at_main(name, "lanes")["ms"],
                "hybrid_census_ms": at_main("hybrid_census")["ms"],
                "hybrid_census_lanes_ms":
                    at_main("hybrid_census", "lanes")["ms"],
                "threads_ms": line["threads_ms"]} if census else {})))
    # the substrate kernels at the full width their entry point ran at
    # (launches per entry-point call: one; three for edge_common_neighbor)
    for name, (_, source, replaces) in SUBSTRATE.items():
        line = next(ln for ln in substrate[name]
                    if "launches" in ln and "plain_ms" in ln)
        table.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=line["launches"],
            max_abs_err=max(ln["max_abs_err"] for ln in substrate[name]),
            ms=line["ms"], plain_ms=line["plain_ms"],
            bound_ms=line["bound_ms"], bound_by=line["bound_by"],
            library_ms=line["library_ms"], shape=line["shape"],
            **({k: line[k] for k in ("earlier_ms", "entry_point")
                if k in line}),
            **({"serve_launches": serve_launches[name]}
               if name in serve_launches else {}),
            **({"train_launches": train_launches[name]}
               if name in train_launches else {}),
            **({"sharding_launches": sharding_launches[name]}
               if name in sharding_launches else {})))
    # the backward kernels at the training path's full-width shapes, with
    # their launches in the train phase's measured steps
    for name, (_, source, replaces) in BACKWARD.items():
        line = backward[name]
        table.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=line["launches"], max_abs_err=line["max_abs_err"],
            ms=line["ms"], plain_ms=line["plain_ms"],
            bound_ms=line["bound_ms"], bound_by=line["bound_by"],
            library_ms=line["library_ms"], shape=line["shape"],
            **({k: line[k] for k in ("bound_ms_atomic_design", "earlier_ms",
                                     "in_turns_ms", "wgmma_launches")
                if k in line}),
            **({"sharding_launches": sharding_launches[name]}
               if name in sharding_launches else {})))
    emit(dict(phase="done", seconds=time.perf_counter() - t_start,
              path_launches=paths,
              note="library_ms is null for the bitset kernels and "
                   "has_common_neighbor: no single PyTorch call computes "
                   "AND+popcount over bit words, a BK walk, or a "
                   "common-neighbour test; the backward kernels replace no "
                   "TPU kernel: their 'replaces' is the reference function "
                   "whose XLA-differentiated gradient they compute"))
    print(name_power, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
