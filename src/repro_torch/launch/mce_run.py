"""Distributed MCE launcher: the paper's RMCE over the ranks of a process
group, one GPU each.

Usage:
  python -m repro_torch.launch.mce_run --graph kron:scale=12,ef=16,seed=0
  python -m repro_torch.launch.mce_run --graph ba:n=2000,m=6 --device cpu
  python -m repro_torch.launch.mce_run --graph er:n=300,p=0.2 --ckpt mce.json
  python -m repro_torch.launch.mce_run --graph ba:n=5000,m=8 --engine auto
  torchrun --nproc-per-node 2 -m repro_torch.launch.mce_run \\
      --graph ba:n=2000,m=6 --device cpu        # two ranks under gloo

The engine runs on `--device` (default "cuda", which must exist: pass
`--device cpu` to run on the host). Under torchrun (WORLD_SIZE > 1) each
rank joins the default process group (NCCL on CUDA, gloo on the CPU)
before it builds the driver, takes `cuda:{LOCAL_RANK}`, and runs its
share of every chunk; rank 0 prints and writes the checkpoint.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core.driver import DistributedMCE
from repro_torch.core.engine import EngineConfig
from repro_torch.core.engine.loop import resolve_device
from repro_torch.graph import generators as gen


def _num(v: str):
    """int where possible, float fallback — '1e-3' and '2.5' both parse."""
    try:
        return int(v)
    except ValueError:
        return float(v)


def parse_graph(desc: str):
    """'family:key=val,...' -> CSRGraph."""
    fam, _, rest = desc.partition(":")
    kw = {}
    if rest:
        for kv in rest.split(","):
            k, _, v = kv.partition("=")
            kw[k] = _num(v)
    if fam == "er":
        return gen.erdos_renyi(int(kw.get("n", 500)), kw.get("p", 0.1),
                               seed=int(kw.get("seed", 0)))
    if fam == "ba":
        return gen.barabasi_albert(int(kw.get("n", 2000)),
                                   int(kw.get("m", 4)),
                                   seed=int(kw.get("seed", 0)))
    if fam == "rgg":
        return gen.random_geometric(int(kw.get("n", 2000)),
                                    seed=int(kw.get("seed", 0)))
    if fam == "road":
        return gen.grid_road(int(kw.get("side", 64)),
                             seed=int(kw.get("seed", 0)))
    if fam == "caveman":
        return gen.caveman(int(kw.get("c", 50)), int(kw.get("k", 8)),
                           seed=int(kw.get("seed", 0)))
    if fam == "kron":
        return gen.kronecker(int(kw.get("scale", 12)),
                             int(kw.get("ef", 8)), seed=int(kw.get("seed", 0)))
    raise ValueError(f"unknown graph family {fam}")


def join_group(device: torch.device) -> bool:
    """Under torchrun (WORLD_SIZE > 1 in the environment) initialize the
    default process group from torchrun's environment: NCCL with this
    rank's card for a CUDA device, gloo otherwise. True if it did."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return True


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="ba:n=2000,m=6")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine ('cuda' must exist; "
                         "'cpu' runs on the host)")
    ap.add_argument("--backend",
                    choices=("pivot", "rcd", "revised", "hybrid"),
                    default="pivot",
                    help="hybrid: pivot branching plus per-node early "
                         "termination / X-domination pruning and a "
                         "density-triggered vertex-branch switch "
                         "(DESIGN.md §2.7)")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-global-red", dest="gred", action="store_false")
    ap.add_argument("--no-dynamic-red", dest="dred", action="store_false")
    ap.add_argument("--no-x-red", dest="xred", action="store_false")
    ap.add_argument("--materialize", action="store_true",
                    help="legacy mode: pack every bucket before device step 1")
    ap.add_argument("--stream-roots", type=int, default=1024,
                    help="streamed bucket flush size (part of the elastic "
                         "schedule identity — keep it fixed across restarts)")
    ap.add_argument("--split-threshold", type=int, default=None)
    ap.add_argument("--engine", choices=("perroot", "persistent", "auto"),
                    default="perroot",
                    help="perroot: lock-step batch over chunk roots; "
                         "persistent: lane-refill work queue (exhausted "
                         "lanes claim the next root); auto: per-bucket "
                         "choice from the root-cost skew")
    ap.add_argument("--lanes", type=int, default=64,
                    help="persistent engine: resident DFS lanes per shard")
    ap.add_argument("--no-steal", dest="steal", action="store_false",
                    help="persistent engine: disable lane work-stealing "
                         "(idle lanes adopting half of a victim lane's "
                         "shallowest splittable branch set)")
    ap.add_argument("--steal-victim", choices=("branchiest", "deepest"),
                    default="branchiest",
                    help="steal victim policy: 'branchiest' picks the lane "
                         "with the largest donation-slot branch set, "
                         "'deepest' the deepest lane (pure scheduling — "
                         "counters/sets bit-identical)")
    ap.add_argument("--window-steps", type=int, default=0,
                    help="walk this many DFS frame-steps per stack "
                         "round-trip over a resident stack window "
                         "(0 = one step per trip). Per-root walks need "
                         "pivot + --no-dynamic-red; the persistent engine "
                         "windows every config (fused kernel when "
                         "eligible, windowed dfs_step otherwise)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    joined = join_group(device)
    try:
        rank = dist.get_rank() if dist.is_initialized() else 0
        say = print if rank == 0 else (lambda *a, **k: None)
        g = parse_graph(args.graph)
        say(f"graph: n={g.n} m={g.m}")
        t0 = time.time()
        drv = DistributedMCE(
            g, device=args.device, chunk=args.chunk, ckpt_path=args.ckpt,
            cfg=EngineConfig(dynamic_red=args.dred, backend=args.backend,
                             steal=args.steal, steal_victim=args.steal_victim,
                             window_steps=args.window_steps),
            global_red=args.gred, x_red=args.xred,
            streaming=not args.materialize, stream_roots=args.stream_roots,
            split_threshold=args.split_threshold,
            engine=args.engine, lanes=args.lanes)
        init_s = time.time() - t0
        t0 = time.time()
        res = drv.run(resume=args.resume)
        run_s = time.time() - t0
        say(f"maximal cliques: {res.cliques} "
            f"(pre-reported {res.pre_reported}, calls {res.calls}, "
            f"branches {res.branches})")
        if res.iters_exhausted:
            say("WARNING: max_iters hit — counts are a lower bound; "
                "raise EngineConfig.max_iters")
        tm = drv.stream.timings if drv.stream is not None else {}
        stage_str = " ".join(f"{k} {v:.2f}s" for k, v in tm.items())
        n_buckets = (drv.stream.num_buckets if drv.stream is not None
                     else len(drv.prep.buckets))
        say(f"prep stages: {stage_str or f'(materialized in {init_s:.2f}s)'}")
        say(f"run {run_s:.2f}s  shards={drv.n_shards} buckets={n_buckets} "
            f"chunks={drv.stats['chunks']}  "
            f"device_wait {drv.stats['device_wait_s']:.2f}s  "
            f"host_pack {drv.stats['host_pack_s']:.2f}s "
            f"(overlapped {100 * drv.overlap_fraction:.0f}%)")
        if args.engine == "auto":
            say(f"engine choices: {drv.stats['engine_choices']}")
        lc = drv.last_counters
        if lc.get("lane_iters"):
            say(f"lane occupancy: {lc['live_iters'] / lc['lane_iters']:.2f} "
                f"(live {lc['live_iters']} / capacity {lc['lane_iters']})")
        if lc.get("steals") or lc.get("entry_terms"):
            say(f"queue: steals={lc.get('steals', 0)} "
                f"entry_terms={lc.get('entry_terms', 0)}")
        wtrips = lc.get("window_spills", 0) + lc.get("window_hits", 0)
        if wtrips:
            say(f"window: spills={lc['window_spills']} "
                f"hits={lc['window_hits']} "
                f"boundary_stall={lc['window_spills'] / wtrips:.2f}")
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
