"""Long-lived MCE service: pack once, answer many queries (DESIGN.md §6).

A resident `PrepStream` with `cache=True` owns the packed `RootBucket`s.
The first query streams them (host packing interleaved with the driver's
chunks); every later query — a different pivot backend, a
dynamic-reduction ablation, or a re-count after an elastic resize of the
process group — replays the cached buckets with zero host prep.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.mce_service \\
      --graph ba:n=3000,m=6 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from repro_torch.core.driver import DistributedMCE, shard_device
from repro_torch.core.engine import EngineConfig, MCEResult, PrepStream
from repro_torch.graph.csr import CSRGraph

# the per-query counters the service accumulates (engine_choices apart)
_QUERY_KEYS = ("live_iters", "lane_iters", "truncated", "steals",
               "entry_terms", "window_spills", "window_hits")


class MCEService:
    """Resident prepared-stream handle + per-query distributed drivers.

    `stats` accumulates occupancy/health counters ACROSS queries (cached
    replays included): `live_iters` / `lane_iters` are the useful vs
    capacity lane-trips of every engine dispatch (occupancy() = ratio),
    `truncated` counts chunks that hit cfg.max_iters with work left,
    `window_spills` / `window_hits` split windowed lane-trips by whether
    they ended at a stack boundary (boundary_stall() = spill fraction),
    and `engine_choices` tallies the per-bucket auto-policy picks. The
    per-query deltas ride on each returned result as `res.stats`.

    `device` ("cuda" by default, which must exist; "cpu" on the host) and
    `group` (the process group whose ranks are the shards; None: the
    default group if initialized) take the place of the reference's mesh
    and axis.
    """

    def __init__(self, g: CSRGraph, *, device="cuda", group=None,
                 chunk: int = 1024,
                 bucket_sizes: Sequence[int] = (32, 64, 128, 256, 512, 1024),
                 max_x_rows: int = 8192,
                 split_threshold: Optional[int] = None,
                 stream_roots: int = 1024,
                 engine: str = "perroot", lanes: int = 64):
        self.group = group
        self.device = shard_device(device, group)
        self.stream = PrepStream(g, bucket_sizes=bucket_sizes,
                                 max_x_rows=max_x_rows,
                                 split_threshold=split_threshold,
                                 stream_roots=stream_roots, cache=True,
                                 device=self.device)
        self.chunk = chunk
        self.engine = engine
        self.lanes = lanes
        self.queries = 0
        self.stats = dict({k: 0 for k in _QUERY_KEYS},
                          engine_choices={"perroot": 0, "persistent": 0})

    def occupancy(self) -> float:
        """Useful lane-trips / lane-trip capacity over all queries so far."""
        cap = self.stats["lane_iters"]
        return self.stats["live_iters"] / cap if cap else 0.0

    # occupancy() already folds window trips into both numerator and
    # capacity (lane_iters scales by window_steps), so it stays the
    # cross-engine comparable ratio; this is the named alias the launch
    # summaries print beside boundary_stall.
    def stream_occupancy(self) -> float:
        """Alias of occupancy() under its DESIGN.md §2.6 stream name."""
        return self.occupancy()

    def boundary_stall(self) -> float:
        """Fraction of windowed lane-trips that ended at a stack boundary.

        window_spills / (window_spills + window_hits): a *spill* is a
        windowed trip that stopped short of its K steps (window overflow/
        underflow forced a round-trip through the stack), a *hit* ran all
        K steps resident. 0.0 when no windowed trips ran (window_steps=0
        or perroot-only queries) — low is good."""
        trips = self.stats["window_spills"] + self.stats["window_hits"]
        return self.stats["window_spills"] / trips if trips else 0.0

    def query(self, cfg: EngineConfig = EngineConfig(),
              ckpt_path: Optional[str] = None,
              resume: bool = False,
              engine: Optional[str] = None,
              lanes: Optional[int] = None) -> MCEResult:
        """Run one counting query over the shared packed buckets.

        `engine`/`lanes` override the service defaults for this query
        only (e.g. A/B the persistent queue against the lock-step batch on
        identical packed buckets). Only `None` means "use the service
        default" — a falsy-but-explicit override (empty string, 0) is a
        caller error and raises instead of silently falling back."""
        if engine is None:
            engine = self.engine
        elif engine not in ("perroot", "persistent", "auto"):
            raise ValueError(f"unknown engine override {engine!r} "
                             "(expected 'perroot'|'persistent'|'auto')")
        if lanes is None:
            lanes = self.lanes
        elif not isinstance(lanes, int) or isinstance(lanes, bool) \
                or lanes < 1:
            raise ValueError(f"lanes override must be a positive int, "
                             f"got {lanes!r}")
        drv = DistributedMCE(prep=self.stream, device=self.device,
                             group=self.group, chunk=self.chunk,
                             ckpt_path=ckpt_path, cfg=cfg,
                             engine=engine, lanes=lanes)
        res = drv.run(resume=resume)
        self.queries += 1
        delta = {k: int(drv.last_counters.get(k, 0)) for k in _QUERY_KEYS}
        delta["engine_choices"] = dict(drv.stats["engine_choices"])
        for k in _QUERY_KEYS:
            self.stats[k] += delta[k]
        for k, v in delta["engine_choices"].items():
            self.stats["engine_choices"][k] += v
        res.stats = delta  # per-query slice of the accumulated service stats
        return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="ba:n=3000,m=6")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine ('cuda' must exist; "
                         "'cpu' runs on the host)")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--engine", default="perroot",
                    choices=["perroot", "persistent", "auto"])
    ap.add_argument("--lanes", type=int, default=64)
    args = ap.parse_args()
    from repro_torch.launch.mce_run import parse_graph

    g = parse_graph(args.graph)
    svc = MCEService(g, device=args.device, chunk=args.chunk,
                     engine=args.engine, lanes=args.lanes)
    for label, cfg in [("pivot", EngineConfig(backend="pivot")),
                       ("pivot-nodyn", EngineConfig(backend="pivot",
                                                    dynamic_red=False)),
                       ("pivot-win", EngineConfig(backend="pivot",
                                                  window_steps=8))]:
        t0 = time.time()
        res = svc.query(cfg)
        occ = (res.stats["live_iters"] / res.stats["lane_iters"]
               if res.stats["lane_iters"] else 0.0)
        wtrips = res.stats["window_spills"] + res.stats["window_hits"]
        stall = res.stats["window_spills"] / wtrips if wtrips else 0.0
        print(f"{label:12s} cliques={res.cliques} calls={res.calls} "
              f"occ={occ:.2f} stall={stall:.2f} {time.time() - t0:.2f}s "
              f"({'cold: streamed+packed' if svc.queries == 1 else 'cached buckets'})")
    print(f"service: {svc.queries} queries, "
          f"stream_occupancy {svc.stream_occupancy():.2f}, "
          f"boundary_stall {svc.boundary_stall():.2f} "
          f"(spills={svc.stats['window_spills']} "
          f"hits={svc.stats['window_hits']}), "
          f"engine_choices={svc.stats['engine_choices']}")


if __name__ == "__main__":
    main()
