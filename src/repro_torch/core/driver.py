"""Distributed MCE runtime: process-group fan-out, load balancing,
checkpointing (DESIGN.md §5–§6).

The reference fans a chunk of roots out with `shard_map` over a device
mesh. Here the shards are the ranks of a `torch.distributed` process
group — the default group when one is initialized, else a world of one
(one GPU is that degenerate case) — one process and one device per rank:

* Root subproblems are independent — MCE is data-parallel over roots.
  Every rank runs the same host prep and walks the same bucket sequence;
  of each chunk window, rank `r` runs the slice `window[r::n_shards]`,
  padded to the longest slice with no-op roots. Every rank computes every
  slice's padding, so the `n_pad` call correction is the same everywhere.
  Per-rank counters are summed with an int64 `all_reduce` (gloo on the
  CPU, NCCL on CUDA).
* **Streaming ingest**: the driver consumes `RootBucket`s from a
  `PrepStream` as the host packs them, and keeps the reference's order:
  chunk *k+1* is gathered and dispatched before chunk *k*'s counters are
  read back. The port's engine loop runs on the host and reads the device
  every `LIVE_CHECK_EVERY` steps, so a dispatch returns only once its
  chunk is done; `stats` records how much host time the settle proves was
  hidden (conservatively, as in the reference).
* **Straggler mitigation** is static balancing: per bucket, roots are
  sorted by a cost estimate (|P|·(1 + mean degree)² proxy) and dealt
  round-robin across shards, so each shard receives the same cost mass
  (LPT-style). Lock-step waste inside a batch is bounded by chunking.
* **Fault tolerance**: after every chunk the accumulated counters and the
  cursor are checkpointed (rank 0 writes). The cursor counts roots
  completed in the *canonical cost-descending order* — a pure function of
  the prepared graph and the stream parameters, NOT of the shard count —
  so an *elastic* restart with a different number of ranks resumes at
  exactly the same root. The JSON keys are the reference's, so a
  checkpoint written by either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.engine import (BACKENDS, EngineConfig, MCEResult,
                                     PIVOT_BACKENDS, PreparedMCE, PrepStream,
                                     RootBucket, choose_engine,
                                     estimate_costs, root_cost_skew,
                                     run_bucket, run_bucket_persistent)
from repro_torch.core.engine.loop import bucket_tensors, resolve_device
from repro_torch.graph.csr import CSRGraph

# "truncated" folds each chunk's iters-exhausted flags so a max_iters cutoff
# surfaces as MCEResult.iters_exhausted instead of silently partial counts.
# "live_iters"/"lane_iters" are the occupancy pair (useful lane-trips vs
# lane-trip capacity): occupancy = live/lane. The perroot engine's
# equivalent is Σ per-root iters over max(iters)·lanes — the lock-step
# batch runs every lane until the slowest root finishes. "steals"/
# "entry_terms"/"window_spills"/"window_hits" only move on the persistent
# engine; the perroot path zero-fills them so the counter schema — and
# every checkpoint written against it — is engine-independent.
# Checkpoints from before a key existed resume via `.get` in `_settle`.
COUNTER_KEYS = ("cliques", "calls", "branches", "sum_px", "truncated",
                "live_iters", "lane_iters", "steals", "entry_terms",
                "window_spills", "window_hits")


# ---------------------------------------------------------------------------
# Cost-balanced root scheduling (cost model lives in engine.prepare)
# ---------------------------------------------------------------------------


def canonical_order(costs: np.ndarray) -> np.ndarray:
    """Cost-descending stable order — the shard-count-INDEPENDENT schedule.

    Elasticity contract: the checkpoint cursor counts *roots completed in
    this order*; a restart with any shard count resumes at the same root."""
    return np.argsort(-costs, kind="stable")


def deal_roots(costs: np.ndarray, n_shards: int) -> List[np.ndarray]:
    """Sort by cost desc, deal round-robin -> per-shard root index lists."""
    order = canonical_order(costs)
    return [order[s::n_shards] for s in range(n_shards)]


# ---------------------------------------------------------------------------
# Per-shard chunk execution
# ---------------------------------------------------------------------------

def _graph_fingerprint(g: CSRGraph) -> List[int]:
    """Cheap O(m) identity of a CSR graph for the checkpoint schedule.

    The cursor indexes a bucket sequence that is a pure function of the
    graph too (DESIGN.md §6.4); a position-weighted xor fold of the
    adjacency (uint64, wrapping) catches resuming against a different
    graph, not just different stream parameters."""
    idx = g.indices.astype(np.uint64)
    weights = np.arange(1, len(idx) + 1, dtype=np.uint64)
    h = int(np.bitwise_xor.reduce(idx * weights)) if len(idx) else 0
    return [g.n, g.m, h]


def _shard_batch(bucket: RootBucket, idx: np.ndarray, pad_to: int):
    """Gather + pad a per-shard slice of a bucket (pad roots are no-ops:
    an empty P and |R| = 1, one engine call each and nothing else)."""
    take = idx[:pad_to] if len(idx) >= pad_to else idx
    pad = pad_to - len(take)
    a = bucket.a[take]
    p0 = bucket.p0[take]
    xr = bucket.x_rows[take]
    xa = bucket.x_alive0[take]
    rz = bucket.rsz0[take]
    if pad:
        w = bucket.a.shape[2]
        a = np.concatenate([a, np.zeros((pad,) + bucket.a.shape[1:], np.uint32)])
        p0 = np.concatenate([p0, np.zeros((pad, w), np.uint32)])  # empty P -> no-op
        xr = np.concatenate([xr, np.zeros((pad,) + bucket.x_rows.shape[1:], np.uint32)])
        xa = np.concatenate([xa, np.zeros((pad, bucket.x_rows.shape[1]), bool)])
        rz = np.concatenate([rz, np.ones(pad, np.int32)])
    return a, p0, xr, xa, rz


def _shard_counts(a, p0, xr, xa, rz, cfg: EngineConfig, engine: str,
                  lanes: int) -> torch.Tensor:
    """Run one shard's padded chunk (R = pad_to roots) on its device; the
    COUNTER_KEYS summed over the shard as an int64 vector on that device.

    `engine='persistent'` runs the chunk through the lane-refill work queue
    (the chunk's cost-descending slice order IS the queue order) on
    min(lanes, R) lanes; 'perroot' steps every root in lock step."""
    R = a.shape[0]
    if engine == "persistent":
        L = min(lanes, R)
        out = run_bucket_persistent(a, p0, xr, xa, rz, cfg, lanes=L)
        # each windowed trip offers up to window_steps frame-steps per
        # lane, so the occupancy denominator scales with it
        out["lane_iters"] = out["iters"] * L * max(1, cfg.window_steps)
    else:
        out = run_bucket(a, p0, xr, xa, rz, cfg)
        it = out["iters"]
        # lock-step equivalent of the queue's occupancy pair: every lane
        # spins until the slowest root's DFS exhausts, pad lanes included
        out.update(live_iters=it.sum(), lane_iters=it.max() * R, steals=0,
                   entry_terms=0, window_spills=0, window_hits=0)
    return torch.stack([torch.as_tensor(out[k], device=a.device)
                        .sum(dtype=torch.int64) for k in COUNTER_KEYS])


@dataclasses.dataclass
class DriverCheckpoint:
    bucket: int = 0
    roots_done: int = 0            # cursor in canonical (cost-desc) order —
    counters: dict = dataclasses.field(  # shard-count independent (elastic)
        default_factory=lambda: {k: 0 for k in COUNTER_KEYS})
    schedule: dict = dataclasses.field(default_factory=dict)
    # ^ identity of the bucket sequence the cursor indexes (stream params or
    # materialized bucket shapes). The cursor is only meaningful against the
    # SAME sequence; run() refuses to resume against a different one.

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(self), f)
        os.replace(tmp, path)  # atomic: a torn write never corrupts resume

    @staticmethod
    def load(path: str) -> "DriverCheckpoint":
        with open(path) as f:
            d = json.load(f)
        return DriverCheckpoint(bucket=d["bucket"],
                                roots_done=d["roots_done"],
                                counters=d["counters"],
                                schedule=d.get("schedule", {}))


def _world(group) -> Tuple[int, int]:
    """(shards, this rank): the process group's, or a world of one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


def shard_device(device, group=None) -> torch.device:
    """The device this rank runs on: `device` (None: "cuda", which must
    exist), and for a CUDA device without an index `cuda:{local rank}`
    (LOCAL_RANK as torchrun sets it, else the rank in `group` modulo the
    cards)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else _world(group)[1] % torch.cuda.device_count())
    return dev


class DistributedMCE:
    """Chunked, checkpointed MCE over the ranks of a process group.

    Ingest is streaming by default: buckets arrive from a `PrepStream` and
    the run loop dispatches chunk k+1 before it settles chunk k (see module
    docstring). Pass `streaming=False` for the legacy
    materialize-everything-first mode (exposed as `.prep`), or hand in an
    existing `PrepStream`/`PreparedMCE` via `prep=` to reuse packed buckets
    across runs (launch.mce_service).

    `device` is where this rank's engine (and a driver-owned stream's
    device peel) runs: "cuda" by default, which must exist; pass "cpu" to
    run on the host. `group` is the process group whose ranks are the
    shards (None: the default group, if initialized).
    """

    def __init__(self, g: Optional[CSRGraph] = None, *,
                 device="cuda", group=None, chunk: int = 1024,
                 ckpt_path: Optional[str] = None,
                 cfg: EngineConfig = EngineConfig(),
                 global_red: bool = True, x_red: bool = True,
                 bucket_sizes: Sequence[int] = (32, 64, 128, 256, 512, 1024),
                 max_x_rows: int = 8192,
                 split_threshold: Optional[int] = None,
                 streaming: bool = True, stream_roots: int = 1024,
                 prep: Union[PrepStream, PreparedMCE, None] = None,
                 engine: str = "perroot", lanes: int = 64):
        if engine not in ("perroot", "persistent", "auto"):
            raise ValueError(f"unknown engine {engine!r}")
        if cfg.backend not in BACKENDS:
            raise ValueError(f"unknown backend {cfg.backend!r} "
                             f"(expected one of {BACKENDS})")
        self.engine = engine
        self.lanes = lanes
        self.group = group
        self.n_shards, self.rank = _world(group)
        self.device = shard_device(device, group)
        self.chunk = chunk
        self.cfg = cfg
        self.ckpt_path = ckpt_path
        self.stats = {"host_pack_s": 0.0, "host_pack_overlap_s": 0.0,
                      "dispatch_s": 0.0, "device_wait_s": 0.0, "chunks": 0,
                      "engine_choices": {"perroot": 0, "persistent": 0}}
        self.last_counters: dict = {}   # COUNTER_KEYS of the last run()
        self.prep: Optional[PreparedMCE] = None
        self.stream: Optional[PrepStream] = None
        if prep is not None and g is not None:
            # a prepared stream fixes the graph and every prep-shaping
            # knob; accepting both would silently run against prep's graph
            raise ValueError("pass either a graph or prep=, not both")
        if isinstance(prep, PreparedMCE):
            self.prep = prep
        elif isinstance(prep, PrepStream):
            self.stream = prep
        else:
            if g is None:
                raise ValueError("need a graph or a prepared stream")
            # cache=False: a driver-owned stream is consumed once; caching
            # every packed bucket would recreate materialized-mode peak host
            # memory (pass a PrepStream(cache=True) for service-style reuse)
            stream = PrepStream(g, global_red=global_red, x_red=x_red,
                                bucket_sizes=bucket_sizes,
                                max_x_rows=max_x_rows,
                                split_threshold=split_threshold,
                                stream_roots=stream_roots if streaming else 0,
                                cache=not streaming, device=self.device)
            if streaming:
                self.stream = stream
            else:
                self.prep = stream.materialize()
        if self.stream is not None:
            st = self.stream
            self._schedule = dict(
                mode="stream", graph=_graph_fingerprint(st.g),
                stream_roots=st.stream_roots,
                bucket_sizes=list(st.bucket_sizes),
                split_threshold=st.split_threshold, global_red=st.global_red,
                x_red=st.x_red, max_x_rows=st.max_x_rows)
        else:
            self._schedule = dict(
                mode="materialized", n=self.prep.n,
                buckets=[[b.u_pad, b.num_roots] for b in self.prep.buckets])

    # ---- bucket source (streamed or materialized) ------------------------

    def _buckets(self) -> Iterator[RootBucket]:
        if self.stream is not None:
            return iter(self.stream)
        return iter(self.prep.buckets)

    def run(self, resume: bool = True) -> MCEResult:
        state = DriverCheckpoint()
        if self.stream is not None:
            self.stream.front()
            pre0 = len(self.stream.pre_reported)
        else:
            pre0 = len(self.prep.pre_reported)
        state.counters["cliques"] = pre0
        if resume and self.ckpt_path and os.path.exists(self.ckpt_path):
            state = DriverCheckpoint.load(self.ckpt_path)
            if state.schedule and state.schedule != self._schedule:
                raise ValueError(
                    "checkpoint schedule mismatch: the cursor was written "
                    f"against {state.schedule} but this driver runs "
                    f"{self._schedule}; resume with identical stream "
                    "parameters (the shard count may differ — that is the "
                    "elastic dimension)")
        state.schedule = self._schedule

        window = self.n_shards * self.chunk
        pending: Optional[Tuple[torch.Tensor, int, int, int]] = None
        self._inflight_host = 0.0       # host work while `pending` flies
        src = self._buckets()
        b = -1
        while True:
            t0 = time.perf_counter()
            bucket = next(src, None)        # streaming: host packs here,
            dt = time.perf_counter() - t0   # after chunk k's dispatch
            self.stats["host_pack_s"] += dt
            if pending is not None:
                self._inflight_host += dt
            if bucket is None:
                break
            b += 1
            if b < state.bucket:
                continue                    # resume: replayed, not re-run
            # pad roots (remainder-flush pow2 padding) sit at the bucket's
            # tail; scheduling only the real prefix drops their no-op calls
            total = bucket.num_roots - bucket.n_pad
            if bucket.cost_order is None:   # memo: cached-bucket replays
                costs = estimate_costs(bucket)[:total]
                bucket.cost_order = canonical_order(costs)
                # same hardened skew as choose_engine's costs= path, so
                # memoized replays and fresh runs can't diverge
                bucket.cost_skew = (root_cost_skew(costs) if total else 1.0)
            order = bucket.cost_order
            eng_b, lanes_b = self.engine, self.lanes
            if self.engine == "auto":
                # the choice is a pure function of the bucket, so replays
                # and resumes land on the same engine
                eng_b, lanes_b = choose_engine(
                    skew=bucket.cost_skew, n_roots=total, lanes=self.lanes,
                    steal=bool(self.cfg.steal)
                    and self.cfg.backend in PIVOT_BACKENDS)
                self.stats["engine_choices"][eng_b] += 1
            done = state.roots_done if b == state.bucket else 0
            while done < total:
                hi = min(done + window, total)
                t0 = time.perf_counter()
                handle = self._run_chunk(bucket, order[done:hi],
                                         eng_b, lanes_b)
                dt = time.perf_counter() - t0   # gather/pad/upload + engine
                self.stats["dispatch_s"] += dt
                self.stats["host_pack_s"] += dt
                if pending is not None:
                    self._inflight_host += dt
                    self._settle(pending, state)
                pending = (*handle, b, hi)
                done = hi
        if pending is not None:
            self._settle(pending, state)

        late = len(self.stream.late_reported) if self.stream is not None else 0
        self.last_counters = dict(state.counters)
        return MCEResult(cliques=state.counters["cliques"] + late,
                         calls=state.counters["calls"],
                         branches=state.counters["branches"],
                         sum_px=state.counters["sum_px"],
                         pre_reported=pre0 + late,
                         iters_exhausted=state.counters.get("truncated", 0) > 0)

    # ---- chunk pipeline --------------------------------------------------

    def _run_chunk(self, bucket: RootBucket, window: np.ndarray,
                   engine: str, lanes: int):
        """Gather/pad + upload + run this rank's slice of one chunk.

        `engine`/`lanes` are per-bucket: under engine="auto" the driver
        resolves them from the bucket's cost skew before each chunk.
        Returns (this rank's counter vector on its device, n_pad over
        every rank's slice); the caller settles the previous chunk after
        dispatching this one."""
        slices = [window[s::self.n_shards] for s in range(self.n_shards)]
        pad_to = max(len(s) for s in slices)
        n_pad = sum(pad_to - len(s) for s in slices)
        args = bucket_tensors(*_shard_batch(bucket, slices[self.rank],
                                            pad_to), self.device)
        return _shard_counts(*args, self.cfg, engine, lanes), n_pad

    def _settle(self, pending, state: DriverCheckpoint) -> None:
        """Sum a dispatched chunk over the ranks, read it back, fold the
        counters and checkpoint the cursor (rank 0 writes)."""
        out, n_pad, b, hi = pending
        t0 = time.perf_counter()
        if self.n_shards > 1:
            dist.all_reduce(out, group=self.group)
        out = dict(zip(COUNTER_KEYS, out.tolist()))
        wait = time.perf_counter() - t0
        self.stats["device_wait_s"] += wait
        # credit in-flight host time as hidden only when the settle proves
        # the device was still busy; a zero wait means the device may have
        # finished early, so that host time gets no overlap credit (the
        # stat is a lower bound, never an optimistic one)
        if wait > 1e-4:
            self.stats["host_pack_overlap_s"] += self._inflight_host
        self._inflight_host = 0.0
        self.stats["chunks"] += 1
        # padded no-op roots contribute exactly one call each; remove them so
        # distributed counters match the single-host run exactly
        out["calls"] -= n_pad
        for k in COUNTER_KEYS:
            # .get: checkpoints written before a counter key existed resume
            # cleanly (the missing key starts from zero)
            state.counters[k] = state.counters.get(k, 0) + out[k]
        state.bucket, state.roots_done = b, hi
        if self.ckpt_path and self.rank == 0:
            state.save(self.ckpt_path)

    @property
    def overlap_fraction(self) -> float:
        """Share of host ingest time hidden behind device compute.

        Conservative: in-flight host time counts as hidden only for chunks
        whose settle still had to wait on the device (lower bound)."""
        total = self.stats["host_pack_s"]
        return self.stats["host_pack_overlap_s"] / total if total > 0 else 0.0
