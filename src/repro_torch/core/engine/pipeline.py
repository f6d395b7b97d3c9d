"""Staged streaming ingest pipeline: reduce → order → stage → pack.

`prepare()` used to materialize every bucket before the first device
step, packing rows with per-vertex python loops. `PrepStream` runs the
same preparation as four explicit stages and *yields* finished
`RootBucket`s incrementally, so the distributed driver can overlap host
packing with device execution (DESIGN.md §6):

  reduce : device deg-0/1 peel (`global_reduction.peel_low_degree` →
           `global_reduce_torch`) + host cascade on the residual graph
  order  : exact degeneracy order, adjacency sets, X-reduction
  stage  : per-root subproblem specs in degeneracy order; roots whose
           |P| exceeds the largest bucket or whose X rows exceed
           `max_x_rows` (or `split_threshold`, if set) are expanded one
           pivot-pruned BK level — recursively, so ANY graph runs
           without hand-tuning
  pack   : group specs by bucket size; every `stream_roots` staged roots
           of a size flush as one `RootBucket` via the vectorized
           `graph.pack.pack_bucket` scatter path

Streaming identity contract: the bucket sequence is a pure function of
(graph, bucket_sizes, stream_roots, split_threshold, reductions) — NOT
of the device count — so the driver's canonical cost-descending cursor
stays elastic across restarts with a different shard count. With
`stream_roots=0` (no mid-stream flush) the sequence is exactly the
legacy one-bucket-per-size layout, which is how `prepare()` keeps its
old contract.

Reports discovered while staging (a split branch whose P and X are both
empty is a maximal clique) land in `late_reported`, not `pre_reported`:
a streaming consumer learns them only as the stream advances, and they
are regenerated deterministically on every fresh iteration.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Set

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.order import degeneracy_order
from repro_torch.graph.pack import pack_bucket
from repro_torch.core.engine.prepare import PreparedMCE, RootBucket


@dataclasses.dataclass
class RootSpec:
    """One staged (R=base, P, X) subproblem, not yet packed."""

    base: tuple                 # clique vertices accumulated by splitting
    p_ids: np.ndarray           # (|P|,) int64 global ids, rank-ascending
    x_ids: np.ndarray           # (|X|,) int64 global ids, rank-ascending


@dataclasses.dataclass
class _Front:
    """Output of the reduce+order stages (run once per stream)."""

    g: CSRGraph                 # residual graph (original vertex ids)
    order: np.ndarray
    rank: np.ndarray
    degeneracy: int
    adj: List[Set[int]]
    kept_x: Optional[List[Set[int]]]


def _expand_one_level(base, p_ids, x_set, adj, rank):
    """Expand (R=base, P, X) one pivot-pruned BK level on the host.

    Yields (base + (w,), P_w, X_w) per branch vertex w — identical
    semantics to one level of Algorithm 2, so clique sets are preserved
    exactly (over-decomposition, DESIGN.md §5)."""
    p_set = set(p_ids.tolist())
    pool = p_set | x_set
    pivot = max(pool, key=lambda u: (len(adj[u] & p_set), -rank[u]))
    branch = [w for w in p_ids.tolist() if w not in adj[pivot]]
    p_cur = set(p_set)
    x_cur = set(x_set)
    for w in branch:
        p_cur.discard(w)
        yield base + (w,), p_cur & adj[w], x_cur & adj[w]
        x_cur.add(w)


class PrepStream:
    """Lazily staged, incrementally packed MCE preparation.

    Iterating yields `RootBucket`s as they fill. With `cache=True` a
    complete first pass retains the packed buckets, so long-lived
    deployments reuse them across queries without re-packing. A stream is
    single-consumer while a pass is in flight. `device` is the torch
    device of the reduce stage's degree-0/1 peel (None means "cuda"); only
    graphs with n + 2m >= 200,000 take that device path.
    """

    def __init__(self, g: CSRGraph, *, global_red: bool = True,
                 x_red: bool = True,
                 bucket_sizes: Sequence[int] = (32, 64, 128, 256, 512, 1024),
                 max_x_rows: int = 8192,
                 split_threshold: Optional[int] = None,
                 stream_roots: int = 1024, cache: bool = True,
                 device=None):
        self.g = g
        self.device = device        # where the reduce stage's device peel runs
        self.global_red = global_red
        self.x_red = x_red
        self.bucket_sizes = tuple(sorted(bucket_sizes))
        self.max_x_rows = max_x_rows
        self.split_threshold = split_threshold
        self.stream_roots = stream_roots
        self.cache = cache
        self.pre_reported: List[frozenset] = []
        self.late_reported: List[frozenset] = []
        self.timings: Dict[str, float] = {
            "reduce": 0.0, "order": 0.0, "stage": 0.0, "pack": 0.0}
        self.num_buckets = 0        # buckets yielded by the last/current pass
        self._front: Optional[_Front] = None
        self._cached: Optional[List[RootBucket]] = None

    # ---- stages 1+2: reduce + order (run once, lazily) -------------------

    def front(self) -> _Front:
        if self._front is not None:
            return self._front
        t0 = time.perf_counter()
        if self.global_red:
            from repro_torch.core.global_reduction import (global_reduce_host,
                                                     reduce_prepass)

            residual, pre_reports = reduce_prepass(self.g, device=self.device)
            red = global_reduce_host(residual)
            g_work = red.graph
            self.pre_reported = pre_reports + list(red.reported)
        else:
            g_work = self.g
        self.timings["reduce"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        order, rank, lam = degeneracy_order(g_work)
        # python-list slicing beats 20k tiny numpy slices by ~5x here
        idx_list = g_work.indices.tolist()
        ptr = g_work.indptr.tolist()
        adj = [set(idx_list[ptr[v]:ptr[v + 1]]) for v in range(g_work.n)]
        kept_x = None
        if self.x_red:
            from repro_torch.core.xreduction import x_prune_roots

            kept_x = x_prune_roots(adj, order, rank)
        self.timings["order"] = time.perf_counter() - t0
        self._front = _Front(g=g_work, order=order, rank=rank, degeneracy=lam,
                             adj=adj, kept_x=kept_x)
        return self._front

    # ---- stage 3: root staging with recursive auto-split -----------------

    def _rank_sorted(self, vs) -> np.ndarray:
        arr = np.fromiter(vs, dtype=np.int64, count=len(vs)) \
            if not isinstance(vs, np.ndarray) else vs.astype(np.int64)
        if len(arr) <= 1:
            return arr
        return arr[np.argsort(self._front.rank[arr])]

    def _x_fits(self, x_set) -> bool:
        k = len(x_set)
        return k == 0 or (1 << (k - 1).bit_length()) <= self.max_x_rows

    def _emit(self, base: tuple, p_ids: np.ndarray, x_set,
              force_split: bool) -> Iterator[RootSpec]:
        """Yield the spec, or split it until every piece fits.

        Iterative pre-order walk (a K_n hub splits one level per vertex,
        which would blow the python recursion limit for n ≳ 1000)."""
        f = self._front
        work = [(base, p_ids, x_set, force_split)]
        while work:
            base, p_ids, x_set, force = work.pop()
            if (not force and len(p_ids) <= self.bucket_sizes[-1]
                    and self._x_fits(x_set)):
                yield RootSpec(base=base, p_ids=p_ids,
                               x_ids=self._rank_sorted(x_set))
                continue
            children = []
            for base2, p_sub, x_sub in _expand_one_level(base, p_ids, x_set,
                                                         f.adj, f.rank):
                if not p_sub:
                    if not x_sub:
                        self.late_reported.append(frozenset(base2))
                    continue
                children.append((base2, self._rank_sorted(p_sub), x_sub,
                                 False))
            work.extend(reversed(children))   # preserve branch order

    def _specs(self) -> Iterator[RootSpec]:
        f = self.front()
        rank = f.rank
        degs = np.diff(f.g.indptr).tolist()   # cheap python guard per vertex
        for i in range(f.g.n):
            v = int(f.order[i])
            if degs[v] == 0:
                continue
            nb = f.g.neighbors(v).astype(np.int64)
            later = rank[nb] > i
            p_ids = nb[later]
            if len(p_ids) == 0:
                continue        # all its cliques are found from earlier roots
            p_ids = p_ids[np.argsort(rank[p_ids])]
            if f.kept_x is not None:
                x_set = f.kept_x[i]
            else:
                x_set = {int(u) for u in nb[~later]}
            force = (self.split_threshold is not None
                     and len(p_ids) > self.split_threshold)
            yield from self._emit((v,), p_ids, x_set, force)

    # ---- stage 4: bucket packing + flush ---------------------------------

    def _pack(self, bucket: int, specs: List[RootSpec],
              n_pad: int = 0) -> RootBucket:
        t0 = time.perf_counter()
        f = self._front
        a, p0, x_rows, x_alive = pack_bucket(
            f.g.indptr, f.g.indices, f.g.n,
            [s.p_ids for s in specs], [s.x_ids for s in specs], bucket)
        out = RootBucket(
            u_pad=bucket, x_pad=x_rows.shape[1], a=a, p0=p0, x_rows=x_rows,
            x_alive0=x_alive,
            roots=np.array([s.base[0] for s in specs], np.int64),
            rsz0=np.array([len(s.base) for s in specs], np.int32),
            bases=[s.base for s in specs],
            universes=[s.p_ids for s in specs],
            n_pad=n_pad)
        self.timings["pack"] += time.perf_counter() - t0
        return out

    def _pad_count(self, n: int) -> int:
        """Remainder-flush pad: round the root count up to the smallest
        pow2 fraction of `stream_roots` that fits, so a long run's
        executable shapes converge to O(log stream_roots) distinct root
        counts per bucket size instead of one fresh compile per arbitrary
        remainder (compile-count hygiene)."""
        if not self.stream_roots or n >= self.stream_roots:
            return 0
        frac = self.stream_roots
        while frac // 2 >= n:
            frac //= 2
        return frac - n

    def _bucket_of(self, u_size: int) -> int:
        for b in self.bucket_sizes:
            if u_size <= b:
                return b
        raise AssertionError("oversized spec escaped auto-split")

    def __iter__(self) -> Iterator[RootBucket]:
        if self._cached is not None:
            return iter(self._cached)
        return self._generate()

    def _generate(self) -> Iterator[RootBucket]:
        self.front()
        self.late_reported = []
        self.num_buckets = 0
        done: List[RootBucket] = []
        pending: Dict[int, List[RootSpec]] = {b: [] for b in self.bucket_sizes}
        t_mark = time.perf_counter()

        def flush(b: int) -> RootBucket:
            """Pack + book-keep one bucket; staging time since the last
            yield (minus pack time) lands in the `stage` timing."""
            pack_before = self.timings["pack"]
            specs = pending[b]
            n_pad = self._pad_count(len(specs))
            if n_pad:
                empty = np.zeros(0, np.int64)
                specs = specs + [RootSpec(base=(-1,), p_ids=empty,
                                          x_ids=empty)] * n_pad
            bk = self._pack(b, specs, n_pad=n_pad)
            pending[b] = []
            self.num_buckets += 1
            if self.cache:
                done.append(bk)
            self.timings["stage"] += (time.perf_counter() - t_mark
                                      - (self.timings["pack"] - pack_before))
            return bk

        for spec in self._specs():
            b = self._bucket_of(len(spec.p_ids))
            pending[b].append(spec)
            if self.stream_roots and len(pending[b]) >= self.stream_roots:
                yield flush(b)
                t_mark = time.perf_counter()
        for b in self.bucket_sizes:
            if pending[b]:
                yield flush(b)
                t_mark = time.perf_counter()
        if self.cache:
            self._cached = done

    # ---- legacy one-shot API ---------------------------------------------

    def materialize(self) -> PreparedMCE:
        """Drain the stream into the legacy `PreparedMCE` container."""
        buckets = list(self)
        f = self.front()
        return PreparedMCE(buckets=buckets,
                           pre_reported=self.pre_reported
                           + list(self.late_reported),
                           n=self.g.n, degeneracy=f.degeneracy,
                           order=f.order, rank=f.rank)
