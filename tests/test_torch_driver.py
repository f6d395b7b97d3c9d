"""PyTorch port, the distributed driver (`repro_torch.core.driver`) against
the reference's (`repro.core.driver`) with one shard.

The same seeded graphs go to both packages; the tolerance is exact
equality everywhere: the scheduling helpers (`canonical_order`,
`deal_roots`, `_graph_fingerprint`, `_shard_batch`), all 11
`COUNTER_KEYS` of `last_counters`, every `MCEResult` field, the chunk
count and the `auto` engine choices, on every engine and backend,
streamed and materialized; and a checkpoint written by either driver
after two chunks resumes in the other to the reference's totals. The
driver cases of the reference's own tests are in
tests/test_torch_driver_cases.py, several ranks under gloo in
tests/test_torch_driver_ranks.py.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import bitset_engine as jengine
from repro.core import driver as jdriver
from repro.core.engine import EngineConfig as JConfig
from repro.graph import generators as jgen
from repro_torch.core import driver
from repro_torch.core.driver import DistributedMCE
from repro_torch.core.engine import EngineConfig, estimate_costs, prepare
from repro_torch.graph import generators as tgen

pytest_plugins = ["torch_jax_executables"]

CPU = "cpu"


def both(fn, *args, **kw):
    """The same seeded graph from each package's generators."""
    return getattr(jgen, fn)(*args, **kw), getattr(tgen, fn)(*args, **kw)


def assert_same_run(tdrv, tres, jdrv, jres):
    """Every counter, result field, chunk count and auto choice."""
    assert tdrv.last_counters == jdrv.last_counters
    assert set(tdrv.last_counters) == set(driver.COUNTER_KEYS)
    assert dataclasses.asdict(tres) == dataclasses.asdict(jres)
    for k in ("chunks", "engine_choices"):
        assert tdrv.stats[k] == jdrv.stats[k], k


def preempt_after(drv, chunks):
    """Make `drv` fail (as a preempted job) at its (chunks + 1)-th chunk
    dispatch, after `chunks` chunks went out."""
    n = 0
    orig = drv._run_chunk

    def failing(*args):
        nonlocal n
        if n >= chunks:
            raise RuntimeError("simulated preemption")
        n += 1
        return orig(*args)
    drv._run_chunk = failing


# --------------------------------------------------------------------------
# scheduling helpers
# --------------------------------------------------------------------------

def _bucket(g):
    return prepare(g, bucket_sizes=(64,), device=CPU).buckets[0]


@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
def test_canonical_order_and_deal_roots_match_reference(n_shards):
    """The cost-descending stable order and the round-robin deal, on the
    cost proxy of a real bucket and on costs with ties."""
    jg, tg = both("erdos_renyi", 200, 0.15, seed=2)
    costs = estimate_costs(_bucket(tg))
    tied = np.round(costs, -2)
    assert len(np.unique(tied)) < len(tied)
    for c in (costs, tied):
        assert np.array_equal(driver.canonical_order(c),
                              jdriver.canonical_order(c))
        got, want = driver.deal_roots(c, n_shards), jdriver.deal_roots(
            c, n_shards)
        assert len(got) == len(want) == n_shards
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


FINGERPRINT_GRAPHS = [
    ("empty", lambda m: m.from_edge_list(7, np.zeros((0, 2), np.int64))),
    ("er", lambda m: m.erdos_renyi(120, 0.1, seed=5)),
    ("ba", lambda m: m.barabasi_albert(400, 6, seed=9)),
    ("kron", lambda m: m.kronecker(9, 16, seed=0)),
]


@pytest.mark.parametrize("make", [g[1] for g in FINGERPRINT_GRAPHS],
                         ids=[g[0] for g in FINGERPRINT_GRAPHS])
def test_graph_fingerprint_matches_reference(make):
    from repro import graph as jgraph
    from repro_torch import graph as tgraph
    got = driver._graph_fingerprint(make(tgraph))
    want = jdriver._graph_fingerprint(make(jgraph))
    assert got == want
    assert all(type(v) is int for v in got)


@pytest.mark.parametrize("take,pad_to", [(10, 10), (7, 10), (12, 10),
                                         (0, 4)])
def test_shard_batch_matches_reference(take, pad_to):
    """A slice shorter than pad_to is padded with no-op roots (empty P,
    |R| = 1, no X0 row alive); a longer one is cut to pad_to."""
    jg, _ = both("erdos_renyi", 150, 0.2, seed=5)
    b = jengine.prepare(jg, bucket_sizes=(32,)).buckets[0]
    idx = jdriver.canonical_order(jdriver.estimate_costs(b))[::2][:take]
    got = driver._shard_batch(b, idx, pad_to)
    want = jdriver._shard_batch(b, idx, pad_to)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(got[0]) == pad_to
    if take < pad_to:
        assert not got[1][take:].any() and (got[4][take:] == 1).all()


# --------------------------------------------------------------------------
# one shard: the port's driver against the reference's
# --------------------------------------------------------------------------

def run_both(graph, cfg=None, **kw):
    """Run both drivers on the same graph (pair from `both`) with the
    same knobs; returns (port driver, its result, reference driver, its
    result)."""
    jg, tg = graph
    cfg = cfg or {}
    jdrv = jdriver.DistributedMCE(jg, cfg=JConfig(**cfg), **kw)
    jres = jdrv.run()
    tdrv = DistributedMCE(tg, cfg=EngineConfig(**cfg), device=CPU, **kw)
    tres = tdrv.run()
    return tdrv, tres, jdrv, jres


@pytest.mark.parametrize("streaming", [True, False],
                         ids=["streamed", "materialized"])
@pytest.mark.parametrize("backend", ["pivot", "hybrid", "rcd"])
@pytest.mark.parametrize("engine", ["perroot", "persistent", "auto"])
def test_driver_matches_reference(engine, backend, streaming):
    """ba(300, 6), buckets (32, 64), 32 roots a chunk (several chunks a
    bucket, pad roots in the last): all 11 counters and every result
    field. Auto picks per bucket from the memoised skew."""
    tdrv, tres, jdrv, jres = run_both(
        both("barabasi_albert", 300, 6, seed=0), dict(backend=backend),
        chunk=32, bucket_sizes=(32, 64), streaming=streaming,
        engine=engine, lanes=8)
    assert_same_run(tdrv, tres, jdrv, jres)
    assert tdrv.stats["chunks"] > 2 and tres.calls > 0


# further configurations through the driver: the fused per-root window
# walk, persistent windows, the two EngineConfig fields, max_iters
# truncation on both engines, and a split with over-decomposition
MORE_CASES = [
    ("perroot-window16", "perroot", dict(dynamic_red=False, window_steps=16)),
    ("persistent-window4", "persistent", dict(window_steps=4)),
    ("perroot-hybrid-reuse-off-density05", "perroot",
     dict(backend="hybrid", reuse_degrees=False, hybrid_density=0.5)),
    ("persistent-revised-reuse-off", "persistent",
     dict(backend="revised", reuse_degrees=False)),
    ("perroot-maxiters", "perroot", dict(max_iters=3)),
    ("persistent-maxiters", "persistent", dict(max_iters=3)),
]


@pytest.mark.parametrize("engine,cfg", [c[1:] for c in MORE_CASES],
                         ids=[c[0] for c in MORE_CASES])
def test_driver_matches_reference_more_configs(engine, cfg):
    tdrv, tres, jdrv, jres = run_both(
        both("barabasi_albert", 300, 6, seed=0), cfg, chunk=64,
        bucket_sizes=(32, 64), engine=engine, lanes=8)
    assert_same_run(tdrv, tres, jdrv, jres)
    assert tres.iters_exhausted == ("max_iters" in cfg)


@pytest.mark.parametrize("engine", ["perroot", "persistent"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer, engine):
    """A checkpoint one package's driver writes after two chunks (a
    simulated preemption) resumes in the other's to the reference's
    totals: the same JSON keys, schedule identity and cursor."""
    jg, tg = both("barabasi_albert", 300, 6, seed=0)
    ck = str(tmp_path / "cross.json")
    kw = dict(chunk=32, ckpt_path=ck, bucket_sizes=(32, 64), engine=engine,
              lanes=8)
    jfull = jdriver.DistributedMCE(jg, **dict(kw, ckpt_path=None))
    want = jfull.run()
    first = (jdriver.DistributedMCE(jg, **kw) if writer == "reference"
             else DistributedMCE(tg, device=CPU, **kw))
    preempt_after(first, 2)
    with pytest.raises(RuntimeError):
        first.run()
    state = driver.DriverCheckpoint.load(ck)
    assert state.roots_done > 0 and sorted(state.counters) == sorted(
        driver.COUNTER_KEYS)
    second = (DistributedMCE(tg, device=CPU, **kw) if writer == "reference"
              else jdriver.DistributedMCE(jg, **kw))
    res = second.run(resume=True)
    assert dataclasses.asdict(res) == dataclasses.asdict(want)
    # two chunks went out and the first was settled (the second is
    # settled only after the next dispatch, which failed)
    assert second.stats["chunks"] == jfull.stats["chunks"] - 1
