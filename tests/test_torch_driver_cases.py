"""PyTorch port, the distributed driver on the driver cases of the
reference's own tests (tests/test_distributed.py, tests/test_prep_stream.py,
tests/test_overdecompose.py), with one shard on the CPU.

The same seeded graphs go to both packages; where the reference's test
holds its driver to its `run()` or to the oracle, the port's driver is
held to the same numbers, exactly. Several ranks under gloo are in
tests/test_torch_driver_ranks.py.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import bitset_engine as jengine
from repro.core.engine import PrepStream as JPrepStream
from repro_torch.core import driver
from repro_torch.core import oracle as toracle
from repro_torch.core.driver import DistributedMCE
from repro_torch.core.engine import (EngineConfig, PrepStream,
                                     estimate_costs, prepare, run)

from test_torch_driver import both, preempt_after

pytest_plugins = ["torch_jax_executables"]

CPU = "cpu"


# --------------------------------------------------------------------------
# the reference's driver tests (tests/test_distributed.py), on the port
# --------------------------------------------------------------------------

def test_driver_single_device_matches_engine():
    jg, tg = both("barabasi_albert", 300, 6, seed=0)
    want = jengine.run(jg, bucket_sizes=(32, 64))
    eng = run(tg, bucket_sizes=(32, 64), device=CPU)
    res = DistributedMCE(tg, chunk=64, bucket_sizes=(32, 64),
                         device=CPU).run()
    assert (res.cliques, res.calls) == (want.cliques, want.calls) \
        == (eng.cliques, eng.calls)


def test_driver_checkpoint_restart(tmp_path):
    _, g = both("barabasi_albert", 300, 6, seed=1)
    ck = str(tmp_path / "mce.json")
    full = DistributedMCE(g, chunk=32, bucket_sizes=(32, 64),
                          device=CPU).run()
    drv = DistributedMCE(g, chunk=32, ckpt_path=ck, bucket_sizes=(32, 64),
                         device=CPU)
    preempt_after(drv, 2)
    with pytest.raises(RuntimeError):
        drv.run()
    assert os.path.exists(ck) and not os.path.exists(ck + ".tmp")
    state = driver.DriverCheckpoint.load(ck)
    assert state.roots_done > 0 and state.counters["calls"] > 0
    # a fresh driver (new process semantics) resumes from the cursor
    drv2 = DistributedMCE(g, chunk=32, ckpt_path=ck, bucket_sizes=(32, 64),
                          device=CPU)
    res = drv2.run(resume=True)
    assert dataclasses.asdict(res) == dataclasses.asdict(full)


def test_cost_balanced_dealing():
    _, g = both("erdos_renyi", 200, 0.15, seed=2)
    costs = estimate_costs(prepare(g, bucket_sizes=(64,),
                                   device=CPU).buckets[0])
    shards = driver.deal_roots(costs, 4)
    masses = [costs[s].sum() for s in shards]
    assert max(masses) <= min(masses) * 1.8 + 1e-9, \
        "LPT-style dealing should balance cost mass"
    allr = np.sort(np.concatenate(shards))
    assert np.array_equal(allr, np.arange(len(costs)))


# --------------------------------------------------------------------------
# the reference's driver cases of tests/test_prep_stream.py and
# tests/test_overdecompose.py, on the port
# --------------------------------------------------------------------------

STREAM_GRAPHS = [
    ("er", ("erdos_renyi", 150, 0.12), dict(seed=1)),
    ("ba", ("barabasi_albert", 300, 6), dict(seed=2)),
    ("caveman", ("caveman", 20, 6, 0.15), dict(seed=3)),
]


@pytest.mark.parametrize("args,kw", [g[1:] for g in STREAM_GRAPHS],
                         ids=[g[0] for g in STREAM_GRAPHS])
def test_streamed_counters_match_materialized(args, kw):
    """Bit-identical counters: streamed driver vs single-host engine."""
    jg, tg = both(*args, **kw)
    want = jengine.run(jg, bucket_sizes=(32, 64))
    res = DistributedMCE(tg, chunk=16, bucket_sizes=(32, 64), streaming=True,
                         stream_roots=24, device=CPU).run()
    assert (res.cliques, res.calls, res.branches) == \
        (want.cliques, want.calls, want.branches)


def test_streaming_vs_materialized_driver_modes():
    _, g = both("barabasi_albert", 250, 5, seed=4)
    a = DistributedMCE(g, chunk=32, bucket_sizes=(32, 64), streaming=True,
                       stream_roots=16, device=CPU).run()
    b = DistributedMCE(g, chunk=32, bucket_sizes=(32, 64), streaming=False,
                       device=CPU).run()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_stream_flush_composition_is_shard_count_free():
    """Bucket sequence depends on stream_roots, never on chunks."""
    jg, g = both("erdos_renyi", 120, 0.1, seed=5)
    seqs = []
    for chunk in (8, 64):
        s = PrepStream(g, bucket_sizes=(32, 64), stream_roots=16,
                       device=CPU)
        DistributedMCE(g=None, prep=s, chunk=chunk, device=CPU).run()
        seqs.append([(b.u_pad, b.num_roots) for b in s._cached])
    want = [(b.u_pad, b.num_roots) for b in JPrepStream(
        jg, bucket_sizes=(32, 64), stream_roots=16)]
    assert seqs[0] == seqs[1] == want


def test_auto_split_through_streamed_driver():
    """Roots past the one bucket size split on the host while streaming;
    the reference's test holds its driver to its run(), which is held to
    the oracle's count elsewhere: here the oracle directly."""
    _, g = both("caveman", 3, 40, 0.05, seed=2)
    res = DistributedMCE(g, chunk=16, bucket_sizes=(32,), stream_roots=16,
                         device=CPU).run()
    assert res.cliques == len(toracle.bk_pivot(g))


def test_resume_refuses_schedule_mismatch(tmp_path):
    """The cursor is only meaningful against the same bucket sequence."""
    _, g = both("barabasi_albert", 200, 5, seed=11)
    ck = str(tmp_path / "sched.json")
    kw = dict(chunk=32, bucket_sizes=(32, 64), ckpt_path=ck, device=CPU)
    DistributedMCE(g, stream_roots=16, **kw).run()
    with pytest.raises(ValueError, match="schedule mismatch"):
        DistributedMCE(g, stream_roots=8, **kw).run(resume=True)
    with pytest.raises(ValueError, match="schedule mismatch"):
        DistributedMCE(g, streaming=False, **kw).run(resume=True)
    # same parameters but a DIFFERENT graph: the cursor is meaningless
    _, g2 = both("barabasi_albert", 210, 5, seed=12)
    with pytest.raises(ValueError, match="schedule mismatch"):
        DistributedMCE(g2, stream_roots=16, **kw).run(resume=True)
    # same schedule, different chunking: fine (the elastic dimension)
    res = DistributedMCE(g, stream_roots=16, **dict(kw, chunk=8)).run(
        resume=True)
    assert res.cliques == run(g, bucket_sizes=(32, 64), device=CPU).cliques


def test_prep_and_graph_conflict_rejected():
    _, g = both("erdos_renyi", 50, 0.1, seed=1)
    s = PrepStream(g, bucket_sizes=(32, 64), device=CPU)
    with pytest.raises(ValueError, match="not both"):
        DistributedMCE(g, prep=s, device=CPU)
    with pytest.raises(ValueError, match="need a graph"):
        DistributedMCE(device=CPU)


@pytest.mark.parametrize("kw", [dict(engine="bogus"),
                                dict(cfg=EngineConfig(backend="bogus"))])
def test_driver_rejects_unknown_engine_and_backend(kw):
    _, g = both("erdos_renyi", 50, 0.1, seed=1)
    with pytest.raises(ValueError, match="unknown"):
        DistributedMCE(g, device=CPU, **kw)


def test_driver_owned_stream_does_not_cache():
    _, g = both("erdos_renyi", 120, 0.1, seed=10)
    drv = DistributedMCE(g, chunk=32, bucket_sizes=(32, 64), stream_roots=8,
                         device=CPU)
    drv.run()
    assert drv.stream._cached is None, \
        "one-shot streaming must not retain every packed bucket"
    assert drv.stream.device == drv.device == torch.device(CPU)


def test_split_through_distributed_driver():
    _, g = both("erdos_renyi", 100, 0.3, seed=5)
    res = DistributedMCE(g, chunk=16, bucket_sizes=(32, 64, 128),
                         split_threshold=8, device=CPU).run()
    assert res.cliques == len(toracle.bk_pivot(g))
