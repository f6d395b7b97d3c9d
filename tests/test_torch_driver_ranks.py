"""PyTorch port, the distributed driver over several ranks under gloo.

The reference fans a chunk out with `shard_map` over virtual CPU devices
(tests/test_distributed.py spawns subprocesses with
--xla_force_host_platform_device_count); the port's shards are the ranks
of a `torch.distributed` process group. Each test here spawns the ranks
as processes that join one gloo group through a file store under the
test's tmp_path, each with a timeout of its own, so a rank that hangs
fails its test instead of holding the suite's clock.

Held exactly: 4 ranks give the reference's single-shard totals on every
counter that does not depend on the shard count, and a run preempted
under 4 ranks and resumed under 2 from its checkpoint gives the
reference's totals.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
import uuid

import pytest

from repro.core import bitset_engine as jengine
from repro.core import driver as jdriver
from repro.graph import generators as jgen

pytest_plugins = ["torch_jax_executables"]

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK_TIMEOUT = 180

PRELUDE = """
import dataclasses, json, os
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=os.environ["MCE_INIT"],
                        rank=int(os.environ["RANK"]),
                        world_size=int(os.environ["WORLD_SIZE"]))
from repro_torch.core.driver import DistributedMCE
from repro_torch.core.engine import EngineConfig
from repro_torch.graph import generators as gen


def report(drv, res):
    print("RESULT", json.dumps(dict(
        rank=dist.get_rank(), shards=drv.n_shards, chunks=drv.stats["chunks"],
        counters=drv.last_counters, result=dataclasses.asdict(res))))


def preempt_after(drv, chunks):
    n = 0
    orig = drv._run_chunk

    def failing(*args):
        nonlocal n
        if n >= chunks:
            raise RuntimeError("preempted")
        n += 1
        return orig(*args)
    drv._run_chunk = failing
"""


def run_ranks(tmp_path, n, body, prelude=PRELUDE):
    """Run `body` (after `prelude`, which joins the group) in `n` rank
    processes of one gloo group; returns each rank's RESULT lines, parsed,
    in rank order."""
    env = dict(os.environ, PYTHONPATH=SRC, WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1",
               MCE_INIT=f"file://{tmp_path / ('store-' + uuid.uuid4().hex)}")
    env.pop("LOCAL_RANK", None)
    code = prelude + textwrap.dedent(body) + "\ndist.destroy_process_group()\n"
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              env=dict(env, RANK=str(r)), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(n)]
    deadline = time.monotonic() + RANK_TIMEOUT
    results = []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} of {n} did not finish in "
                            f"{RANK_TIMEOUT} s")
            assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
            results.append([json.loads(ln.split(" ", 1)[1])
                            for ln in out.splitlines()
                            if ln.startswith("RESULT ")])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


# counters that do not depend on how the roots are dealt
SHARD_FREE = ("cliques", "calls", "branches", "sum_px", "truncated")


@pytest.mark.parametrize("engine", ["perroot", "persistent"])
def test_four_ranks_match_one_shard(tmp_path, engine):
    """4 ranks of ba(400, 6) against the reference's single-shard driver:
    every shard-count-free counter and every result field, summed over
    the ranks by the all_reduce and seen alike by all of them; per root,
    the lock-step live_iters (Σ iters) does not depend on the deal
    either."""
    kw = dict(chunk=16, bucket_sizes=(32, 64), engine=engine, lanes=8)
    jdrv = jdriver.DistributedMCE(jgen.barabasi_albert(400, 6, seed=3), **kw)
    want = dataclasses.asdict(jdrv.run())
    ranks = run_ranks(tmp_path, 4, f"""
        drv = DistributedMCE(gen.barabasi_albert(400, 6, seed=3),
                             device="cpu", **{kw!r})
        report(drv, drv.run())
    """)
    keys = SHARD_FREE + (("live_iters",) if engine == "perroot" else ())
    for (got,) in ranks:
        assert got["shards"] == 4
        assert got["result"] == want
        assert {k: got["counters"][k] for k in keys} == \
            {k: jdrv.last_counters[k] for k in keys}
        assert got["counters"] == ranks[0][0]["counters"]
    # a chunk window is 4 x 16 roots: fewer chunks than one shard's
    assert ranks[0][0]["chunks"] < jdrv.stats["chunks"]


@pytest.mark.parametrize("engine,backend", [("perroot", "pivot"),
                                            ("persistent", "hybrid")])
def test_elastic_restart_four_to_two_ranks(tmp_path, engine, backend):
    """Preempt the driver mid-stream under 4 ranks (rank 0 checkpoints),
    resume under 2: the canonical cost-descending cursor lands the
    restart on exactly the remaining roots."""
    ck = str(tmp_path / "elastic.json")
    kw = dict(chunk=8, ckpt_path=ck, bucket_sizes=(32, 64), stream_roots=32,
              engine=engine, lanes=8)
    # the reference's single-host run: the driver's counters do not
    # depend on its chunks or engine
    want = dataclasses.asdict(jengine.run(
        jgen.barabasi_albert(400, 6, seed=9), bucket_sizes=(32, 64),
        backend=backend))
    make = f"""
        drv = DistributedMCE(gen.barabasi_albert(400, 6, seed=9),
                             cfg=EngineConfig(backend={backend!r}),
                             device="cpu", **{kw!r})
    """
    partial = run_ranks(tmp_path, 4, make + """
        preempt_after(drv, 3)
        try:
            drv.run()
        except RuntimeError:
            print("RESULT", json.dumps(dict(preempted=True)))
    """)
    assert all(r == [dict(preempted=True)] for r in partial)
    with open(ck) as f:
        state = json.load(f)
    assert state["roots_done"] > 0 and state["counters"]["calls"] > 0
    resumed = run_ranks(tmp_path, 2, make + """
        report(drv, drv.run(resume=True))
    """)
    for (got,) in resumed:
        assert got["shards"] == 2
        assert got["result"] == want
        assert got["counters"]["truncated"] == 0
