"""PyTorch port, the launchers: `repro_torch.launch.mce_run` (`_num`,
`parse_graph`, `main`), `repro_torch.launch.mce_service.MCEService` and
the `repro_torch.core.bitset_engine` shim, against the reference's.

Tolerance: exact. The same seeded graphs go to both packages: each graph
family's CSR arrays, the counters `main` prints (run with `--device cpu`,
also with `--ckpt`/`--resume`, and as two ranks under torchrun's
environment), and the service's per-query results and accumulated stats
on the same queries, the cases of the reference's service tests
(tests/test_{persistent,hybrid,windowed}_engine.py,
tests/test_prep_stream.py) included.
"""
import dataclasses
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from repro.core import bitset_engine as jshim
from repro.core.engine import EngineConfig as JConfig
from repro.graph import generators as jgen
from repro.launch import mce_run as jrun
from repro.launch import mce_service as jservice
from repro_torch.core import bitset_engine as tshim
from repro_torch.core import oracle as toracle
from repro_torch.core.engine import EngineConfig
from repro_torch.graph import csr as tcsr
from repro_torch.launch import mce_run
from repro_torch.launch.mce_run import _num, parse_graph
from repro_torch.launch.mce_service import MCEService

from test_persistent_engine import skewed_graph

pytest_plugins = ["torch_jax_executables"]

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = "cpu"


# --------------------------------------------------------------------------
# mce_run: argument parsing
# --------------------------------------------------------------------------

def test_num_int_float_and_scientific():
    for v in ("300", "0.25", "1e-3", "2E2", "-7", "1.5e3"):
        got, want = _num(v), jrun._num(v)
        assert got == want and type(got) is type(want), v
    assert isinstance(_num("300"), int) and _num("1e-3") == 1e-3


GRAPH_DESCS = ["er:n=300,p=1e-3,seed=1", "er:n=50,p=0.2", "ba:n=60,m=3",
               "ba", "rgg:n=200,seed=2", "road:side=5", "caveman:c=3,k=4",
               "kron:scale=8,ef=16,seed=0", "kron"]


@pytest.mark.parametrize("desc", GRAPH_DESCS)
def test_parse_graph_matches_reference(desc):
    """Each family's CSR arrays (and its defaults) as the reference's."""
    got, want = parse_graph(desc), jrun.parse_graph(desc)
    assert (got.n, got.m) == (want.n, want.m)
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)


def test_parse_graph_unknown_family():
    with pytest.raises(ValueError, match="unknown graph family"):
        parse_graph("nope:n=10")


# --------------------------------------------------------------------------
# mce_run: main
# --------------------------------------------------------------------------

# lines whose numbers are times: compared by their shape only
TIMED = ("prep stages:", "run ")


def run_main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["mce_run"] + argv)
    module.main()
    return capsys.readouterr().out.splitlines()


def counted_lines(lines):
    return [ln for ln in lines if not ln.startswith(TIMED)]


def untimed(line):
    """A timed line with its seconds and overlap share blanked."""
    return re.sub(r"\d+\.\d+|overlapped \d+%", "#", line)


MAIN_CASES = [
    ("pivot", ["--graph", "ba:n=300,m=6"]),
    ("auto-hybrid", ["--graph", "ba:n=300,m=6", "--engine", "auto",
                     "--backend", "hybrid", "--chunk", "64"]),
    ("persistent-window", ["--graph", "ba:n=300,m=6", "--engine",
                           "persistent", "--lanes", "8",
                           "--window-steps", "4"]),
    ("materialized-nodyn-window", ["--graph", "er:n=150,p=0.2,seed=3",
                                   "--materialize", "--no-dynamic-red",
                                   "--window-steps", "16", "--chunk", "32"]),
]


@pytest.mark.parametrize("argv", [c[1] for c in MAIN_CASES],
                         ids=[c[0] for c in MAIN_CASES])
def test_main_prints_reference_counts(argv, monkeypatch, capsys):
    """`main --device cpu` prints the reference's lines: the graph, the
    counters, lane occupancy, queue and window stats, auto's choices;
    the timed lines keep the reference's form."""
    got = run_main(mce_run, argv + ["--device", "cpu"], monkeypatch, capsys)
    want = run_main(jrun, argv, monkeypatch, capsys)
    assert counted_lines(got) == counted_lines(want)
    assert any(ln.startswith("maximal cliques:") for ln in got)
    for g, w in zip(got, want):
        if g.startswith(TIMED):
            assert untimed(g) == untimed(w)


def test_main_checkpoint_and_resume(tmp_path, monkeypatch, capsys):
    """--ckpt writes the cursor after every chunk; --resume from a
    finished run replays nothing (0 chunks) and prints the same counts,
    which are the reference's."""
    ck = str(tmp_path / "mce.json")
    argv = ["--graph", "er:n=300,p=0.1,seed=3", "--chunk", "32",
            "--ckpt", ck, "--device", "cpu"]
    first = run_main(mce_run, argv, monkeypatch, capsys)
    assert os.path.exists(ck)
    again = run_main(mce_run, argv + ["--resume"], monkeypatch, capsys)
    want = run_main(jrun, ["--graph", "er:n=300,p=0.1,seed=3", "--chunk",
                           "32"], monkeypatch, capsys)
    counts = [ln for ln in want if ln.startswith("maximal cliques:")]
    assert [ln for ln in first if ln.startswith("maximal")] == counts
    assert [ln for ln in again if ln.startswith("maximal")] == counts
    assert "chunks=0" in next(ln for ln in again if ln.startswith("run "))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_under_torchrun_environment(monkeypatch, capsys):
    """With torchrun's environment (WORLD_SIZE = 2, a rendezvous on this
    host) `main` joins the gloo group itself: two shards, rank 0 prints
    the reference's counts, rank 1 prints nothing."""
    argv = ["--graph", "ba:n=300,m=6", "--chunk", "32"]
    want = run_main(jrun, argv, monkeypatch, capsys)
    env = dict(os.environ, PYTHONPATH=SRC, WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.mce_run", *argv,
         "--device", "cpu"],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            outs.append(out.splitlines())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    def counts(lines):
        return [ln for ln in lines if ln.startswith(("graph:", "maximal"))]
    assert len(counts(outs[0])) == 2 and counts(outs[0]) == counts(want)
    assert "shards=2" in next(ln for ln in outs[0] if ln.startswith("run "))
    assert outs[1] == []


# --------------------------------------------------------------------------
# MCEService
# --------------------------------------------------------------------------

def _services(g, **kw):
    """The reference's service and the port's on the same graph."""
    return (jservice.MCEService(g, **kw),
            MCEService(tcsr.from_edge_list(g.n, g.edges()), device=CPU, **kw))


QUERIES = [
    ("pivot", {}, {}),
    ("hybrid", dict(backend="hybrid"), {}),
    ("pivot-reuse-off", dict(reuse_degrees=False), {}),
    ("persistent-window8", dict(window_steps=8), dict(engine="persistent",
                                                      lanes=8)),
    ("auto-rcd", dict(backend="rcd"), dict(engine="auto")),
]


def test_service_matches_reference_service():
    """The same queries, in order, on both services: each result (its
    per-query `stats` included), the accumulated stats, occupancy and
    boundary stall after every query; the cached queries pack nothing."""
    jsvc, tsvc = _services(jgen.barabasi_albert(200, 4, seed=11), chunk=64,
                           stream_roots=64)
    for label, cfg, over in QUERIES:
        want = jsvc.query(JConfig(**cfg), **over)
        got = tsvc.query(EngineConfig(**cfg), **over)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), label
        assert tsvc.stats == jsvc.stats, label
        assert (tsvc.occupancy(), tsvc.stream_occupancy(),
                tsvc.boundary_stall(), tsvc.queries) == \
            (jsvc.occupancy(), jsvc.stream_occupancy(),
             jsvc.boundary_stall(), jsvc.queries), label
        if label == "pivot":
            timings = dict(tsvc.stream.timings)
            n_buckets = tsvc.stream.num_buckets
    assert tsvc.stream.timings == timings
    assert tsvc.stream.num_buckets == n_buckets == jsvc.stream.num_buckets


def test_stream_cache_reuse_across_queries():
    jg = jgen.barabasi_albert(200, 5, seed=7)
    g = tcsr.from_edge_list(jg.n, jg.edges())
    want = jshim.run(jg)
    svc = MCEService(g, chunk=64, stream_roots=16, device=CPU)
    r1 = svc.query(EngineConfig())
    assert svc.stream._cached is not None, "first pass must populate cache"
    n_buckets = svc.stream.num_buckets
    r2 = svc.query(EngineConfig())
    assert (r1.cliques, r1.calls) == (r2.cliques, r2.calls) == \
        (want.cliques, want.calls)
    assert svc.stream.num_buckets == n_buckets
    # warm queries reuse the memoized canonical order, not a rescan
    assert all(b.cost_order is not None for b in svc.stream._cached)


def test_service_stats_accumulate_across_cached_replays():
    jg = jgen.barabasi_albert(200, 4, seed=11)
    svc = MCEService(tcsr.from_edge_list(jg.n, jg.edges()), chunk=64,
                     stream_roots=64, device=CPU)
    r1 = svc.query()
    after_one = {k: svc.stats[k]
                 for k in ("live_iters", "lane_iters", "truncated")}
    assert r1.stats["live_iters"] == after_one["live_iters"] > 0
    assert after_one["lane_iters"] >= after_one["live_iters"]
    assert after_one["truncated"] == 0
    r2 = svc.query()                       # replays the CACHED buckets
    assert r2.cliques == r1.cliques
    for k, v in after_one.items():
        assert svc.stats[k] == 2 * v, k
    assert 0.0 < svc.occupancy() <= 1.0
    assert svc.queries == 2


def test_service_persistent_engine_occupancy_and_choice_counters():
    jg = skewed_graph()
    g = tcsr.from_edge_list(jg.n, jg.edges())
    svc = MCEService(g, chunk=64, stream_roots=128, engine="auto", lanes=16,
                     device=CPU)
    res = svc.query()
    assert res.cliques == len(toracle.bk_pivot(g))
    assert svc.stats["engine_choices"]["persistent"] > 0
    assert 0.0 < svc.occupancy() <= 1.0
    # a per-query override beats the service default
    res2 = svc.query(engine="perroot")
    assert res2.cliques == res.cliques
    assert res2.stats["engine_choices"] == {"perroot": 0, "persistent": 0}


def test_service_surfaces_window_stats():
    jg = skewed_graph()
    svc = MCEService(tcsr.from_edge_list(jg.n, jg.edges()), chunk=64,
                     stream_roots=128, engine="persistent", lanes=8,
                     device=CPU)
    base = svc.query()                                # unwindowed baseline
    assert base.stats["window_spills"] + base.stats["window_hits"] == 0
    assert svc.boundary_stall() == 0.0
    res = svc.query(EngineConfig(window_steps=8))
    assert res.cliques == base.cliques
    assert res.stats["window_spills"] + res.stats["window_hits"] > 0
    assert svc.stats["window_spills"] == res.stats["window_spills"]
    assert svc.stats["window_hits"] == res.stats["window_hits"]
    assert 0.0 <= svc.boundary_stall() <= 1.0
    assert 0.0 < svc.stream_occupancy() == svc.occupancy()
    before = (svc.stats["window_spills"], svc.stats["window_hits"])
    svc.query()
    assert (svc.stats["window_spills"], svc.stats["window_hits"]) == before


@pytest.fixture(scope="module")
def service():
    jg = jgen.barabasi_albert(150, 4, seed=11)
    return MCEService(tcsr.from_edge_list(jg.n, jg.edges()), chunk=64,
                      stream_roots=64, device=CPU)


def test_service_explicit_engine_override_still_works(service):
    res = service.query(engine="perroot", lanes=8)
    assert res.cliques == len(toracle.bk_pivot(service.stream.g))


def test_service_rejects_falsy_engine_override(service):
    with pytest.raises(ValueError, match="engine override"):
        service.query(engine="")
    with pytest.raises(ValueError, match="engine override"):
        service.query(engine="bogus")


@pytest.mark.parametrize("lanes", [0, -4, True, "16"])
def test_service_rejects_bad_lanes_override(service, lanes):
    with pytest.raises(ValueError, match="lanes override"):
        service.query(lanes=lanes)


def test_service_main_prints_reference(monkeypatch, capsys):
    """`mce_service.main --device cpu` against the reference's: the same
    three queries' counters, occupancy and stall, then the service line."""
    from repro_torch.launch import mce_service
    argv = ["--graph", "ba:n=300,m=5", "--chunk", "64"]
    got = run_main(mce_service, argv + ["--device", "cpu"], monkeypatch,
                   capsys)
    want = run_main(jservice, argv, monkeypatch, capsys)

    assert len(got) == 4
    assert [untimed(ln) for ln in got] == [untimed(ln) for ln in want]


# --------------------------------------------------------------------------
# the bitset_engine shim
# --------------------------------------------------------------------------

def test_bitset_engine_shim_exports_the_reference_names():
    names = {n for n in vars(jshim) if not n.startswith("__")}
    assert names == {n for n in vars(tshim) if not n.startswith("__")}
    assert tshim._run_root is tshim.run_root
    g = tcsr.from_edge_list(6, [(i, j) for i in range(6)
                                for j in range(i + 1, 6)])
    assert tshim.run(g, device=CPU).cliques == 1
