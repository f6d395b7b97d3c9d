"""PyTorch port, persistent lane engine: refill, steal, stream spans,
stack windows and the `auto` policy, against the JAX reference.

The persistent engine is pure scheduling, but its schedule is
deterministic, so the port must reproduce the reference's run exactly:
per-lane counters and enumeration buffers (`out_rows`, `out_sizes`,
`out_root`), and every scheduling stat (`iters`, `live_iters`,
`claimed`, `steals`, `entry_terms`, `window_spills`, `window_hits`,
`truncated`). Both engines are fed the same reference buckets through
`interop`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import choose_engine as jchoose
from repro.core.engine import estimate_costs as jcosts
from repro.core.engine import loop as jloop
from repro.core.engine import prepare as jprepare
from repro.graph import generators as jgen
from repro_torch import interop
from repro_torch.core.engine import (EngineConfig, choose_engine,
                                     root_cost_skew, run,
                                     run_bucket_persistent,
                                     run_stream_persistent)
from repro_torch.graph import csr as tcsr

from test_persistent_engine import GRAPHS, plant_hub, skewed_graph

pytest_plugins = ["torch_jax_executables"]

CPU = "cpu"
COUNTERS = ("cliques", "calls", "branches", "sum_px")
STATS = ("iters", "live_iters", "claimed", "steals", "entry_terms",
         "window_spills", "window_hits")
ENUM = ("out_n", "overflow", "out_rows", "out_sizes", "out_root")


def _hub():
    # big enough that graph reduction leaves the hub: lanes really steal
    return skewed_graph(blob=40, p=0.6)


def _port_graph(g):
    return tcsr.from_edge_list(g.n, g.edges())


def _assert_same(got, want, cfg):
    for k in COUNTERS:
        assert np.array_equal(np.asarray(got[k]), want[k]), k
    for k in STATS:
        assert int(got[k]) == int(want[k]), k
    assert bool(got["truncated"]) == bool(want["truncated"])
    if cfg.get("out_cap"):
        for k in ENUM:
            g = np.asarray(got[k])
            assert np.array_equal(g.view(want[k].dtype) if g.dtype.kind
                                  == "i" and want[k].dtype.kind == "u"
                                  else g, want[k]), k


def _host(out):
    return {k: v.cpu().numpy() if hasattr(v, "cpu") else v
            for k, v in out.items()}


# (id, graph, bucket size, lanes, config): steal on/off, both victims,
# window_steps 0/4/16, window_frames 0/4, dynamic reduction on/off,
# enumeration, lanes > roots and max_iters truncation
BUCKET_CASES = [
    ("er-lanes-gt-roots", GRAPHS["er"], 200, {}),
    ("ba", GRAPHS["ba"], 7, {}),
    ("caveman", GRAPHS["caveman"], 7, {}),
    ("hub", _hub, 8, {}),
    ("hub-nosteal", _hub, 8, dict(steal=False)),
    ("hub-win4", _hub, 8, dict(window_steps=4)),
    ("hub-win16-kernel", _hub, 8, dict(dynamic_red=False, window_steps=16)),
    ("hub-win4-frames4", _hub, 8, dict(window_steps=4, window_frames=4)),
    ("hub-win16-frames4-nodyn-deepest", _hub, 8,
     dict(dynamic_red=False, window_steps=16, window_frames=4,
          steal_victim="deepest")),
    ("hub-enum-win4", _hub, 8, dict(out_cap=2048, window_steps=4)),
    ("hub-maxiters", _hub, 8, dict(max_iters=5)),
    ("hub-kernel-maxiters", _hub, 8,
     dict(dynamic_red=False, window_steps=16, max_iters=3)),
    # the 'hybrid' and 'rcd' backends: plain lanes, engine-step windows
    # (full depth with in-trip steals, and bounded), enumeration, steal
    # off (rcd never steals) and truncation
    ("hub-hybrid", _hub, 8, dict(backend="hybrid")),
    ("caveman-hybrid-nodyn", GRAPHS["caveman"], 7,
     dict(backend="hybrid", dynamic_red=False)),
    ("hub-hybrid-nosteal", _hub, 8, dict(backend="hybrid", steal=False)),
    ("hub-hybrid-win4", _hub, 8, dict(backend="hybrid", window_steps=4)),
    ("hub-hybrid-win16-frames4-nodyn", _hub, 8,
     dict(backend="hybrid", dynamic_red=False, window_steps=16,
          window_frames=4)),
    ("hub-hybrid-enum-win4", _hub, 8,
     dict(backend="hybrid", out_cap=2048, window_steps=4)),
    ("hub-hybrid-maxiters", _hub, 8, dict(backend="hybrid", max_iters=5)),
    ("hub-rcd", _hub, 8, dict(backend="rcd")),
    ("ba-rcd-nodyn", GRAPHS["ba"], 7, dict(backend="rcd", dynamic_red=False)),
    ("hub-rcd-win4", _hub, 8, dict(backend="rcd", window_steps=4)),
    ("hub-rcd-enum-win4-frames4", _hub, 8,
     dict(backend="rcd", out_cap=2048, window_steps=4, window_frames=4)),
    ("hub-rcd-maxiters", _hub, 8, dict(backend="rcd", max_iters=5)),
]


@pytest.mark.parametrize("graph,lanes,cfg", [c[1:] for c in BUCKET_CASES],
                         ids=[c[0] for c in BUCKET_CASES])
def test_run_bucket_persistent_matches_reference(graph, lanes, cfg):
    prep = jprepare(graph(), bucket_sizes=(64,))
    (b,) = prep.buckets
    arrays = {k: getattr(b, k) for k in interop.BUCKET_KEYS}
    want = jax.tree.map(np.asarray, jloop.run_bucket_persistent(
        *(jnp.asarray(arrays[k]) for k in interop.BUCKET_KEYS),
        JConfig(**cfg), lanes=lanes))
    got = _host(run_bucket_persistent(
        *interop.bucket_from_reference(arrays, CPU).values(),
        EngineConfig(**cfg), lanes=lanes))
    _assert_same(got, want, cfg)
    if cfg.get("backend") == "rcd":
        assert int(got["steals"]) == 0
    if cfg.get("max_iters"):
        assert got["truncated"] and got["iters"] == cfg["max_iters"]
    else:
        assert not got["truncated"] and got["claimed"] == b.num_roots


def test_run_stream_persistent_matches_reference():
    """One span over two same-shape slabs (the bucket split in two): the
    lanes carry across the slab boundary, and out_root is stream-global."""
    g = plant_hub(jgen.erdos_renyi(80, 0.3, seed=0))
    (b,) = jprepare(g, bucket_sizes=(32, 64)).buckets
    arrays = [getattr(b, k) for k in interop.BUCKET_KEYS]
    h = b.num_roots // 2
    slabs = [[x[:h] for x in arrays], [x[h:2 * h] for x in arrays]]
    cfg = dict(out_cap=2048)
    want_outs, want_spans = jloop.run_stream_persistent(
        [tuple(jnp.asarray(x) for x in s) for s in slabs], JConfig(**cfg),
        lanes=8)
    got_outs, got_spans = run_stream_persistent(
        [tuple(interop.bucket_from_reference(
            dict(zip(interop.BUCKET_KEYS, s)), CPU).values())
         for s in slabs], EngineConfig(**cfg), lanes=8)
    assert got_spans == want_spans == [(0, 2)]
    got = _host(got_outs[0])
    _assert_same(got, jax.tree.map(np.asarray, want_outs[0]), cfg)
    assert got["seconds"] > 0
    roots = got["out_root"][got["out_rows"].any(-1)]
    assert roots.max() >= h            # the second slab's global ids


@pytest.mark.parametrize("graph,kw", [
    (lambda: jgen.erdos_renyi(70, 0.6, seed=1), dict(enumerate_cliques=True)),
    (lambda: plant_hub(GRAPHS["ba"]()),
     dict(dynamic_red=False, window_steps=16, lanes=16))],
    ids=["enum-two-spans", "win16-kernel"])
def test_run_persistent_matches_reference(graph, kw):
    gj = graph()
    kw = dict(kw, engine="persistent", bucket_sizes=(32, 64))
    want = jloop.run(gj, **kw)
    got = run(_port_graph(gj), device=CPU, **kw)
    for k in COUNTERS + ("pre_reported", "iters_exhausted", "overflow"):
        assert getattr(got, k) == getattr(want, k), k
    for k, v in want.stats.items():
        assert got.stats[k] == v, k
    assert len(got.stats["span_seconds"]) == got.stats["spans"]
    if kw.get("enumerate_cliques"):
        assert got.stats["spans"] == 2            # a shape change flushes
        assert got.stats["steals"] > 0
        assert len(got.enumerated) == got.cliques
        assert set(got.enumerated) == set(want.enumerated)


def test_run_auto_makes_the_reference_choices():
    gj = _hub()
    want = jloop.run(gj, engine="auto", bucket_sizes=(32, 64), lanes=16)
    got = run(_port_graph(gj), engine="auto", bucket_sizes=(32, 64),
              lanes=16, device=CPU)
    for k in COUNTERS + ("pre_reported", "iters_exhausted"):
        assert getattr(got, k) == getattr(want, k), k
    prep = jprepare(gj, bucket_sizes=(32, 64))
    picks = [jchoose(jcosts(b)[:b.num_roots - b.n_pad], lanes=16,
                     steal=True) for b in prep.buckets]
    assert [(b["engine"], b.get("lanes", 16)) for b in
            got.stats["buckets"]] == [
        (e, min(n, b.num_roots) if e == "persistent" else n)
        for (e, n), b in zip(picks, prep.buckets)]
    assert any(e == "persistent" for e, _ in picks)


SKEW_CASES = [np.zeros(0), np.zeros(20), np.full(20, np.nan),
              np.array([np.inf] + [1.0] * 30), np.full(64, 10.0),
              np.array([1000.0] + [1.0] * 63), np.array([99.0, 1.0, 1.0]),
              np.array([5.0] + [1.0] * 40), np.array([1e-300] * 17),
              np.linspace(0, 50, 200)]


@pytest.mark.parametrize("i", range(len(SKEW_CASES)))
def test_choose_engine_and_skew_match_reference(i):
    costs = SKEW_CASES[i]
    assert root_cost_skew(costs) == jloop.root_cost_skew(costs)
    for lanes in (8, 64):
        for steal in (False, True):
            want = jchoose(costs, lanes=lanes, steal=steal)
            assert choose_engine(costs, lanes=lanes, steal=steal) == want
            n = int(costs.size)
            skew = jloop.root_cost_skew(costs)
            assert choose_engine(skew=skew, n_roots=n, lanes=lanes,
                                 steal=steal) == jchoose(
                skew=skew, n_roots=n, lanes=lanes, steal=steal)
    assert choose_engine(skew=None, n_roots=None) == ("perroot", 64)


def test_persistent_refuses_unknown_steal_victim():
    b = jprepare(GRAPHS["er"](), bucket_sizes=(64,)).buckets[0]
    args = interop.bucket_from_reference(
        {k: getattr(b, k) for k in interop.BUCKET_KEYS}, CPU).values()
    with pytest.raises(ValueError, match="steal_victim"):
        run_bucket_persistent(*args, EngineConfig(steal_victim="x"), lanes=4)
