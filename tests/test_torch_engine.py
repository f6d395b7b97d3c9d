"""PyTorch port, per-root engine: frames, reductions, pivot, loop, run().

Each layer is fed the same numpy inputs as its reference counterpart
(the reference works on one root and is vmapped or looped; the port
carries the root batch first) and must agree exactly: bit patterns,
counters, enumerated clique sets. `run()` is compared end to end with the
reference's `run()` on a few small graphs, and with the pivot rows of
BENCH_branching.json (ba_web, caveman_comm) without rerunning the
reference on them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import frames as jfr
from repro.core.engine import loop as jloop
from repro.core.engine import pivot as jpiv
from repro.core.engine import prepare as jprepare
from repro.core.engine import reductions as jred
from repro.graph import generators as jgen
from repro_torch import interop
from repro_torch.core import oracle as toracle
from repro_torch.core.engine import frames as fr
from repro_torch.core.engine import loop, pivot, reductions
from repro_torch.core.engine import run
from repro_torch.graph import generators as tgen

CPU = "cpu"


def _words(shape, seed, density=0.5):
    rng = np.random.default_rng(seed)
    bits = rng.random(shape + (32,)) < density
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32) \
        .reshape(shape)


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(
        x.view(np.int32) if x.dtype == np.uint32 else x))


def _u32(t):
    return t.numpy().view(np.uint32)


# --------------------------------------------------------------------------
# frames helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 2, 4])
def test_first_bit_index_and_bit_helpers(w):
    bits = _words((40, w), w, density=0.05)
    bits[0] = 0                                       # all-zero: gives 32
    bits[1, :] = 0
    bits[1, -1] = 0x80000000                          # only the top bit
    got = fr.first_bit_index(_t(bits))
    want = [int(jfr.first_bit_index(jnp.asarray(b))) for b in bits]
    assert got.tolist() == want and got[0] == 32
    u = 32 * w
    masks = fr.bitset_to_mask(_t(bits), u).numpy()
    for b, m in zip(bits, masks):
        assert np.array_equal(m, np.asarray(jfr.bitset_to_mask(
            jnp.asarray(b), u)))


@pytest.mark.parametrize("k,words", [(32, 1), (64, 2), (96, 3), (8, 1),
                                     (1, 1), (2048, 64)])
def test_mask_to_bitset_and_eye(k, words):
    rng = np.random.default_rng(k)
    mask = rng.random((3, k)) < 0.4
    mask[0] = True
    got = _u32(fr.mask_to_bitset(_t(mask), words))
    eye = jfr.eye_bits(k, words)
    assert np.array_equal(_u32(fr.eye_bits(k, words)), np.asarray(eye))
    for m, g in zip(mask, got):
        assert np.array_equal(g, np.asarray(jfr.mask_to_bitset(
            jnp.asarray(m), eye)))


@pytest.mark.parametrize("k,w", [(32, 1), (64, 2), (96, 3), (5, 4), (1, 1)])
def test_or_and_reduce_and_single_bit_rows(k, w):
    rng = np.random.default_rng(k * w)
    rows = _words((3, k, w), k + w)
    rows[0, 0, 0] |= np.uint32(0x80000000)
    sel = rng.random((3, k)) < 0.5
    sel[1] = False                                    # empty selection
    o, a = fr.or_reduce(_t(rows), _t(sel)), fr.and_reduce(_t(rows), _t(sel))
    sb = fr.single_bit_index_rows(_t(rows))
    for i in range(3):
        r_, s_ = jnp.asarray(rows[i]), jnp.asarray(sel[i])
        assert np.array_equal(_u32(o)[i], np.asarray(jfr.or_reduce(r_, s_)))
        assert np.array_equal(_u32(a)[i], np.asarray(jfr.and_reduce(r_, s_)))
        assert np.array_equal(sb[i].numpy(),
                              np.asarray(jfr.single_bit_index_rows(r_)))


@pytest.mark.parametrize("cap", [0, 3, 8])
def test_report_single_and_multi_match(cap):
    """Counts, positions, overflow and out_n under the reference's drop
    semantics, over several reports that overflow a small buffer."""
    R, K, W = 3, 6, 2
    rng = np.random.default_rng(cap)
    jcfg, tcfg = jfr.EngineConfig(out_cap=cap), fr.EngineConfig(out_cap=cap)
    tc = fr.carry_init(tcfg, R, W, CPU)
    jcs = [jfr.carry_init(jcfg, W) for _ in range(R)]
    for step in range(4):
        rows = _words((R, K, W), step)
        sizes = rng.integers(2, 9, (R, K)).astype(np.int32)
        mask = rng.random((R, K)) < 0.5
        en = rng.random(R) < 0.7
        tc = fr.report_multi(tc, tcfg, _t(rows), _t(sizes), _t(mask))
        tc = fr.report_single(tc, tcfg, _t(rows[:, 0]), _t(sizes[:, 0]),
                              _t(en))
        for r in range(R):
            jcs[r] = jfr.report_multi(jcs[r], jcfg, jnp.asarray(rows[r]),
                                      jnp.asarray(sizes[r]),
                                      jnp.asarray(mask[r]))
            jcs[r] = jfr.report_single(jcs[r], jcfg, jnp.asarray(rows[r, 0]),
                                       jnp.asarray(sizes[r, 0]),
                                       jnp.asarray(en[r]))
    for r in range(R):
        assert int(tc["cliques"][r]) == int(jcs[r]["cliques"])
        if cap:
            assert int(tc["out_n"][r]) == int(jcs[r]["out_n"])
            assert bool(tc["overflow"][r]) == bool(jcs[r]["overflow"])
            assert np.array_equal(_u32(tc["out_rows"])[r, :cap],
                                  np.asarray(jcs[r]["out_rows"]))
            assert np.array_equal(tc["out_sizes"][r, :cap].numpy(),
                                  np.asarray(jcs[r]["out_sizes"]))


# --------------------------------------------------------------------------
# dynamic_reduce + branch_set on one frame of a real bucket
# --------------------------------------------------------------------------

def _bucket(g, u):
    prep = jprepare(g, bucket_sizes=(32, 64))
    return next(b for b in prep.buckets if b.u_pad == u)


@pytest.mark.parametrize("dynamic_red", [True, False])
@pytest.mark.parametrize("backend", ["pivot", "revised"])
def test_dynamic_reduce_and_branch_set_on_one_frame(dynamic_red, backend):
    b = _bucket(jgen.erdos_renyi(150, 0.15, seed=4), 32)
    R, U, W = b.a.shape
    rng = np.random.default_rng(0)
    # a mid-search frame per root: P, Xp a split of the root's universe,
    # a random X0 alive subset and base
    keep = _words((R, W), 1, density=0.6)
    P, Xp = b.p0 & keep, b.p0 & ~keep & _words((R, W), 2, density=0.3)
    alive = b.x_alive0 & (rng.random(b.x_alive0.shape) < 0.7)
    Rb = _words((R, W), 3, density=0.05) & ~b.p0
    rsz = b.rsz0 + 1
    en = rng.random(R) < 0.8
    tcfg = fr.EngineConfig(out_cap=64, dynamic_red=dynamic_red,
                           backend=backend)
    jcfg = jfr.EngineConfig(out_cap=64, dynamic_red=dynamic_red,
                            backend=backend)
    a, p0, xr, xa, _ = interop.bucket_from_reference(
        dict(a=b.a, p0=b.p0, x_rows=b.x_rows, x_alive0=alive, rsz0=b.rsz0),
        CPU).values()
    ctx = fr.make_context(a, xr)
    xal = fr.mask_to_bitset(xa, ctx.xc_words)
    carry = fr.carry_init(tcfg, R, W, CPU)
    rf = None
    if dynamic_red:
        carry, rf = reductions.dynamic_reduce(
            carry, tcfg, ctx, _t(P), _t(Xp), xal, _t(rsz), _t(Rb), _t(en))
        tP, tXp, txal = rf.P, rf.Xp, rf.xal
    else:
        tP, tXp, txal = _t(P), _t(Xp), xal
    tB = pivot.branch_set(tcfg, ctx, tP, tXp, txal, rf)
    for r in range(R):
        jctx = jfr.make_context(jnp.asarray(b.a[r]), jnp.asarray(b.x_rows[r]))
        jxal = jfr.mask_to_bitset(jnp.asarray(alive[r]), jctx.eye_x)
        jc = jfr.carry_init(jcfg, W)
        jrf = None
        jP, jXp = jnp.asarray(P[r]), jnp.asarray(Xp[r])
        if dynamic_red:
            jc, jrf = jred.dynamic_reduce(
                jc, jcfg, jctx, jP, jXp, jxal, jnp.int32(rsz[r]),
                jnp.asarray(Rb[r]), jnp.bool_(en[r]))
            for f in ("P", "Xp", "xal", "Rb"):
                assert np.array_equal(_u32(getattr(rf, f))[r],
                                      np.asarray(getattr(jrf, f))), f
            for f in ("rsz", "n_full"):
                assert int(getattr(rf, f)[r]) == int(getattr(jrf, f))
            assert np.array_equal(rf.degP2[r].numpy(), np.asarray(jrf.degP2))
            jP, jXp, jxal = jrf.P, jrf.Xp, jrf.xal
        jB = jpiv.branch_set(jcfg, jctx, jP, jXp, jxal, jrf)
        assert np.array_equal(_u32(tB)[r], np.asarray(jB))
        assert int(carry["cliques"][r]) == int(jc["cliques"])
        assert int(carry["out_n"][r]) == int(jc["out_n"])
        n = int(jc["out_n"])
        assert np.array_equal(_u32(carry["out_rows"])[r, :n],
                              np.asarray(jc["out_rows"])[:n])


# --------------------------------------------------------------------------
# run_bucket on one reference bucket, fed through interop
# --------------------------------------------------------------------------

PER_ROOT = ("cliques", "calls", "branches", "sum_px", "iters", "truncated")


@pytest.mark.parametrize("max_iters", [1 << 30, 5])
@pytest.mark.parametrize("dynamic_red", [True, False])
def test_run_bucket_per_root_counters_match(dynamic_red, max_iters):
    """Per-root counters of one bucket — the engine alone, prep taken
    from the reference — including max_iters truncation."""
    b = _bucket(jgen.erdos_renyi(150, 0.2, seed=5), 32)
    jcfg = jfr.EngineConfig(dynamic_red=dynamic_red, max_iters=max_iters,
                            out_cap=256)
    tcfg = fr.EngineConfig(dynamic_red=dynamic_red, max_iters=max_iters,
                           out_cap=256)
    arrays = {k: getattr(b, k) for k in interop.BUCKET_KEYS}
    want = jax.tree.map(np.asarray, jloop.run_bucket(
        *(jnp.asarray(arrays[k]) for k in interop.BUCKET_KEYS), jcfg))
    got = loop.run_bucket(*interop.bucket_from_reference(arrays,
                                                         CPU).values(), tcfg)
    for k in PER_ROOT:
        assert np.array_equal(got[k].numpy(), want[k]), k
    if max_iters == 5:
        assert got["truncated"].any()
    assert np.array_equal(got["out_n"].numpy(), want["out_n"])
    assert np.array_equal(interop.bitset_rows_to_reference(got["out_rows"]),
                          want["out_rows"])
    one = loop.run_root(*(v[0] for v in interop.bucket_from_reference(
        arrays, CPU).values()), tcfg)
    assert all(int(one[k]) == int(want[k][0]) for k in PER_ROOT)


def test_run_bucket_counts_pad_roots_once():
    """Streamed flushes pad with no-op roots; each is one call and nothing
    else, as in the reference."""
    from repro.core.engine import PrepStream as JPrepStream
    g = jgen.erdos_renyi(100, 0.12, seed=2)
    buckets = [b for b in JPrepStream(g, bucket_sizes=(32, 64),
                                      stream_roots=16) if b.n_pad]
    assert buckets
    cfg = fr.EngineConfig()
    for b in buckets:
        arrays = {k: getattr(b, k) for k in interop.BUCKET_KEYS}
        got = loop.run_bucket(*interop.bucket_from_reference(
            arrays, CPU).values(), cfg)
        pad = slice(b.num_roots - b.n_pad, None)
        assert got["calls"][pad].tolist() == [1] * b.n_pad
        assert got["cliques"][pad].sum() == 0 and got["iters"][pad].sum() == 0


# --------------------------------------------------------------------------
# run() end to end
# --------------------------------------------------------------------------

RUN_GRAPHS = [
    ("er", "erdos_renyi", (150, 0.12), dict(seed=1)),
    ("ba", "barabasi_albert", (300, 6), dict(seed=2)),
    ("caveman", "caveman", (30, 7, 0.15), dict(seed=3)),
]


@pytest.mark.parametrize("dynamic_red", [True, False])
@pytest.mark.parametrize("name,fn,args,kw", RUN_GRAPHS,
                         ids=[g[0] for g in RUN_GRAPHS])
def test_run_matches_reference(name, fn, args, kw, dynamic_red):
    gj = getattr(jgen, fn)(*args, **kw)
    gt = getattr(tgen, fn)(*args, **kw)
    want = jloop.run(gj, dynamic_red=dynamic_red, enumerate_cliques=True,
                     bucket_sizes=(32, 64))
    got = run(gt, dynamic_red=dynamic_red, enumerate_cliques=True,
              bucket_sizes=(32, 64), device=CPU)
    for k in ("cliques", "calls", "branches", "sum_px", "pre_reported",
              "iters_exhausted", "overflow"):
        assert getattr(got, k) == getattr(want, k), k
    assert len(got.enumerated) == len(want.enumerated) == got.cliques
    assert set(got.enumerated) == set(want.enumerated)


def test_run_revised_backend_matches_reference_and_oracle():
    gj, gt = jgen.erdos_renyi(120, 0.2, seed=8), tgen.erdos_renyi(
        120, 0.2, seed=8)
    want = jloop.run(gj, backend="revised", bucket_sizes=(32, 64))
    got = run(gt, backend="revised", enumerate_cliques=True,
              bucket_sizes=(32, 64), device=CPU)
    assert (got.cliques, got.calls, got.branches, got.sum_px) == (
        want.cliques, want.calls, want.branches, want.sum_px)
    assert set(got.enumerated) == set(toracle.bk_pivot(gt))


# BENCH_branching.json, pivot backend (benchmarks/table3_ablation.py
# --branching): (cliques, calls, branches, sum_px)
BRANCHING = [
    ("ba_web", True, (13725, 339, 64, 1550)),
    ("ba_web", False, (13725, 1248, 973, 2396)),
    ("caveman_comm", True, (488, 538, 111, 2004)),
    ("caveman_comm", False, (488, 1299, 872, 3703)),
]


@pytest.mark.parametrize("name,dynamic_red,want", BRANCHING)
def test_run_reproduces_bench_branching_pivot_rows(name, dynamic_red, want):
    g = (tgen.barabasi_albert(3000, 5, seed=3) if name == "ba_web"
         else tgen.caveman(60, 8, 0.12, seed=7))
    res = run(g, dynamic_red=dynamic_red, bucket_sizes=(32, 64, 128, 256),
              device=CPU)
    assert (res.cliques, res.calls, res.branches, res.sum_px) == want
    assert not res.iters_exhausted


def test_moon_moser_enumeration_matches_oracle():
    g = tgen.moon_moser(5)
    res = run(g, enumerate_cliques=True, device=CPU)
    assert res.cliques == 3 ** 5
    assert set(res.enumerated) == set(toracle.rmce(g))


@pytest.mark.parametrize("kw,exc", [
    (dict(engine="persistent"), NotImplementedError),
    (dict(engine="auto"), NotImplementedError),
    (dict(window_steps=8), NotImplementedError),
    (dict(backend="hybrid"), NotImplementedError),
    (dict(backend="rcd"), NotImplementedError),
    (dict(engine="bogus"), ValueError),
    (dict(backend="bogus"), ValueError),
])
def test_run_refuses_what_is_not_ported(kw, exc):
    with pytest.raises(exc):
        run(tgen.complete_graph(5), device=CPU, **kw)


def test_run_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(tgen.complete_graph(5))


def test_run_stats_record_buckets():
    res = run(tgen.erdos_renyi(100, 0.15, seed=2), bucket_sizes=(32, 64),
              device=CPU)
    assert res.stats["prep_seconds"] >= 0
    assert res.stats["buckets"]
    for b in res.stats["buckets"]:
        assert b["steps"] >= b["max_iters"]
        assert b["sum_iters"] >= b["max_iters"] > 0
