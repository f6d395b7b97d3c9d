"""PyTorch port, the 'hybrid' backend: its census kernel's plain version,
its pivot-module functions, and every engine, against the JAX reference.

Tolerance: exact everywhere. The census counts, branch sets, counters,
enumeration buffers and scheduling stats are integers or bit patterns,
made from the same numpy inputs (seeded) for both packages. The CUDA
kernel itself runs in tests/test_torch_cuda_kernels.py (skipped without
a card) and in chip_smoke.py. The persistent lanes' hybrid cases are in
tests/test_torch_persistent.py (BUCKET_CASES).
"""
import dataclasses

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
from repro.kernels.bitset_ops import kernel as jkernel
from repro.kernels.bitset_ops import ref as jref
from repro_torch import interop
from repro_torch.core import oracle as toracle
from repro_torch.core.engine import frames as fr
from repro_torch.core.engine import loop, pivot, reductions, run
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen
from repro_torch.kernels.bitset_ops import ops, ref

from test_hybrid_engine import GRAPHS
from torch_census_inputs import bits_of, census_inputs, hybrid_inputs, one_bit

pytest_plugins = ["torch_jax_executables"]

CPU = "cpu"
COUNTERS = ("cliques", "calls", "branches", "sum_px")
PER_ROOT = COUNTERS + ("iters", "truncated")
SHAPES = [(1, 1, 1), (3, 7, 4), (2, 100, 8), (2, 515, 4), (1, 64, 128),
          (2, 33, 160), (4, 257, 32), (3, 2048, 1)]


def _t(x):
    """numpy uint32 words / bools / ints -> the port's tensors, bit for
    bit."""
    x = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(
        x.view(np.int32) if x.dtype == np.uint32 else x))


def _u32(t):
    return t.numpy().view(np.uint32)


def _words(shape, seed, density=0.5):
    rng = np.random.default_rng(seed)
    bits = rng.random(shape + (32,)) < density
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32) \
        .reshape(shape)


def _bits(word_row):
    return np.flatnonzero(np.unpackbits(
        np.asarray(word_row, np.uint32).view(np.uint8), bitorder="little"))


# --------------------------------------------------------------------------
# kernel plain version: clique_counts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("r,k,w", SHAPES)
def test_clique_counts_matches_reference(r, k, w):
    rows, mask, in_p, in_x = census_inputs(r, k, w, k + w)
    got = ref.clique_counts(_t(rows), _t(mask), _t(in_p), _t(in_x))
    want = jref.clique_counts(jnp.asarray(rows), jnp.asarray(mask),
                              jnp.asarray(in_p), jnp.asarray(in_x))
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w_))
    if k > 1:
        assert got[0].sum() > 0 and got[1].sum() > 0
    for i in range(r):   # the Pallas kernel in interpret mode, per root
        pf, pd = jkernel.clique_counts(
            jnp.asarray(rows[i]), jnp.asarray(mask[i]), jnp.asarray(in_p[i]),
            jnp.asarray(in_x[i]), block_k=256 if k >= 256 else max(1, k // 2),
            interpret=True)
        assert (int(got[0][i]), int(got[1][i])) == (int(pf), int(pd))


# (R, U, XC, W): U a multiple of 32 or not, XC = 0, runtime W (3), the
# engine's three buckets' widths
HYBRID_SHAPES = [(5, 64, 40, 2), (5, 50, 37, 2), (4, 32, 0, 1),
                 (6, 100, 130, 4), (4, 7, 5, 1), (5, 70, 33, 3),
                 (4, 128, 128, 4)]


@pytest.mark.parametrize("r,u,xc,w", HYBRID_SHAPES)
def test_hybrid_census_matches_reference(r, u, xc, w):
    """`hybrid_census` (plain version and CPU dispatch) on the engine's
    operands equals the reference's `clique_counts` over A stacked on the
    X0 rows with the selectors built here in numpy, and |P| below U beside
    it: an empty P, a one-bit P, P inside an alive X0 row's neighbourhood,
    a clique P, and P with bits past U."""
    a, xr, P, Xp, xal = hybrid_inputs(r, u, xc, w, seed=u + xc + w)
    in_p = np.concatenate([bits_of(P, u), np.zeros((r, xc), bool)], -1)
    in_x = np.concatenate([bits_of(Xp, u), bits_of(xal, xc)], -1)
    want = jref.clique_counts(jnp.asarray(np.concatenate([a, xr], 1)),
                              jnp.asarray(P), jnp.asarray(in_p),
                              jnp.asarray(in_x))
    psize = bits_of(P, u).sum(-1)
    for impl in (ref, ops):
        got = impl.hybrid_census(_t(a), _t(xr), _t(P), _t(Xp), _t(xal))
        assert all(g.dtype == torch.int32 for g in got)
        for g, w_ in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w_))
        assert np.array_equal(got[2].numpy(), psize)
    n_full, n_dom = (np.asarray(x) for x in want)
    assert psize[0] == 0 and n_full[0] == 0 and psize[1] == 1
    assert n_full[3] == psize[3] > 0
    if xc:
        assert n_dom[2] > 0
    assert n_dom.sum() > 0


# --------------------------------------------------------------------------
# pivot module on one bucket's frames
# --------------------------------------------------------------------------

def bucket_frames(seed=0):
    """A real U=32 bucket and one mid-search frame per root: P ⊆ p0, Xp
    disjoint from P, a random X0 alive subset, a base Rb. Root 0's P is
    an edge (a clique, undominated: no X), root 1's one vertex, root 2's
    empty, and root f["dominated"]'s is dominated by an alive X0 row."""
    g = jgen.erdos_renyi(150, 0.15, seed=4)
    b = next(b for b in jprepare(g, bucket_sizes=(32, 64)).buckets
             if b.u_pad == 32)
    R, U, W = b.a.shape
    rng = np.random.default_rng(seed)
    keep = _words((R, W), seed + 1, density=0.6)
    P = b.p0 & keep
    Xp = b.p0 & ~keep & _words((R, W), seed + 2, density=0.3)
    alive = b.x_alive0 & (rng.random(b.x_alive0.shape) < 0.7)
    Rb = _words((R, W), seed + 3, density=0.05) & ~b.p0
    rsz = b.rsz0 + 1
    # root 0: an edge {u, v} of its universe, nothing forbidden
    u = int(_bits(b.p0[0])[0])
    v = int(_bits(b.a[0, u] & b.p0[0])[0])
    P[0] = one_bit(W, u) | one_bit(W, v)
    Xp[0] = 0
    alive[0] = False
    # root 1: one vertex; root 2: empty
    P[1] = one_bit(W, int(_bits(b.p0[1])[0]))
    P[2] = 0
    # the first later root with an X0 row meeting its universe: P inside
    # that row's neighbourhood, the row alive
    r, j = next((r, j) for r in range(3, R)
                for j in range(b.x_rows.shape[1])
                if (b.x_rows[r, j] & b.p0[r]).any())
    P[r] = b.x_rows[r, j] & b.p0[r]
    alive[r, j] = True
    return b, dict(P=P, Xp=Xp, alive=alive, Rb=Rb, rsz=rsz,
                   en=rng.random(R) < 0.9, dominated=r)


def port_context(b, alive):
    a, _, xr, xa, _ = interop.bucket_from_reference(
        dict(a=b.a, p0=b.p0, x_rows=b.x_rows, x_alive0=alive, rsz0=b.rsz0),
        CPU).values()
    ctx = fr.make_context(a, xr)
    return ctx, fr.mask_to_bitset(xa, ctx.xc_words)


def ref_context(b, alive, r):
    jctx = jfr.make_context(jnp.asarray(b.a[r]), jnp.asarray(b.x_rows[r]))
    return jctx, jfr.mask_to_bitset(jnp.asarray(alive[r]), jctx.eye_x)


def assert_same_reports(carry, jcs):
    for r, jc in enumerate(jcs):
        assert int(carry["cliques"][r]) == int(jc["cliques"])
        n = int(jc["out_n"])
        assert int(carry["out_n"][r]) == n
        assert np.array_equal(_u32(carry["out_rows"])[r, :n],
                              np.asarray(jc["out_rows"])[:n])
        assert np.array_equal(carry["out_sizes"][r, :n].numpy(),
                              np.asarray(jc["out_sizes"])[:n])


def test_hybrid_early_term_matches_reference():
    b, f = bucket_frames()
    R, _, W = b.a.shape
    tcfg = fr.EngineConfig(backend="hybrid", out_cap=8)
    jcfg = jfr.EngineConfig(backend="hybrid", out_cap=8)
    ctx, xal = port_context(b, f["alive"])
    carry, stop = pivot.hybrid_early_term(
        fr.carry_init(tcfg, R, W, CPU), tcfg, ctx, _t(f["P"]), _t(f["Xp"]),
        xal, _t(f["Rb"]), _t(f["rsz"]), _t(f["en"]))
    jcs = []
    for r in range(R):
        jctx, jxal = ref_context(b, f["alive"], r)
        jc, jstop = jpiv.hybrid_early_term(
            jfr.carry_init(jcfg, W), jcfg, jctx, jnp.asarray(f["P"][r]),
            jnp.asarray(f["Xp"][r]), jxal, jnp.asarray(f["Rb"][r]),
            jnp.int32(f["rsz"][r]), jnp.bool_(f["en"][r]))
        assert bool(stop[r]) == bool(jstop), r
        jcs.append(jc)
    assert_same_reports(carry, jcs)
    # the clique roots stop and report (when enabled), the dominated one
    # stops silently, the empty one does not stop
    d = f["dominated"]
    assert stop[0] and stop[1] and not stop[2] and stop[d]
    assert int(carry["cliques"][d]) == 0
    assert int(carry["cliques"][0]) == int(f["en"][0])


@pytest.mark.parametrize("mode", ["dynamic_red", "deg", "sweep"])
def test_hybrid_branch_set_matches_reference(mode):
    """The hybrid branch set with dynamic reduction (degrees from the
    reduced frame), with the frame step's degree vector, and at a root
    entry without either (one AND+popcount sweep of A). Root 0's P is a
    2-clique: dense, so B = P."""
    b, f = bucket_frames(seed=1)
    R, _, W = b.a.shape
    dyn = mode == "dynamic_red"
    tcfg = fr.EngineConfig(backend="hybrid", dynamic_red=dyn, out_cap=64)
    jcfg = jfr.EngineConfig(backend="hybrid", dynamic_red=dyn, out_cap=64)
    ctx, xal = port_context(b, f["alive"])
    P, Xp, rf, deg = _t(f["P"]), _t(f["Xp"]), None, None
    if dyn:
        _, rf = reductions.dynamic_reduce(
            fr.carry_init(tcfg, R, W, CPU), tcfg, ctx, P, Xp, xal,
            _t(f["rsz"]), _t(f["Rb"]), _t(f["en"]))
        P, Xp, xal = rf.P, rf.Xp, rf.xal
    elif mode == "deg":
        deg = ref.and_popcount_rows(ctx.A, P)
    B = pivot.branch_set(tcfg, ctx, P, Xp, xal, rf, deg=deg)
    for r in range(R):
        jctx, jxal = ref_context(b, f["alive"], r)
        jP, jXp, jrf = jnp.asarray(f["P"][r]), jnp.asarray(f["Xp"][r]), None
        if dyn:
            _, jrf = jred.dynamic_reduce(
                jfr.carry_init(jcfg, W), jcfg, jctx, jP, jXp, jxal,
                jnp.int32(f["rsz"][r]), jnp.asarray(f["Rb"][r]),
                jnp.bool_(f["en"][r]))
            jP, jXp, jxal = jrf.P, jrf.Xp, jrf.xal
        jdeg = None if deg is None else jnp.asarray(deg[r].numpy())
        jB = jpiv.branch_set(jcfg, jctx, jP, jXp, jxal, jrf, deg=jdeg)
        assert np.array_equal(_u32(B)[r], np.asarray(jB)), r
    if not dyn:
        assert np.array_equal(_u32(B)[0], f["P"][0])


def test_hybrid_density_is_the_reference_default():
    """The density switch defaults to the reference's default, the one
    value the reference's run() uses, in EngineConfig and in the kernel's
    entry point."""
    assert pivot.HYBRID_DENSITY == jfr.EngineConfig().hybrid_density \
        == fr.EngineConfig().hybrid_density == ops.HYBRID_DENSITY


# --------------------------------------------------------------------------
# the per-root engine on one bucket, and run() on every engine
# --------------------------------------------------------------------------

def _one_bucket(gname):
    return jprepare(GRAPHS[gname](), bucket_sizes=(64,)).buckets[0]


def run_bucket_case(gname, backend, dynamic_red, **more):
    """Per-root counters, iters and enumeration buffers of one bucket
    (`more`: further EngineConfig fields)."""
    b = _one_bucket(gname)
    cfg = dict(backend=backend, dynamic_red=dynamic_red, out_cap=256, **more)
    arrays = {k: getattr(b, k) for k in interop.BUCKET_KEYS}
    want = jax.tree.map(np.asarray, jloop.run_bucket(
        *(jnp.asarray(arrays[k]) for k in interop.BUCKET_KEYS),
        jfr.EngineConfig(**cfg)))
    got = loop.run_bucket(*interop.bucket_from_reference(
        arrays, CPU).values(), fr.EngineConfig(**cfg))
    for k in PER_ROOT + ("out_n", "overflow", "out_sizes"):
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert np.array_equal(interop.bitset_rows_to_reference(got["out_rows"]),
                          want["out_rows"])
    assert got["calls"].sum() > 0


@pytest.mark.parametrize("dynamic_red", [True, False])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_run_bucket_hybrid_matches_reference(gname, dynamic_red):
    run_bucket_case(gname, "hybrid", dynamic_red)


@pytest.mark.parametrize("density", [0.5, 1.0])
@pytest.mark.parametrize("dynamic_red", [True, False])
def test_run_bucket_hybrid_density_matches_reference(dynamic_red, density):
    """cfg.hybrid_density away from its default: the density switch at
    0.5 (more vertex branching) and at 1.0 (only on cliques), with the
    reduced frame's degrees and the frame step's."""
    run_bucket_case("caveman", "hybrid", dynamic_red,
                    hybrid_density=density)


@pytest.mark.parametrize("density", [0.5, 1.0])
@pytest.mark.parametrize("mode", ["dynamic_red", "deg", "sweep"])
def test_hybrid_branch_set_density_matches_reference(mode, density):
    """branch_set with cfg.hybrid_density at 0.5 and 1.0, with
    reuse_degrees on (all three scoring modes) and, for the sweep, off:
    the reference's branch sets root by root, and at 0.5 more roots
    branch on all of P than at 1.0."""
    b, f = bucket_frames(seed=1)
    R, _, W = b.a.shape
    dyn = mode == "dynamic_red"
    reuse = mode != "sweep"
    cfg = dict(backend="hybrid", dynamic_red=dyn, out_cap=64,
               hybrid_density=density, reuse_degrees=reuse)
    tcfg, jcfg = fr.EngineConfig(**cfg), jfr.EngineConfig(**cfg)
    ctx, xal = port_context(b, f["alive"])
    P, Xp, rf = _t(f["P"]), _t(f["Xp"]), None
    deg = ref.and_popcount_rows(ctx.A, P)       # ignored when not reused
    if dyn:
        _, rf = reductions.dynamic_reduce(
            fr.carry_init(tcfg, R, W, CPU), tcfg, ctx, P, Xp, xal,
            _t(f["rsz"]), _t(f["Rb"]), _t(f["en"]))
        P, Xp, xal, deg = rf.P, rf.Xp, rf.xal, None
    B = pivot.branch_set(tcfg, ctx, P, Xp, xal, rf, deg=deg)
    for r in range(R):
        jctx, jxal = ref_context(b, f["alive"], r)
        jP, jXp, jrf = jnp.asarray(f["P"][r]), jnp.asarray(f["Xp"][r]), None
        if dyn:
            _, jrf = jred.dynamic_reduce(
                jfr.carry_init(jcfg, W), jcfg, jctx, jP, jXp, jxal,
                jnp.int32(f["rsz"][r]), jnp.asarray(f["Rb"][r]),
                jnp.bool_(f["en"][r]))
            jP, jXp, jxal = jrf.P, jrf.Xp, jrf.xal
        jdeg = None if deg is None else jnp.asarray(deg[r].numpy())
        jB = jpiv.branch_set(jcfg, jctx, jP, jXp, jxal, jrf, deg=jdeg)
        assert np.array_equal(_u32(B)[r], np.asarray(jB)), r
    whole = int((B == P).all(-1).sum())
    other = pivot.branch_set(
        dataclasses.replace(tcfg, hybrid_density=1.5 - density), ctx, P, Xp,
        xal, rf, deg=deg)
    assert (whole > int((other == P).all(-1).sum())) == (density == 0.5)


ENGINES = [("perroot", {}), ("persistent", {}),
           ("persistent-win4", dict(window_steps=4)), ("auto", {})]


def run_case(gname, backend, engine, kw):
    """run() with enumeration on the port against the reference's:
    counters, and for the persistent lanes every stat (enumerating
    changes the lanes' schedule, so both enumerate); the enumerated set
    against the reference's and the port's oracle."""
    gj = GRAPHS[gname]()
    gt = tcsr.from_edge_list(gj.n, gj.edges())
    kw = dict(kw, backend=backend, engine=engine.split("-")[0],
              enumerate_cliques=True, bucket_sizes=(32, 64), lanes=7)
    want = jloop.run(gj, **kw)
    got = run(gt, device=CPU, **kw)
    for k in COUNTERS + ("pre_reported", "iters_exhausted", "overflow"):
        assert getattr(got, k) == getattr(want, k), k
    if engine.startswith("persistent"):
        for k, v in want.stats.items():
            assert got.stats[k] == v, k
    assert not got.overflow and len(got.enumerated) == got.cliques
    assert set(got.enumerated) == set(want.enumerated) \
        == set(toracle.bk_pivot(gt))


@pytest.mark.parametrize("engine,kw", ENGINES, ids=[e[0] for e in ENGINES])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_run_hybrid_matches_reference(gname, engine, kw):
    run_case(gname, "hybrid", engine, kw)


# BENCH_branching.json, hybrid backend (benchmarks/table3_ablation.py
# --branching): (cliques, calls, branches, sum_px); they differ from the
# pivot rows where dynamic reduction is off
BRANCHING = [
    ("ba_web", True, (13725, 339, 64, 1550)),
    ("ba_web", False, (13725, 1041, 766, 2286)),
    ("caveman_comm", True, (488, 538, 111, 2004)),
    ("caveman_comm", False, (488, 718, 291, 2790)),
]


@pytest.mark.parametrize("name,dynamic_red,want", BRANCHING)
def test_run_reproduces_bench_branching_hybrid_rows(name, dynamic_red, want):
    g = (tgen.barabasi_albert(3000, 5, seed=3) if name == "ba_web"
         else tgen.caveman(60, 8, 0.12, seed=7))
    res = run(g, backend="hybrid", dynamic_red=dynamic_red,
              bucket_sizes=(32, 64, 128, 256), device=CPU)
    assert (res.cliques, res.calls, res.branches, res.sum_px) == want
    assert not res.iters_exhausted
