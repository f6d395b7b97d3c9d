"""PyTorch port, the 'rcd' backend: its many-mask kernel's plain version,
its pivot-module functions, and every engine, against the JAX reference.

Tolerance: exact everywhere (integers and bit patterns from the same
seeded numpy inputs). The CUDA kernel itself runs in
tests/test_torch_cuda_kernels.py (skipped without a card) and in
chip_smoke.py; the persistent lanes' rcd cases are in
tests/test_torch_persistent.py (BUCKET_CASES).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import frames as jfr
from repro.core.engine import pivot as jpiv
from repro.kernels.bitset_ops import kernel as jkernel
from repro.kernels.bitset_ops import ref as jref
from repro_torch.core.engine import frames as fr
from repro_torch.core.engine import pivot
from repro_torch.kernels.bitset_ops import ops, ref

from test_hybrid_engine import GRAPHS
from test_torch_hybrid import (CPU, ENGINES, _t, _u32,
                               assert_same_reports, bucket_frames,
                               port_context, ref_context, run_bucket_case,
                               run_case)

pytest_plugins = ["torch_jax_executables"]

EDGE_WORDS = np.array([0, 0xFFFFFFFF, 0x80000000], dtype=np.uint32)


def _edge_words(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    for v in EDGE_WORDS:
        w[rng.random(shape) < 0.08] = v
    return w


# (R, K, M, W): the engine's K = 1 against many masks, M = 1, K and M off
# the 256-thread block, W from one word across 32 to 160
MANY_SHAPES = [(1, 1, 1, 1), (3, 1, 300, 2), (2, 1, 2080, 1), (2, 5, 1, 4),
               (2, 7, 33, 8), (1, 257, 3, 32), (2, 3, 40, 160),
               (4, 1, 160, 33)]


@pytest.mark.parametrize("r,k,m,w", MANY_SHAPES)
def test_and_popcount_many_matches_reference(r, k, m, w):
    rows, masks = _edge_words((r, k, w), k + w), _edge_words((r, m, w), m)
    # some masks are the rows' complements: a zero count (the X-subset
    # test's "dominates" answer)
    masks[:, :min(k, m)] = ~rows[:, :min(k, m)]
    got = ref.and_popcount_many(_t(rows), _t(masks))
    want = np.asarray(jref.and_popcount_many(jnp.asarray(rows),
                                             jnp.asarray(masks)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (r, m, k)
    assert np.array_equal(got.numpy(), want)
    assert (got == 0).any()
    for i in range(r):   # the Pallas kernel in interpret mode, per root
        pk = jkernel.and_popcount_many(jnp.asarray(rows[i]),
                                       jnp.asarray(masks[i]), interpret=True)
        assert np.array_equal(got[i].numpy(), np.asarray(pk))


def test_rcd_select_matches_reference():
    """(has_branch, w) on one bucket's frames: an edge and a single vertex
    (cliques: no branch), an empty P, and random ones (first minimum)."""
    b, f = bucket_frames(seed=2)
    ctx, _ = port_context(b, f["alive"])
    hb, w = pivot.rcd_select(ctx, _t(f["P"]))
    assert hb.dtype == torch.bool and w.dtype == torch.int32
    for r in range(b.a.shape[0]):
        jctx, _ = ref_context(b, f["alive"], r)
        jhb, jw = jpiv.rcd_select(jctx, jnp.asarray(f["P"][r]))
        assert (bool(hb[r]), int(w[r])) == (bool(jhb), int(jw)), r
    assert not hb[0] and not hb[1] and not hb[2] and hb.any()


@pytest.mark.parametrize("gate", ["select", "all"])
def test_rcd_maximality_report_matches_reference(gate):
    """The pop-path report gated by rcd_select's has_branch, or by nothing
    (every root may report): the dominated frame is blocked."""
    b, f = bucket_frames(seed=3)
    R, _, W = b.a.shape
    tcfg = fr.EngineConfig(backend="rcd", out_cap=8)
    jcfg = jfr.EngineConfig(backend="rcd", out_cap=8)
    ctx, xal = port_context(b, f["alive"])
    P = _t(f["P"])
    hb = (pivot.rcd_select(ctx, P)[0] if gate == "select"
          else torch.zeros(R, dtype=torch.bool))
    carry = pivot.rcd_maximality_report(
        fr.carry_init(tcfg, R, W, CPU), tcfg, ctx, P, _t(f["Xp"]), xal,
        _t(f["Rb"]), _t(f["rsz"]), hb)
    jcs = []
    for r in range(R):
        jctx, jxal = ref_context(b, f["alive"], r)
        jcs.append(jpiv.rcd_maximality_report(
            jfr.carry_init(jcfg, W), jcfg, jctx, jnp.asarray(f["P"][r]),
            jnp.asarray(f["Xp"][r]), jxal, jnp.asarray(f["Rb"][r]),
            jnp.int32(f["rsz"][r]), jnp.bool_(bool(hb[r]))))
    assert_same_reports(carry, jcs)
    assert int(carry["cliques"][0]) == 1                  # an open edge
    assert int(carry["cliques"][2]) == 0                  # empty P
    assert int(carry["cliques"][f["dominated"]]) == 0     # blocked
    assert np.array_equal(_u32(carry["out_rows"])[0, 0], f["Rb"][0]
                          | f["P"][0])


def _ref_dominated(a, x_rows, P, Xp, xal):
    """The reference's maximality test (pivot.rcd_maximality_report up to
    its report) on one root: and_popcount_many of P against the stacked
    complements, the selectors, any; and |P|."""
    not_nbrs = jnp.concatenate([jnp.bitwise_not(x_rows), jnp.bitwise_not(a)])
    sub = jref.and_popcount_many(P[None, :], not_nbrs)[:, 0]
    in_x = jnp.concatenate([jfr.bitset_to_mask(xal, x_rows.shape[0]),
                            jfr.bitset_to_mask(Xp, a.shape[0])])
    return bool(jnp.any(in_x & (sub == 0))), int(jfr.popcount(P))


# (R, U, XC, W): the scale-12 buckets' W = 1, 2, 4 with XC = 0, XC off a
# multiple of 32 and past one word, U off 32, and W = 3, 5
DOMINATED_SHAPES = [(6, 32, 100, 1), (6, 64, 40, 2), (6, 7, 0, 1),
                    (6, 128, 33, 4), (6, 50, 70, 3), (6, 160, 1, 5)]


@pytest.mark.parametrize("r,u,xc,w", DOMINATED_SHAPES)
def test_rcd_dominated_matches_reference(r, u, xc, w):
    """ref.rcd_dominated (the kernel's plain version, and `ops` on the CPU)
    against the reference's composition: root 0 an empty P (every selected
    row blocks), root 1 an empty X (nothing blocks), root 2 blocked only by
    a universe row of Xp (no alive X0 row), root 3 by an alive X0 row
    only, root 4 with P containing a set bit outside every row; xal with
    bits past XC."""
    rng = np.random.default_rng(u * 7 + xc)
    below = np.zeros(w, np.uint32)
    for v in range(u):
        below[v // 32] |= np.uint32(1) << np.uint32(v % 32)
    a = _edge_words((r, u, w), u) & below
    x_rows = _edge_words((r, xc, w), xc + 1) & below
    P = _edge_words((r, w), 3) & below
    Xp = _edge_words((r, w), 4) & below & ~P
    xal = _edge_words((r, max(-(-xc // 32), 1)), 5)
    P[0] = 0
    P[1], Xp[1], xal[1] = P[1] | below & 1, 0, 0
    v = int(rng.integers(u))                       # root 2: v in Xp holds P
    Xp[2, v // 32] |= np.uint32(1) << np.uint32(v % 32)
    P[2] = a[2, v] & ~Xp[2] & _edge_words((w,), 6)
    a[2, v] |= P[2]
    xal[2] = 0
    if xc:                                         # root 3: an X0 row holds P
        x = int(rng.integers(xc))
        Xp[3] = 0
        xal[3, x // 32] |= np.uint32(1) << np.uint32(x % 32)
        P[3] = x_rows[3, x] & _edge_words((w,), 7)
    P[4] = below                                   # P is the whole universe
    got = ops.rcd_dominated(*(_t(t) for t in (a, x_rows, P, Xp, xal)))
    want = [_ref_dominated(*(jnp.asarray(t[i])
                             for t in (a, x_rows, P, Xp, xal)))
            for i in range(r)]
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    assert [(bool(b), int(p)) for b, p in zip(*got)] == want
    assert got[0][0] == bool(Xp[0].any() or (xal[0].any() and xc and any(
        (xal[0, i // 32] >> np.uint32(i % 32)) & 1 for i in range(xc))))
    assert not got[0][1] and got[0][2]
    if xc:
        assert got[0][3]


@pytest.mark.parametrize("dynamic_red", [True, False])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_run_bucket_rcd_matches_reference(gname, dynamic_red):
    run_bucket_case(gname, "rcd", dynamic_red)


@pytest.mark.parametrize("engine,kw", ENGINES, ids=[e[0] for e in ENGINES])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_run_rcd_matches_reference(gname, engine, kw):
    run_case(gname, "rcd", engine, kw)
