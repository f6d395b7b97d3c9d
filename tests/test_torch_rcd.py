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
from repro_torch.kernels.bitset_ops import ref

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
    ctx, _ = port_context(b, f["alive"], "rcd")
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
    ctx, xal = port_context(b, f["alive"], "rcd")
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


@pytest.mark.parametrize("dynamic_red", [True, False])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_run_bucket_rcd_matches_reference(gname, dynamic_red):
    run_bucket_case(gname, "rcd", dynamic_red)


@pytest.mark.parametrize("engine,kw", ENGINES, ids=[e[0] for e in ENGINES])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_run_rcd_matches_reference(gname, engine, kw):
    run_case(gname, "rcd", engine, kw)
