"""PyTorch port, bitset_ops layer: plain versions against the reference.

The port's plain PyTorch versions (`repro_torch.kernels.bitset_ops.ref`)
are held bit-exact against the reference's jnp versions and against its
Pallas kernels in interpret mode, on the same numpy inputs made from a
seed: ties, all-invalid rows, words with the top bit set, K off the
block size, W across one word to 32 and past the 128-lane line. The
engine's two entry points (`lemma8_reduce`, `pivot_select`) are held
against the reference's Lemma-8 block and its `branch_set`. The
dispatcher takes the plain version only for CPU tensors and refuses any
other device; the CUDA kernels themselves run in
tests/test_torch_cuda_kernels.py (skipped without a card) and in
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import frames as jfr
from repro.core.engine import pivot as jpiv
from repro.core.engine import reductions as jred
from repro.kernels.bitset_ops import kernel as jkernel
from repro.kernels.bitset_ops import ops as jops
from repro.kernels.bitset_ops import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels.bitset_ops import build, ops, ref, words
from torch_census_inputs import frame_inputs

pytest_plugins = ["torch_jax_executables"]


EDGE_WORDS = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF,
                       0x80000001, 0x55555555, 0xAAAAAAAA], dtype=np.uint32)


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    w[rng.random(shape) < 0.15] |= np.uint32(0x80000000)
    w[rng.random(shape) < 0.05] = np.uint32(0xFFFFFFFF)
    w[rng.random(shape) < 0.05] = 0
    return w


def _t(x):
    """numpy uint32 words / bools -> the port's tensors, bit for bit."""
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(x))


def _u32(t):
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


SHAPES = [(1, 1, 1), (3, 7, 4), (2, 100, 8), (2, 515, 4), (1, 64, 128),
          (2, 33, 160), (4, 257, 32), (3, 2048, 1)]


def _pick_block(k):
    return 256 if k >= 256 else max(1, k // 2)


def test_popcount_edge_words():
    x = np.concatenate([EDGE_WORDS, _words((4096,), 0)])
    want = np.array([bin(int(v)).count("1") for v in x])
    assert np.array_equal(words.popcount(_t(x)).numpy(), want)
    assert int(words.popcount_words(_t(x))) == int(want.sum())


@pytest.mark.parametrize("r,k,w", SHAPES)
def test_and_popcount_rows_matches_reference(r, k, w):
    rows, mask = _words((r, k, w), k + w), _words((r, w), k * w + 1)
    got = ref.and_popcount_rows(_t(rows), _t(mask)).numpy()
    want = np.asarray(jref.and_popcount_rows(jnp.asarray(rows),
                                             jnp.asarray(mask)))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    for i in range(r):   # the Pallas kernel, one root at a time
        pk = jkernel.and_popcount_rows(jnp.asarray(rows[i]),
                                       jnp.asarray(mask[i]),
                                       block_k=_pick_block(k), interpret=True)
        assert np.array_equal(got[i], np.asarray(pk))


@pytest.mark.parametrize("r,k,w", SHAPES)
@pytest.mark.parametrize("case", ["random", "tied", "all_invalid"])
def test_and_popcount_argmax_matches_reference(r, k, w, case):
    rng = np.random.default_rng(r * 1000 + k + w)
    rows, mask = _words((r, k, w), k + 3 * w), _words((r, w), k * w + 5)
    if case == "tied":
        rows[:] = rows[:, :1]            # every score equal: first valid wins
    valid = rng.random((r, k)) < 0.6
    if case == "all_invalid":
        valid[:] = False
    gi, gb = ref.and_popcount_argmax(_t(rows), _t(mask), _t(valid))
    wi, wb = jref.and_popcount_argmax(jnp.asarray(rows), jnp.asarray(mask),
                                      jnp.asarray(valid))
    assert gi.dtype == torch.int32 and gb.dtype == torch.int32
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gb.numpy(), np.asarray(wb))
    if case == "all_invalid":
        assert (gi == 0).all() and (gb == -1).all()
    for i in range(r):
        pi, pb = jkernel.and_popcount_argmax(
            jnp.asarray(rows[i]), jnp.asarray(mask[i]), jnp.asarray(valid[i]),
            block_k=_pick_block(k), interpret=True)
        assert (int(gi[i]), int(gb[i])) == (int(pi), int(pb))


@pytest.mark.parametrize("r,k,w", SHAPES)
def test_frame_step_matches_reference(r, k, w):
    rows = _words((r, k, w), 7 * k + w)
    p, xp, wrow = (_words((r, w), s) for s in (k + 1, k + 2, k + 3))
    got = ref.frame_step(_t(rows), _t(p), _t(xp), _t(wrow))
    want = jref.frame_step(jnp.asarray(rows), jnp.asarray(p),
                           jnp.asarray(xp), jnp.asarray(wrow))
    for g, w_ in zip(got, want):
        assert np.array_equal(_u32(g), np.asarray(w_))
    for i in range(r):
        pk = jkernel.frame_step(jnp.asarray(rows[i]), jnp.asarray(p[i]),
                                jnp.asarray(xp[i]), jnp.asarray(wrow[i]),
                                block_k=_pick_block(k), interpret=True)
        for g, w_ in zip(got, pk):
            assert np.array_equal(_u32(g)[i], np.asarray(w_).reshape(-1))


# (R, U, XC, W) of the engine's entry points: XC past one word, U not a
# multiple of 32, XC = 0, W = 3 and 4
FRAME_SHAPES = [(7, 32, 40, 1), (8, 50, 33, 2), (7, 64, 0, 2),
                (7, 96, 70, 3), (7, 128, 5, 4)]


def _frame(r, u, xc, w):
    return frame_inputs(r, u, xc, w, seed=r + u + xc + w)


def _reference_lemma8(a, x_rows, P, Xp, xal, Rb, rsz):
    """The reference's Lemma-8 block (`reductions.dynamic_reduce`, its
    dynamic degree-(|P|-1) step) on its own helpers, for one root."""
    A, X = jnp.asarray(a), jnp.asarray(x_rows)
    P, Xp, xal, Rb = (jnp.asarray(v) for v in (P, Xp, xal, Rb))
    U, W = A.shape
    eye, eye_x = jfr.eye_bits(U, W), jfr.eye_bits(X.shape[0], xal.shape[0])
    degP2 = jops.and_popcount_rows(A, P)
    psize = jfr.popcount(P)
    full = jfr.bitset_to_mask(P, U) & (degP2 == psize - 1) & (psize > 0)
    any_full = jnp.any(full)
    n_full = jnp.sum(full.astype(jnp.int32))
    full_bits = jfr.mask_to_bitset(full, eye)
    common = jfr.and_reduce(A, full)
    sub_ok = jops.and_popcount_rows(jnp.bitwise_not(X), full_bits) == 0
    return (jnp.where(any_full, P & ~full_bits, P),
            jnp.where(any_full, Xp & common, Xp),
            jnp.where(any_full, xal & jfr.mask_to_bitset(sub_ok, eye_x), xal),
            jnp.where(any_full, Rb | full_bits, Rb),
            jnp.where(any_full, rsz + n_full, rsz), degP2, n_full)


@pytest.mark.parametrize("r,u,xc,w", FRAME_SHAPES)
def test_lemma8_reduce_matches_reference(r, u, xc, w):
    """`ops.lemma8_reduce` on CPU tensors (the plain version) against the
    reference's Lemma-8 block: roots whose P is empty, one bit, a clique or
    inside one vertex's neighbourhood (Lemma 8 fires), tied rows, xal with
    bits past XC (cleared where Lemma 8 fires, kept elsewhere), XC = 0."""
    a, x_rows, P, Xp, xal, Rb, rsz, _, _ = _frame(r, u, xc, w)
    ops.LAUNCHES.reset()
    got = ops.lemma8_reduce(*(_t(v) for v in (a, x_rows, P, Xp, xal, Rb,
                                              rsz)))
    assert set(ops.LAUNCHES.values()) == {0}
    n_full = got[6].numpy()
    assert n_full[3] > 0 and n_full[6] > 0 and n_full[0] == 0
    for i in range(r):
        want = _reference_lemma8(a[i], x_rows[i], P[i], Xp[i], xal[i], Rb[i],
                                 rsz[i])
        for g, w_ in zip(got, want):
            assert g.dtype == torch.int32
            assert np.array_equal(_u32(g[i]), np.asarray(w_)), i


@pytest.mark.parametrize("backend", ["pivot", "revised", "hybrid"])
@pytest.mark.parametrize("scores", ["reduced", "deg", "sweep"])
@pytest.mark.parametrize("r,u,xc,w", FRAME_SHAPES)
def test_pivot_select_matches_reference(r, u, xc, w, scores, backend):
    """`ops.pivot_select` on CPU tensors against the reference's
    `branch_set`, with the reduced frame's degrees (deg − n_full), the
    frame step's (deg) and its own sweep: an empty pool, tied scores,
    scores below −1 (which lose even to the all-invalid X0 argmax), xal
    with bits past XC. The reference cannot take
    XC = 0, so there the port is held to itself and the reference at
    XC = 1 with that row dead, which is what "no X0 row" means."""
    a, x_rows, P, Xp, xal, _, _, deg, n_full = _frame(r, u, xc, w)
    if xc == 0:
        x_one = np.zeros((r, 1, w), np.uint32)
        xal_one = np.zeros((r, 1), np.uint32)
    jcfg = jfr.EngineConfig(backend=backend)
    kw = dict(revised=backend == "revised", hybrid=backend == "hybrid")
    given = {"reduced": (deg, n_full), "deg": (deg, None),
             "sweep": (None, None)}[scores]
    tgiven = tuple(None if v is None else _t(v) for v in given)
    got = ops.pivot_select(*(_t(v) for v in (a, x_rows, P, Xp, xal)),
                           *tgiven, **kw)
    if xc == 0:
        one = ops.pivot_select(*(_t(v) for v in (a, x_one, P, Xp, xal_one)),
                               *tgiven, **kw)
        assert torch.equal(got, one)
        x_rows, xal = x_one, xal_one
    elif r > 7 and scores != "sweep" and backend == "pivot":
        # root 7: scores below -1 lose to the all-invalid X0 argmax, row 0
        assert np.array_equal(_u32(got[7]), P[7] & ~x_rows[7, 0])
    for i in range(r):
        jctx = jfr.make_context(jnp.asarray(a[i]), jnp.asarray(x_rows[i]))
        red = deg_i = None
        if scores == "reduced":
            red = jred.ReducedFrame(P=None, Xp=None, xal=None, Rb=None,
                                    rsz=None, degP2=jnp.asarray(deg[i]),
                                    n_full=jnp.int32(n_full[i]))
        elif scores == "deg":
            deg_i = jnp.asarray(deg[i])
        want = jpiv.branch_set(jcfg, jctx, jnp.asarray(P[i]),
                               jnp.asarray(Xp[i]), jnp.asarray(xal[i]), red,
                               deg=deg_i)
        assert np.array_equal(_u32(got[i]), np.asarray(want)), i


@pytest.mark.parametrize("total,dense", [(81, True), (80, False)])
def test_pivot_select_hybrid_density_at_the_threshold(total, dense):
    """|P| = 10 puts the hybrid switch at float32(0.9)·10·9 = 81 exactly:
    scores summing to 81 branch on all of P, 80 on the pivot set, as in
    the reference."""
    u, w, xc = 64, 2, 40
    a, x_rows, P, Xp, xal, _, _, deg, _ = frame_inputs(7, u, xc, w, seed=3)
    P[:] = 0
    P[:, 0] = np.uint32(0x3FF)                      # |P| = 10, bits 0..9
    Xp &= ~P
    deg[:, :10] = 8
    deg[:, 0] = total - 8 * 9
    got = ops.pivot_select(*(_t(v) for v in (a, x_rows, P, Xp, xal)),
                           _t(deg), hybrid=True)
    jcfg = jfr.EngineConfig(backend="hybrid")
    for i in range(7):
        jctx = jfr.make_context(jnp.asarray(a[i]), jnp.asarray(x_rows[i]))
        want = jpiv.branch_set(jcfg, jctx, jnp.asarray(P[i]),
                               jnp.asarray(Xp[i]), jnp.asarray(xal[i]), None,
                               deg=jnp.asarray(deg[i]))
        assert np.array_equal(_u32(got[i]), np.asarray(want))
        assert np.array_equal(_u32(got[i]), P[i]) == dense


def test_frame_step_partner_is_the_single_bit():
    """Where exactly one bit survives, partner is its index — including
    bit 31 of a word and the last word."""
    w = 4
    rows = np.zeros((1, 5, w), np.uint32)
    for k, bit in enumerate([0, 31, 32, 127, 95]):
        rows[0, k, bit // 32] = np.uint32(1) << np.uint32(bit % 32)
    full = np.full((1, w), 0xFFFFFFFF, np.uint32)
    _, _, deg, partner = ref.frame_step(_t(rows), _t(full), _t(full),
                                        _t(full))
    assert deg.tolist() == [[1] * 5]
    assert partner.tolist() == [[0, 31, 32, 127, 95]]


def test_cpu_dispatch_takes_the_plain_version_without_counting():
    rows, mask = _t(_words((2, 40, 2), 1)), _t(_words((2, 2), 2))
    valid = torch.ones(2, 40, dtype=torch.bool)
    ops.LAUNCHES.reset()
    assert torch.equal(ops.and_popcount_rows(rows, mask),
                       ref.and_popcount_rows(rows, mask))
    for g, w in zip(ops.and_popcount_argmax(rows, mask, valid),
                    ref.and_popcount_argmax(rows, mask, valid)):
        assert torch.equal(g, w)
    for g, w in zip(ops.frame_step(rows, mask, mask, mask),
                    ref.frame_step(rows, mask, mask, mask)):
        assert torch.equal(g, w)
    for g, w in zip(ops.clique_counts(rows, mask, valid, valid),
                    ref.clique_counts(rows, mask, valid, valid)):
        assert torch.equal(g, w)
    assert torch.equal(ops.and_popcount_many(rows[:, :1], rows),
                       ref.and_popcount_many(rows[:, :1], rows))
    assert set(ops.LAUNCHES.values()) == {0}


def test_dispatch_refuses_other_devices():
    """Only CPU tensors take the plain version; anything else that is not
    CUDA raises instead of falling back."""
    rows = torch.zeros(1, 4, 1, dtype=torch.int32, device="meta")
    mask = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.and_popcount_rows(rows, mask)
    with pytest.raises(ValueError):
        ops.frame_step(rows, mask, mask, mask)
    sel = torch.zeros(1, 4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        ops.clique_counts(rows, mask, sel, sel)
    with pytest.raises(ValueError):
        ops.and_popcount_many(rows, rows)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build.LIBRARY, "build_dir", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.LIBRARY.build()
    assert not list((tmp_path / "build").glob("*"))


def test_kernel_source_note_and_entry_points():
    src = build.SOURCE.read_text()
    for name in ("and_popcount_rows", "and_popcount_argmax", "frame_step",
                 "clique_counts", "and_popcount_many"):
        assert f"repro/kernels/bitset_ops/kernel.py::{name}" in src
        assert f"int bitset_{name}(" in src
    assert "__popc" in src and "Bound: bytes" in src
