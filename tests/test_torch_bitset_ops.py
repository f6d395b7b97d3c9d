"""PyTorch port, bitset_ops layer: plain versions against the reference.

The port's plain PyTorch versions (`repro_torch.kernels.bitset_ops.ref`)
are held bit-exact against the reference's jnp versions and against its
Pallas kernels in interpret mode, on the same numpy inputs made from a
seed: ties, all-invalid rows, words with the top bit set, K off the
block size, W across one word to 32 and past the 128-lane line. The
dispatcher takes the plain version only for CPU tensors and refuses any
other device; the CUDA kernels themselves run in
tests/test_torch_cuda_kernels.py (skipped without a card) and in
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitset_ops import kernel as jkernel
from repro.kernels.bitset_ops import ref as jref
from repro_torch.kernels.bitset_ops import build, ops, ref, words

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
    ops.reset_launches()
    assert torch.equal(ops.and_popcount_rows(rows, mask),
                       ref.and_popcount_rows(rows, mask))
    for g, w in zip(ops.and_popcount_argmax(rows, mask, valid),
                    ref.and_popcount_argmax(rows, mask, valid)):
        assert torch.equal(g, w)
    for g, w in zip(ops.frame_step(rows, mask, mask, mask),
                    ref.frame_step(rows, mask, mask, mask)):
        assert torch.equal(g, w)
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


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not list((tmp_path / "build").glob("*"))


def test_kernel_source_note_and_entry_points():
    src = build.SOURCE.read_text()
    for name in ("and_popcount_rows", "and_popcount_argmax", "frame_step"):
        assert f"repro/kernels/bitset_ops/kernel.py::{name}" in src
        assert f"int bitset_{name}(" in src
    assert "__popc" in src and "Bound: bytes" in src
