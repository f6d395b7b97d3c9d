"""PyTorch port, embedding_bag: the plain version against the reference.

On the same numpy inputs made from a seed, the port's `ops` (on CPU
tensors, the plain version) and `ref` are held against the reference's
one-hot Pallas kernel in interpret mode and its jnp `ref`, sum and mean,
at rtol = atol = 1e-5 (sums of at most L float32 terms in another order):
the reference kernel test's shapes and vocabulary tiles, bags with no
real id, padding other than -1. An id past the vocabulary is out of
contract: the port's plain version reads the last row, as the reference's
jnp gather does. The CUDA kernel itself runs in
tests/test_torch_cuda_kernels.py (skipped without a card) and in
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import kernel as jkernel
from repro.kernels.embedding_bag import ops as jops
from repro.kernels.embedding_bag import ref as jref
from repro_torch.kernels.embedding_bag import ops, ref

pytest_plugins = ["torch_jax_executables"]

TOL = dict(rtol=1e-5, atol=1e-5)
# (V, D, B, L): the reference's kernel test shapes, then bags longer than
# a warp's 32 ids and D off the 16-byte load
SHAPES = [(64, 8, 16, 4), (512, 32, 100, 8), (1000, 16, 33, 12),
          (2048, 64, 256, 1), (300, 13, 20, 40)]


def _inputs(v, d, b, l, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = np.where(rng.random((b, l)) < 0.8, rng.integers(0, v, (b, l)),
                   -1).astype(np.int32)
    ids[0] = -1                                  # an empty bag
    ids[-1, 0] = -5                              # padding other than -1
    return table, ids


@pytest.mark.parametrize("v,d,b,l", SHAPES)
def test_embedding_bag_sum_matches_reference(v, d, b, l):
    table, ids = _inputs(v, d, b, l, v + d + b + l)
    want = np.asarray(jref.embedding_bag(jnp.asarray(table),
                                         jnp.asarray(ids), "sum"))
    pallas = np.asarray(jkernel.embedding_bag_sum(
        jnp.asarray(table), jnp.asarray(ids), interpret=True))
    np.testing.assert_allclose(pallas, want, **TOL)
    t, i = torch.from_numpy(table), torch.from_numpy(ids)
    for got in (ops.embedding_bag_sum(t, i), ops.embedding_bag(t, i),
                ref.embedding_bag(t, i, "sum")):
        assert got.dtype == torch.float32 and got.shape == (b, d)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not want[0].any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_embedding_bag_sum_casts_like_the_reference(dtype):
    """A table of another floating type is cast to float32 and int64 ids
    to int32 first, as the reference's kernel does: a bfloat16 table
    (values exact in bfloat16) and a float64 one, against its Pallas
    kernel in interpret mode on the same inputs; float32 out."""
    table, ids = _inputs(512, 32, 100, 8, 5)
    table = torch.from_numpy(table).to(torch.bfloat16).float().numpy()
    t_ids, j_ids = torch.from_numpy(ids.astype(np.int64)), jnp.asarray(ids)
    if dtype == "bfloat16":
        t_table = torch.from_numpy(table).to(torch.bfloat16)
        j_table = jnp.asarray(table).astype(jnp.bfloat16)
    else:
        t_table = torch.from_numpy(table.astype(np.float64))
        j_table = jnp.asarray(table.astype(np.float64))
    want = np.asarray(jkernel.embedding_bag_sum(j_table, j_ids,
                                                interpret=True))
    got = ops.embedding_bag_sum(t_table, t_ids)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("block_v", [64, 256])
def test_embedding_bag_vocab_tiles(block_v):
    """The reference kernel's vocabulary tiles, against the same bags."""
    rng = np.random.default_rng(9)
    table = rng.normal(size=(500, 16)).astype(np.float32)
    ids = rng.integers(-1, 500, (64, 6)).astype(np.int32)
    pallas = np.asarray(jkernel.embedding_bag_sum(
        jnp.asarray(table), jnp.asarray(ids), block_v=block_v,
        interpret=True))
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)


@pytest.mark.parametrize("v,d,b,l", SHAPES[:3])
def test_embedding_bag_mean_matches_reference(v, d, b, l):
    table, ids = _inputs(v, d, b, l, v * d + l)
    want = np.asarray(jops.embedding_bag(jnp.asarray(table),
                                         jnp.asarray(ids), "mean"))
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            "mean")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ids_past_the_vocabulary_read_the_last_row():
    table, ids = _inputs(50, 8, 6, 5, 3)
    ids[1, 2] = 50
    ids[2, 0] = np.iinfo(np.int32).max
    want = np.asarray(jref.embedding_bag(jnp.asarray(table),
                                         jnp.asarray(ids), "sum"))
    got = ref.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    clamped = np.where(ids >= 50, 49, ids).astype(np.int32)
    np.testing.assert_allclose(
        got.numpy(), ref.embedding_bag(torch.from_numpy(table),
                                       torch.from_numpy(clamped)).numpy(),
        **TOL)


def test_cpu_dispatch_takes_the_plain_version_without_counting():
    table, ids = (torch.from_numpy(x) for x in _inputs(40, 4, 8, 3, 1))
    ops.LAUNCHES.reset()
    for combiner in ops.COMBINERS:
        assert torch.equal(ops.embedding_bag(table, ids, combiner),
                           ref.embedding_bag(table, ids, combiner))
    assert ops.LAUNCHES == {"embedding_bag_sum": 0}
    with pytest.raises(ValueError):
        ops.embedding_bag(table, ids, "max")


def test_dispatch_refuses_other_devices():
    table = torch.zeros(10, 4, device="meta")
    ids = torch.zeros(3, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.embedding_bag(table, ids)
    with pytest.raises(ValueError):
        ops.embedding_bag_sum(table, torch.zeros(3, 2, dtype=torch.int32))
