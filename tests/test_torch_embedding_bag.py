"""PyTorch port, embedding_bag: the plain version against the reference.

On the same numpy inputs made from a seed, the port's `ops` (on CPU
tensors, the plain version) and `ref` are held against the reference's
one-hot Pallas kernel in interpret mode and its jnp `ref`, sum and mean,
at rtol = atol = 1e-5 (sums of at most L float32 terms in another order):
the reference kernel test's shapes and vocabulary tiles, bags with no
real id, padding other than -1. An id past the vocabulary is out of
contract: the port's plain version reads the last row, as the reference's
jnp gather does. The plain backward `ref.embedding_bag_sum_bwd` is held
against `jax.grad` of the reference model's bag (`repro.models.recsys.
embedding_bag`), sum and mean, at rtol = atol = 1e-5; on CPU tensors the
autograd Function behind `embedding_bag_sum` routes its backward to it.
The CUDA kernels themselves run in tests/test_torch_cuda_kernels.py
(skipped without a card) and in chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import kernel as jkernel
from repro.kernels.embedding_bag import ops as jops
from repro.kernels.embedding_bag import ref as jref
from repro.models import recsys as jrecsys
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
    assert ops.LAUNCHES == {"embedding_bag_sum": 0,
                            "embedding_bag_sum_bwd": 0}
    with pytest.raises(ValueError):
        ops.embedding_bag(table, ids, "max")


def test_dispatch_refuses_other_devices():
    table = torch.zeros(10, 4, device="meta")
    ids = torch.zeros(3, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.embedding_bag(table, ids)
    with pytest.raises(ValueError):
        ops.embedding_bag_sum(table, torch.zeros(3, 2, dtype=torch.int32))


def _jax_table_grad(bag, table, ids, combiner, w):
    """jax.grad of sum(bag(table, ids, combiner) * w) in the table."""
    return np.asarray(jax.grad(lambda t: jnp.sum(
        bag(t, jnp.asarray(ids), combiner) * jnp.asarray(w)))(
        jnp.asarray(table)))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,l", SHAPES)
def test_embedding_bag_bwd_matches_jax_grad(v, d, b, l, combiner):
    """Pads (an empty bag, padding other than -1) through autograd of the
    port's `embedding_bag` (whose sum's backward is the plain
    `embedding_bag_sum_bwd` here) against jax.grad of the reference
    model's jnp bag."""
    table, ids = _inputs(v, d, b, l, 2 * v + d)
    w = np.random.default_rng(l).normal(size=(b, d)).astype(np.float32)
    want = _jax_table_grad(jrecsys.embedding_bag, table, ids, combiner, w)
    t = torch.from_numpy(table).requires_grad_()
    (ops.embedding_bag(t, torch.from_numpy(ids), combiner)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, **TOL)


def test_embedding_bag_bwd_ids_past_the_vocabulary():
    """An id at or above V adds its gradient into row V - 1: the
    derivative of the forward, which reads that row. The reference's JAX
    gather clamps such an id when it reads but drops it from its
    gradient's scatter, so its gradient is not this function's; the port's
    equals jax.grad with those ids replaced by V - 1."""
    table, ids = _inputs(50, 8, 6, 5, 3)
    ids[1, 2] = 50
    ids[2, 0] = np.iinfo(np.int32).max
    clamped = np.where(ids >= 50, 49, ids).astype(np.int32)
    g = np.random.default_rng(0).normal(size=(6, 8)).astype(np.float32)
    got = ref.embedding_bag_sum_bwd(torch.from_numpy(g), torch.from_numpy(ids),
                                    50)
    want = _jax_table_grad(jref.embedding_bag, table, clamped, "sum", g)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dropped = _jax_table_grad(jref.embedding_bag, table, ids, "sum", g)
    assert not np.allclose(dropped[49], want[49])


def test_autograd_takes_the_plain_backward_on_cpu(monkeypatch):
    """On CPU tensors a backward through `embedding_bag` calls
    `ref.embedding_bag_sum_bwd` once and launches nothing; a bfloat16
    table gets a bfloat16 gradient."""
    calls = []
    real = ref.embedding_bag_sum_bwd

    def record(*a):
        calls.append(a[2])
        return real(*a)
    monkeypatch.setattr(ref, "embedding_bag_sum_bwd", record)
    table, ids = _inputs(40, 4, 8, 3, 1)
    ops.LAUNCHES.reset()
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(table).to(dtype).requires_grad_()
        ops.embedding_bag(t, torch.from_numpy(ids), "mean").sum().backward()
        assert t.grad.dtype == dtype and t.grad.shape == (40, 4)
    assert calls == [40, 40]
    assert ops.LAUNCHES == {"embedding_bag_sum": 0,
                            "embedding_bag_sum_bwd": 0}
