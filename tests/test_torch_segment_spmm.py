"""PyTorch port, segment_spmm: the plain versions against the reference.

On the same numpy inputs made from a seed, the port's `ops` (on CPU
tensors, the plain versions) and `ref` are held against the reference's
dense Pallas kernel in interpret mode and its jnp `ref` at rtol = atol =
1e-5 (sums of N float32 products in another order): the reference kernel
test's shapes and N past 32, the dense product against the sparse
gather + scatter-add, with and without edge weights, and `densify_edges`
against the reference's, repeated edges included. The CUDA kernel itself
runs in tests/test_torch_cuda_kernels.py (skipped without a card) and in
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_spmm import kernel as jkernel
from repro.kernels.segment_spmm import ops as jops
from repro.kernels.segment_spmm import ref as jref
from repro_torch.kernels.segment_spmm import ops, ref

pytest_plugins = ["torch_jax_executables"]

TOL = dict(rtol=1e-5, atol=1e-5)
# (B, N, F): the reference's kernel test shapes, then N past 32
SHAPES = [(1, 8, 4), (8, 30, 16), (17, 12, 32), (3, 40, 20)]


def _graphs(b, n, f, seed):
    rng = np.random.default_rng(seed)
    adj = (rng.random((b, n, n)) < 0.3).astype(np.float32)
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    return adj, x


@pytest.mark.parametrize("b,n,f", SHAPES)
def test_dense_spmm_matches_reference(b, n, f):
    adj, x = _graphs(b, n, f, b * n + f)
    want = np.asarray(jref.dense_spmm(jnp.asarray(adj), jnp.asarray(x)))
    pallas = np.asarray(jkernel.dense_spmm(jnp.asarray(adj), jnp.asarray(x),
                                           interpret=True))
    np.testing.assert_allclose(pallas, want, **TOL)
    for fn in (ops.dense_spmm, ref.dense_spmm):
        got = fn(torch.from_numpy(adj), torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (b, n, f)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_dense_spmm_casts_like_the_reference(dtype):
    """Inputs of another floating type are cast to float32 first, as the
    reference's kernel does: bfloat16 inputs (values exact in bfloat16, so
    both sides hold the same numbers) and float64 ones, against its Pallas
    kernel in interpret mode on the same inputs; float32 out."""
    adj, x = _graphs(4, 30, 16, 7)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    if dtype == "bfloat16":
        t_adj, t_x = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (adj, x))
        j_adj, j_x = (jnp.asarray(a).astype(jnp.bfloat16) for a in (adj, x))
    else:
        t_adj, t_x = (torch.from_numpy(a.astype(np.float64))
                      for a in (adj, x))
        j_adj, j_x = (jnp.asarray(a.astype(np.float64)) for a in (adj, x))
    want = np.asarray(jkernel.dense_spmm(j_adj, j_x, interpret=True))
    got = ops.dense_spmm(t_adj, t_x)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_dense_spmm_matches_segment_sum(weighted):
    """The dense path computes the same aggregation as the sparse path."""
    rng = np.random.default_rng(3)
    n, f = 20, 8
    adj = (rng.random((1, n, n)) < 0.3).astype(np.float32)
    x = rng.normal(size=(1, n, f)).astype(np.float32)
    src, dst = np.nonzero(adj[0].T)          # message j -> i iff adj[i, j]
    w = rng.random(len(src)).astype(np.float32) if weighted else None
    if weighted:
        adj[0][dst, src] = w
    want = np.asarray(jops.segment_spmm(
        jnp.asarray(x[0]), jnp.asarray(src), jnp.asarray(dst), n,
        None if w is None else jnp.asarray(w)))
    np.testing.assert_allclose(want, np.asarray(jax.ops.segment_sum(
        jnp.asarray(x[0][src] * (1 if w is None else w[:, None])),
        jnp.asarray(dst), num_segments=n)), **TOL)
    tw = None if w is None else torch.from_numpy(w)
    sparse = ops.segment_spmm(torch.from_numpy(x[0]), torch.from_numpy(src),
                              torch.from_numpy(dst), n, tw)
    np.testing.assert_allclose(sparse.numpy(), want, **TOL)
    dense = ops.dense_spmm(torch.from_numpy(adj), torch.from_numpy(x))[0]
    np.testing.assert_allclose(dense.numpy(), want, **TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_densify_edges_matches_reference(weighted):
    """Batched edge list -> (B, N, N), rows destinations; a repeated edge
    adds up, as the reference's `.at[].add`."""
    rng = np.random.default_rng(11)
    n_graphs, npg, per = 5, 7, 12
    gid = np.repeat(np.arange(n_graphs), per).astype(np.int32)
    src = (gid * npg + rng.integers(0, npg, gid.size)).astype(np.int32)
    dst = (gid * npg + rng.integers(0, npg, gid.size)).astype(np.int32)
    src[1], dst[1] = src[0], dst[0]                 # a repeated edge
    w = rng.random(gid.size).astype(np.float32) if weighted else None
    want = np.asarray(jops.densify_edges(
        jnp.asarray(src), jnp.asarray(dst), n_graphs * npg, jnp.asarray(gid),
        n_graphs, npg, None if w is None else jnp.asarray(w)))
    got = ops.densify_edges(torch.from_numpy(src), torch.from_numpy(dst),
                            n_graphs * npg, torch.from_numpy(gid), n_graphs,
                            npg, None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    x = np.random.default_rng(12).normal(
        size=(n_graphs, npg, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ops.dense_spmm(got, torch.from_numpy(x)).numpy(),
        np.asarray(jops.dense_spmm(jnp.asarray(want), jnp.asarray(x))),
        **TOL)


def test_cpu_dispatch_takes_the_plain_version_without_counting():
    adj, x = (torch.from_numpy(a) for a in _graphs(2, 6, 3, 1))
    ops.LAUNCHES.reset()
    assert torch.equal(ops.dense_spmm(adj, x), ref.dense_spmm(adj, x))
    assert ops.LAUNCHES == {"dense_spmm": 0}


def test_dispatch_refuses_other_devices():
    adj = torch.zeros(2, 6, 6, device="meta")
    x = torch.zeros(2, 6, 3, device="meta")
    with pytest.raises(ValueError):
        ops.dense_spmm(adj, x)
    with pytest.raises(ValueError):
        ops.dense_spmm(adj, torch.zeros(2, 6, 3))
