"""PyTorch port, common_neighbor: the plain version against the reference.

On the same numpy inputs made from a seed, the port's `ops` (on CPU
tensors, the plain version) and `ref` are held bit-exact against the
reference's Pallas kernel in interpret mode and its jnp `ref`: -1 at any
position of a row, rows with no real entry, and the edge shapes of the
reference's own kernel test. `edge_common_neighbor` on small generator
graphs equals the reference's and the port's host Lemma-4 mask
(`_triangle_edge_mask`). The CUDA kernel itself runs in
tests/test_torch_cuda_kernels.py (skipped without a card) and in
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common_neighbor import kernel as jkernel
from repro.kernels.common_neighbor import ops as jops
from repro.kernels.common_neighbor import ref as jref
from repro_torch.core.global_reduction import _triangle_edge_mask
from repro_torch.graph import generators as gen
from repro_torch.kernels.common_neighbor import ops, ref

pytest_plugins = ["torch_jax_executables"]

# the reference's kernel test shapes (tests/test_kernels.py), then D wider
# than a warp and E past one kernel block
SHAPES = [(1, 4), (10, 8), (130, 16), (257, 5), (33, 70), (300, 3)]


def _rows(e, d, seed):
    rng = np.random.default_rng(seed)
    au = rng.integers(-1, 40, (e, d)).astype(np.int32)
    av = rng.integers(-1, 40, (e, d)).astype(np.int32)
    au[0] = -1                                   # no real entry
    return au, av


@pytest.mark.parametrize("e,d", SHAPES)
def test_has_common_neighbor_matches_reference(e, d):
    au, av = _rows(e, d, e * 31 + d)
    want = np.asarray(jref.has_common_neighbor(jnp.asarray(au),
                                               jnp.asarray(av)))
    pallas = np.asarray(jkernel.has_common_neighbor(
        jnp.asarray(au), jnp.asarray(av), interpret=True))
    np.testing.assert_array_equal(pallas, want)
    for fn in (ops.has_common_neighbor, ref.has_common_neighbor):
        got = fn(torch.from_numpy(au), torch.from_numpy(av))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
    assert not want[0]


def test_plain_version_slices_wide_rows(monkeypatch):
    """The all-pairs formula runs in slices of edges; the slicing does not
    change the answer."""
    au, av = _rows(50, 12, 7)
    whole = ref.has_common_neighbor(torch.from_numpy(au), torch.from_numpy(av))
    monkeypatch.setattr(ref, "PAIRS_PER_SLICE", 3 * 12 * 12)
    sliced = ref.has_common_neighbor(torch.from_numpy(au),
                                     torch.from_numpy(av))
    assert torch.equal(whole, sliced)
    assert ref.has_common_neighbor(torch.zeros(0, 5, dtype=torch.int32),
                                   torch.zeros(0, 5, dtype=torch.int32)
                                   ).shape == (0,)


GRAPHS = {
    "er": lambda: gen.erdos_renyi(120, 0.08, seed=2),
    "ba": lambda: gen.barabasi_albert(150, 3, seed=3),
    "caveman": lambda: gen.caveman(10, 6, 0.15, seed=4),
    "road": lambda: gen.grid_road(10, 0.1, seed=5),     # no triangle
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_edge_common_neighbor_is_the_triangle_mask(graph):
    g = GRAPHS[graph]()
    max_deg = int(g.degrees().max())
    padded = ops.pad_adjacency(g.indptr, g.indices, max_deg)
    np.testing.assert_array_equal(
        padded, jops.pad_adjacency(g.indptr, g.indices, max_deg))
    edges = g.edges()
    got = ops.edge_common_neighbor(torch.from_numpy(padded),
                                   torch.from_numpy(edges)).numpy()
    want = np.asarray(jops.edge_common_neighbor(jnp.asarray(padded),
                                                jnp.asarray(edges)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _triangle_edge_mask(g))
    assert got.any() == (graph != "road")


def test_cpu_dispatch_takes_the_plain_version_without_counting():
    au, av = (torch.from_numpy(x) for x in _rows(20, 6, 1))
    ops.LAUNCHES.reset()
    assert torch.equal(ops.has_common_neighbor(au, av),
                       ref.has_common_neighbor(au, av))
    assert ops.LAUNCHES == {"has_common_neighbor": 0}


def test_dispatch_refuses_other_devices():
    rows = torch.zeros(3, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.has_common_neighbor(rows, rows)
    with pytest.raises(ValueError):
        ops.has_common_neighbor(rows, torch.zeros(3, 4, dtype=torch.int32))
