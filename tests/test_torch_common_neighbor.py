"""PyTorch port, common_neighbor: the plain version against the reference.

On the same numpy inputs made from a seed, the port's `ops` (on CPU
tensors, the plain version) and `ref` are held bit-exact against the
reference's Pallas kernel in interpret mode and its jnp `ref`: -1 at any
position of a row, rows with no real entry, and the edge shapes of the
reference's own kernel test. `edge_common_neighbor` on small generator
graphs equals the reference's and the port's host Lemma-4 mask
(`_triangle_edge_mask`), also on tables with shuffled rows, padding
mid-row and negative padding other than -1, and refuses ids outside
[0, N) as it does on the card, and on a triangle-poor graph with hubs.
The CUDA kernels themselves run in tests/test_torch_cuda_kernels.py
(skipped without a card) and in chip_smoke.py.
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
from repro_torch.graph.csr import from_edge_list
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


@pytest.mark.parametrize("pad", [-1, -7, -2**31])
@pytest.mark.parametrize("graph", ["er", "ba", "caveman"])
def test_edge_common_neighbor_on_shuffled_tables(graph, pad):
    """The port's entry point against the reference's on a padded table
    whose rows are shuffled, with padding mid-row and any negative value
    as padding, edges in both directions in a shuffled order."""
    g = GRAPHS[graph]()
    rng = np.random.default_rng(abs(pad) % 89 + len(graph))
    padded = ops.pad_adjacency(g.indptr, g.indices,
                               int(g.degrees().max()) + 3)
    padded[padded < 0] = pad
    padded = np.stack([rng.permutation(r) for r in padded])
    e = g.edges()
    e = np.concatenate([e, e[:, ::-1]])[rng.permutation(2 * len(e))]
    e = np.ascontiguousarray(e)
    got = ops.edge_common_neighbor(torch.from_numpy(padded),
                                   torch.from_numpy(e)).numpy()
    want = np.asarray(jops.edge_common_neighbor(jnp.asarray(padded),
                                                jnp.asarray(e)))
    np.testing.assert_array_equal(got, want)
    tri = dict(zip(map(tuple, g.edges()), _triangle_edge_mask(g)))
    np.testing.assert_array_equal(
        got, [tri[(min(u, v), max(u, v))] for u, v in e])


@pytest.mark.parametrize("bad", [-1, 12, 2**31 - 1])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_edge_common_neighbor_refuses_ids_out_of_range(bad, dtype):
    """Ids outside [0, N) raise ValueError on the CPU, as on the card
    (tests/test_torch_cuda_kernels.py), where torch indexing would wrap a
    negative id; an empty edge list is no error."""
    table = torch.arange(12 * 4, dtype=torch.int32).reshape(12, 4)
    edges = torch.tensor([[0, 1], [2, bad]], dtype=dtype)
    with pytest.raises(ValueError, match=r"\[0, 12\)"):
        ops.edge_common_neighbor(table, edges)
    assert ops.edge_common_neighbor(
        table, torch.zeros(0, 2, dtype=dtype)).shape == (0,)
    with pytest.raises(ValueError):
        ops.edge_common_neighbor(table, edges[:, :1])


def _bipartite_hubs(n, m, seed):
    """Two halves of `n` vertices joined by `m` edges whose ends are drawn
    by a power-law weight, and m / 50 edges inside the first half, the
    only ones that can close a triangle."""
    rng = np.random.default_rng(seed)
    half = n // 2
    w = (np.arange(half) + 1.0) ** -0.6
    w /= w.sum()
    ends = np.stack([rng.choice(half, m, p=w),
                     half + rng.choice(half, m, p=w)], 1)
    within = rng.integers(0, half, (m // 50, 2))
    return from_edge_list(n, np.concatenate([ends, within]))


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_common_neighbor_on_triangle_poor_graph(seed):
    """A triangle-poor graph with hubs, whose rows run past the card's
    first staged tile and mostly meet no other row: the port's entry point
    against the reference's and the host mask."""
    g = _bipartite_hubs(400, 2000, seed)
    assert int(g.degrees().max()) > 64
    padded = ops.pad_adjacency(g.indptr, g.indices,
                               int(g.degrees().max()))
    e = g.edges()
    got = ops.edge_common_neighbor(torch.from_numpy(padded),
                                   torch.from_numpy(e)).numpy()
    want = np.asarray(jops.edge_common_neighbor(jnp.asarray(padded),
                                                jnp.asarray(e)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _triangle_edge_mask(g))
    assert 0 < got.mean() < 0.2
