"""PyTorch port, `graph.order.kcore_peel_torch`: the round-based k-core
peel on a torch device against the reference's `kcore_peel_jax`.

The graphs are those of tests/test_graph.py::test_kcore_peel_jax_invariant
(Erdős–Rényi with 2-40 vertices, p in [0.05, 0.6]), drawn from seeds; the
same graph goes to both packages and the rank per vertex must be equal
(ties inside a round broken by vertex id). The BKdegen invariant
|N⁺(v)| ≤ λ is checked on the port's order too.
"""
import numpy as np
import pytest

from _hyp import given, strategies as st
from repro.graph import erdos_renyi as jer
from repro.graph import from_edge_list as jfrom_edges
from repro.graph import kcore_peel_jax
from repro_torch.graph import (degeneracy_order, erdos_renyi,
                               from_edge_list, kcore_peel_torch)

pytest_plugins = ["torch_jax_executables"]

CPU = "cpu"

# (n, p, seed) drawn once from the reference test's ranges, plus its
# edges: the smallest graph, a sparse one and a dense one
CASES = [(2, 0.05, 0), (2, 0.6, 1), (40, 0.05, 7), (40, 0.6, 3)] + [
    (int(n), float(p), int(s)) for n, p, s in zip(
        np.random.default_rng(0).integers(2, 41, 8),
        np.round(np.random.default_rng(1).uniform(0.05, 0.6, 8), 3),
        np.random.default_rng(2).integers(0, 10**6, 8))]


def _assert_same(n, p, seed):
    g = erdos_renyi(n, p, seed=seed)
    rank = kcore_peel_torch(g, device=CPU)
    assert rank.dtype == np.int64
    assert np.array_equal(rank, kcore_peel_jax(jer(n, p, seed=seed)))
    _, _, lam = degeneracy_order(g)
    for v in range(n):
        assert sum(1 for u in g.neighbors(v) if rank[u] > rank[v]) <= lam


@pytest.mark.parametrize("n,p,seed", CASES)
def test_kcore_peel_torch_matches_reference(n, p, seed):
    _assert_same(n, p, seed)


@given(st.integers(2, 40), st.floats(0.05, 0.6), st.integers(0, 10**6))
def test_kcore_peel_torch_matches_reference_drawn(n, p, seed):
    _assert_same(n, p, seed)


@pytest.mark.parametrize("n", [0, 5])
def test_kcore_peel_torch_edgeless(n):
    """No vertex (an empty rank) and no edge (one round, vertex order)."""
    none = np.zeros((0, 2), np.int64)
    got = kcore_peel_torch(from_edge_list(n, none), device=CPU)
    assert np.array_equal(got, np.arange(n))
    if n:
        assert np.array_equal(got, kcore_peel_jax(jfrom_edges(n, none)))
