"""PyTorch port, the GNN data layer: the triplets, the neighbour sampler
and the two batch builders give the reference's arrays, equal array for
array, for the same graphs and seeds (all four are numpy in both
packages)."""
import dataclasses

import numpy as np
import pytest

from repro.graph import generators as jgen
from repro.graph import sampler as JSM
from repro.graph import triplets as JT
from repro.models import gnn_steps as JS
from repro_torch.graph import NeighborSampler, generators as gen
from repro_torch.graph import sampler as SM
from repro_torch.graph import triplets as T
from repro_torch.launch.train import gnn_batch
from repro_torch.models import gnn_steps as S

pytest_plugins = ["torch_jax_executables"]


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("cap", [1, 4, 16])
def test_build_triplets_equal_the_reference(cap):
    b = S.batch_molecules(6, 12, 4, seed=3)
    args = (b["src"], b["dst"], len(b["node_feat"]), cap)
    for got, want in zip(T.build_triplets(*args), JT.build_triplets(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert T.triplet_budget(len(b["src"]), cap) == \
        JT.triplet_budget(len(b["src"]), cap)


def test_build_triplets_of_no_edges():
    empty = np.zeros(0, np.int32)
    for got, want in zip(T.build_triplets(empty, empty, 3),
                         JT.build_triplets(empty, empty, 3)):
        assert got.dtype == want.dtype and got.shape == want.shape == (0,)


@pytest.mark.parametrize("seed,batch_index", [(0, 0), (0, 3), (7, 1)])
def test_neighbor_sampler_equals_the_reference(seed, batch_index):
    g, jg = (m.barabasi_albert(300, 3, seed=1) for m in (gen, jgen))
    got = NeighborSampler(g, (5, 3), 32, seed=seed)
    want = JSM.NeighborSampler(jg, (5, 3), 32, seed=seed)
    assert (got.node_budget, got.edge_budgets) == \
        (want.node_budget, want.edge_budgets)
    a, b = got.sample(batch_index), want.sample(batch_index)
    assert isinstance(a, SM.SampledSubgraph)
    for f in ("node_ids", "node_mask", "seeds"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert len(a.blocks) == len(b.blocks) == 2
    for x, y in zip(a.blocks, b.blocks):
        assert isinstance(x, SM.SampledBlock)
        _equal(dataclasses.asdict(x), dataclasses.asdict(y))


@pytest.mark.parametrize("with_triplets", [False, True])
def test_batch_from_graph_equals_the_reference(with_triplets):
    g, jg = (m.random_geometric(64, seed=0) for m in (gen, jgen))
    _equal(S.batch_from_graph(g, 8, seed=5, with_triplets=with_triplets),
           JS.batch_from_graph(jg, 8, seed=5, with_triplets=with_triplets))


@pytest.mark.parametrize("with_triplets", [False, True])
def test_batch_molecules_equals_the_reference(with_triplets):
    _equal(S.batch_molecules(4, 10, 8, seed=2, with_triplets=with_triplets),
           JS.batch_molecules(4, 10, 8, seed=2, with_triplets=with_triplets))


def test_train_launcher_sizes():
    """The launcher's full-size batches (what `chip_smoke.py` trains on):
    MeshGraphNet's 4,096-node geometric graph has 100,118 directed edges;
    128 molecules of 12 atoms 1,536 atoms and 3,872 edges, with 11,392
    triplets at the cap of 16 for DimeNet."""
    b, n_graphs, d_feat = gnn_batch("meshgraphnet", smoke=False)
    assert (b["src"].shape, n_graphs, d_feat) == ((100_118,), 1, 16)
    b, n_graphs, _ = gnn_batch("dimenet", smoke=False)
    assert (len(b["node_feat"]), len(b["src"]), len(b["trip_kj"]),
            n_graphs) == (1_536, 3_872, 11_392, 128)
    assert "trip_kj" not in gnn_batch("mace", smoke=False)[0]
