"""PyTorch port, MODEL_FLOPS (`launch/flops.py` and the LMs' 6·N·D /
2·N·D in `launch/cells.py`): every runnable (arch, cell) of `all_cells`
gives the reference's `CellProgram.model_flops`, exactly."""
import jax
import pytest

from repro.launch import cells as jcells
from repro.launch import flops as jflops
from repro_torch.launch import cells, flops
from torch_ranks import world_of_one  # noqa: F401

pytest_plugins = ["torch_jax_executables"]

CELLS = [(a, c) for a, c, skip in cells.all_cells() if not skip]


@pytest.fixture(scope="module")
def ref_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("arch,cell", CELLS,
                         ids=[f"{a}-{c}" for a, c in CELLS])
def test_model_flops_match_reference(world_of_one, ref_mesh, arch, cell):
    got = cells.build_cell(arch, cell, world_of_one).model_flops
    want = jcells.build_cell(arch, cell, ref_mesh).model_flops
    assert got == want and got > 0


def test_flops_constants():
    assert flops.TRAIN_MULT == jflops.TRAIN_MULT
    with pytest.raises(KeyError):
        flops.gnn_model_flops("unknown", None, dict(raw_nodes=1,
                                                    raw_edges=1, d_feat=1))
