"""PyTorch port, the dry-run cells (`launch/cells.py`) and the two batch
specs (`models.gnn.batch_spec`, `models.recsys.batch_spec`) against the
reference.

For every runnable (arch, cell) of `all_cells`, `input_specs` gives the
reference's names, shapes and types (the reference's built on a (1, 1)
("data", "model") jax mesh, the port's on a (1, 1) `DeviceMesh` of a
world of one): the LM layers' stacked (n_layers, ...) leaves as the
port's per-layer tensors, the bitset words' uint32 as the port's int32.
Every argument is a DTensor on the meta device (a decode cache's position
is the int `decode_step` takes, the reference's () int32): no cell
allocates.
Skipped cells raise ValueError in both packages.
"""
import jax
import pytest
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro.launch import cells as jcells
from repro_torch.interop import gnn_named, two_tower_named
from repro_torch.launch import cells
from torch_ranks import world_of_one  # noqa: F401

pytest_plugins = ["torch_jax_executables"]

CELLS = list(cells.all_cells())
# the reference's types as the port holds them
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "bool": torch.bool, "uint32": torch.int32}


@pytest.fixture(scope="module")
def ref_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _params_named(family, tree):
    if family == "gnn":
        return gnn_named(tree)
    if family == "recsys":
        return two_tower_named(tree)
    out = {k: v for k, v in tree.items() if k != "layers"}
    for leaf, v in tree["layers"].items():
        for i in range(v.shape[0]):
            out[f"layers.{i}.{leaf}"] = jax.ShapeDtypeStruct(v.shape[1:],
                                                             v.dtype)
    return out


def ref_flat(family, args):
    """{name: (shape, torch dtype)} of the reference's arguments, named as
    `port_flat` names the port's."""
    out = {}
    for i, a in enumerate(args):
        if isinstance(a, dict) and family != "mce" and i == 0:
            items = _params_named(family, a).items()
        elif isinstance(a, dict) and set(a) == {"mu", "nu", "step"}:
            items = [(f"{m}.{k}", v) for m in ("mu", "nu")
                     for k, v in _params_named(family, a[m]).items()]
            items.append(("step", a["step"]))
        elif isinstance(a, dict):
            items = a.items()
        else:
            items = [("", a)]
        for k, v in items:
            out[f"{i}.{k}".rstrip(".")] = (tuple(v.shape),
                                           DTYPES[str(v.dtype)])
    return out


def port_flat(args):
    """{name: tensor} of the port's arguments: a module's parameters by
    name, a dict's entries (nested one level) by key."""
    out = {}
    for i, a in enumerate(args):
        if isinstance(a, nn.Module):
            out.update({f"{i}.{k}": p for k, p in a.named_parameters()})
        elif isinstance(a, dict):
            for k, v in a.items():
                if isinstance(v, dict):
                    out.update({f"{i}.{k}.{n}": t for n, t in v.items()})
                else:
                    out[f"{i}.{k}"] = v
        else:
            out[f"{i}"] = a
    return out


@pytest.mark.parametrize("arch,cell,skip", CELLS,
                         ids=[f"{a}-{c}" for a, c, _ in CELLS])
def test_input_specs_match_reference(world_of_one, ref_mesh, arch, cell,
                                     skip):
    if skip:
        with pytest.raises(ValueError, match="skipped"):
            cells.build_cell(arch, cell, world_of_one)
        with pytest.raises(ValueError, match="skipped"):
            jcells.build_cell(arch, cell, ref_mesh)
        return
    from repro_torch.configs import get_arch
    family = get_arch(arch).family
    got = port_flat(cells.input_specs(arch, cell, world_of_one))
    want = ref_flat(family, jcells.input_specs(arch, cell, ref_mesh))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        if isinstance(t, int):
            # a decode cache's position, the int `decode_step` takes
            assert name == "1.pos" and want[name] == ((), torch.int32)
            continue
        assert (tuple(t.shape), t.dtype) == want[name], name
        assert isinstance(t, DTensor) and t.to_local().is_meta, name


def test_batch_specs_on_meta():
    from repro.models import gnn as JG
    from repro.models import recsys as JR
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R
    shapes = dict(n_nodes=4096, n_edges=100_352, d_feat=32,
                  n_triplets=1_605_632, n_graphs=128)
    for n_trip in (0, shapes["n_triplets"]):
        kw = dict(shapes, n_triplets=n_trip)
        got = G.batch_spec(G.GraphShapes(**kw))
        want = JG.batch_spec(JG.GraphShapes(**kw))
        assert {k: (tuple(v.shape), v.dtype, v.device.type)
                for k, v in got.items()} == \
            {k: (tuple(v.shape), DTYPES[str(v.dtype)], "meta")
             for k, v in want.items()}
    cfg = get_arch("two-tower-retrieval").build()
    for kind in ("train", "bulk", "serve", "retrieval"):
        got = R.batch_spec(cfg, kind, 512, n_candidates=1_000_000)
        want = JR.batch_spec(cfg, kind, 512, n_candidates=1_000_000)
        assert {k: (tuple(v.shape), v.dtype, v.device.type)
                for k, v in got.items()} == \
            {k: (tuple(v.shape), DTYPES[str(v.dtype)], "meta")
             for k, v in want.items()}
    with pytest.raises(ValueError):
        R.batch_spec(cfg, "unknown", 8)


def test_mce_cell_fn_matches_reference(world_of_one, ref_mesh):
    """The `rmce` `web_sparse` cell's function, run (not only built) in both
    packages on the same arrays: the U = 64 bucket of G(150, 0.3) (29
    roots, 16 X rows) padded to the cell's 1,024 roots with the driver's
    no-op roots, the port's on a (1, 1) mesh of DTensors on the CPU, the
    reference's on its (1, 1) jax mesh: every counter is equal (the card
    phase holds the cell to `run_bucket` too). One torch thread: the
    lock-step walk is thousands of small ops, whose parallel regions spin
    20x slower on a CPU that other test workers share."""
    import numpy as np
    from repro_torch.core.driver import _shard_batch
    from repro_torch.core.engine.loop import bucket_tensors
    from repro_torch.core.engine.prepare import prepare
    from repro_torch.graph.generators import erdos_renyi
    from repro_torch.sharding.spec import P, distribute
    prog = cells.build_cell("rmce", "web_sparse", world_of_one)
    r = prog.args[0].shape[1]
    bucket = next(b for b in prepare(erdos_renyi(150, 0.3, seed=0),
                                     device="cpu").buckets if b.u_pad == 64)
    arrays = _shard_batch(bucket, np.arange(len(bucket.rsz0)), r)
    args = bucket_tensors(*arrays, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = prog.fn(*(distribute(t[None], world_of_one, P(("data",)))
                        for t in args))
        got = {k: int(v) for k, v in got.items()}
    finally:
        torch.set_num_threads(threads)
    want = jcells.build_cell("rmce", "web_sparse", ref_mesh).fn(
        *(np.asarray(a)[None] for a in arrays))
    assert got == {k: int(v) for k, v in want.items()}
    assert got["cliques"] > 0 and got["truncated"] == 0
