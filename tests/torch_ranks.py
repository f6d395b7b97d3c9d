"""Shared pieces of the port's sharding tests: a prelude that joins a
gloo group (for `test_torch_driver_ranks.run_ranks`), numpy trees carried
to the rank processes in one `.npz`, and a world of one in this process
(the `world_of_one` fixture)."""
import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.launch.mesh import make_host_mesh

GLOO = """
import json, os
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=os.environ["MCE_INIT"],
                        rank=int(os.environ["RANK"]),
                        world_size=int(os.environ["WORLD_SIZE"]))
RANK = dist.get_rank()


def report(**kw):
    print("RESULT", json.dumps(kw))


def load_tree(path, prefix):
    '''The nested dict of numpy arrays `save_trees` wrote under `prefix`.'''
    out = {}
    with np.load(path) as z:
        for key in z.files:
            if not key.startswith(prefix + "/"):
                continue
            *path_, leaf = key[len(prefix) + 1:].split("/")
            node = out
            for k in path_:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return out
"""


def save_trees(path, **trees):
    """Nested dicts of arrays (or arrays) into one `.npz`, keyed
    `<name>/<key>/<key>...`, for `load_tree` in the ranks."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}")
        else:
            flat[prefix] = np.asarray(node)
    for name, tree in trees.items():
        walk(tree, name)
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def world_of_one():
    """This process as a world of one (`make_host_mesh` joins it) and a
    (1, 1) ("data", "model") mesh on it, for one test module; the group is
    destroyed after it."""
    if dist.is_initialized():
        pytest.skip("a default process group is already initialised")
    host = make_host_mesh("cpu")
    assert tuple(host.mesh_dim_names) == ("data",) and host.size() == 1
    yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()
