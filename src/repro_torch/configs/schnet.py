"""schnet [gnn]: n_interactions=3 d_hidden=64 rbf=300 cutoff=10.
[arXiv:1706.08566; paper]"""
from repro_torch.configs.base import ArchSpec, register
from repro_torch.configs.gnn_shapes import gnn_shapes
from repro_torch.models.gnn import SchNetConfig


def build() -> SchNetConfig:
    return SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)


def build_smoke() -> SchNetConfig:
    return SchNetConfig(n_interactions=2, d_hidden=32, n_rbf=16, cutoff=5.0)


ARCH = register(ArchSpec(
    name="schnet", family="gnn", build=build, build_smoke=build_smoke,
    shapes=gnn_shapes, source="arXiv:1706.08566; paper"))
