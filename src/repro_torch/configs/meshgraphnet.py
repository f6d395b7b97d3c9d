"""meshgraphnet [gnn]: n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2.
[arXiv:2010.03409; unverified]"""
from repro_torch.configs.base import ArchSpec, register
from repro_torch.configs.gnn_shapes import gnn_shapes
from repro_torch.models.gnn import MeshGraphNetConfig


def build() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(n_layers=15, d_hidden=128, mlp_layers=2)


def build_smoke() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(n_layers=3, d_hidden=32, mlp_layers=2)


ARCH = register(ArchSpec(
    name="meshgraphnet", family="gnn", build=build, build_smoke=build_smoke,
    shapes=gnn_shapes, source="arXiv:2010.03409; unverified"))
