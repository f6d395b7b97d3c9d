"""mace [gnn]: n_layers=2 d_hidden=128 l_max=2 correlation_order=3 n_rbf=8,
E(3)-equivariant higher-order message passing.  [arXiv:2206.07697; paper]"""
from repro_torch.configs.base import ArchSpec, register
from repro_torch.configs.gnn_shapes import gnn_shapes
from repro_torch.models.gnn import MACEConfig


def build() -> MACEConfig:
    return MACEConfig(n_layers=2, d_hidden=128, l_max=2, correlation=3, n_rbf=8)


def build_smoke() -> MACEConfig:
    return MACEConfig(n_layers=2, d_hidden=16, l_max=2, correlation=3, n_rbf=8)


ARCH = register(ArchSpec(
    name="mace", family="gnn", build=build, build_smoke=build_smoke,
    shapes=gnn_shapes, source="arXiv:2206.07697; paper"))
