"""dimenet [gnn]: n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7
n_radial=6.  [arXiv:2003.03123; unverified]"""
from repro_torch.configs.base import ArchSpec, register
from repro_torch.configs.gnn_shapes import gnn_shapes
from repro_torch.models.gnn import DimeNetConfig


def build() -> DimeNetConfig:
    return DimeNetConfig(n_blocks=6, d_hidden=128, n_bilinear=8,
                         n_spherical=7, n_radial=6)


def build_smoke() -> DimeNetConfig:
    return DimeNetConfig(n_blocks=2, d_hidden=32, n_bilinear=4,
                         n_spherical=4, n_radial=4)


ARCH = register(ArchSpec(
    name="dimenet", family="gnn", build=build, build_smoke=build_smoke,
    shapes=gnn_shapes, source="arXiv:2003.03123; unverified"))
