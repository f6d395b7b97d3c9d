"""rmce [mce]: the paper's own architecture — the reduction-based maximal
clique enumeration engine as a first-class selectable arch (--arch rmce).

Shape cells mirror the paper's dataset regimes (Table 2) at production scale:
each cell fixes the padded bitset bucket tensor shapes that one device step
processes, as `repro_torch.core.driver.DistributedMCE` runs it on each rank.

  roots_chunk  — roots per shard per device step,
  u_pad        — padded universe size (≥ graph degeneracy λ, multiple of 32),
  x_pad        — padded forbidden-set row count.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchSpec, ShapeCell, register


@dataclasses.dataclass(frozen=True)
class MCEArchConfig:
    name: str = "rmce"
    backend: str = "pivot"            # 'pivot' | 'rcd' | 'revised'
    dynamic_red: bool = True
    global_red: bool = True
    x_red: bool = True
    bucket_sizes: tuple = (32, 64, 128, 256, 512, 1024)
    chunk: int = 1024


def build() -> MCEArchConfig:
    return MCEArchConfig()


def build_smoke() -> MCEArchConfig:
    return MCEArchConfig(name="rmce-smoke", bucket_sizes=(32, 64), chunk=8)


def mce_shapes(cfg) -> list:
    # (regime, roots per shard-step, U pad, X rows pad) — λ from paper Tab. 2:
    # social/web graphs λ≈51-131 → U=128/256; flickr-like λ=573 → U=1024.
    return [
        ShapeCell("web_sparse", "mce", dict(roots_chunk=1024, u_pad=64,
                                            x_pad=64)),
        ShapeCell("social_mid", "mce", dict(roots_chunk=512, u_pad=256,
                                            x_pad=256)),
        ShapeCell("dense_core", "mce", dict(roots_chunk=128, u_pad=1024,
                                            x_pad=1024)),
        ShapeCell("orkut_scale", "mce", dict(roots_chunk=256, u_pad=512,
                                             x_pad=2048)),
    ]


ARCH = register(ArchSpec(
    name="rmce", family="mce", build=build, build_smoke=build_smoke,
    shapes=mce_shapes, source="this paper (Deng, Zheng, Cheng; PVLDB'24)"))
