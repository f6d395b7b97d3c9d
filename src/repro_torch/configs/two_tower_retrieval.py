"""two-tower-retrieval [recsys]: embed_dim=256 tower_mlp=1024-512-256
interaction=dot — sampled-softmax retrieval.  [RecSys'19 (YouTube); unverified]
"""
from repro_torch.configs.base import ArchSpec, ShapeCell, register
from repro_torch.models.recsys import TwoTowerConfig


def build() -> TwoTowerConfig:
    return TwoTowerConfig()


def build_smoke() -> TwoTowerConfig:
    return TwoTowerConfig(
        name="two-tower-smoke", embed_dim=32, tower_mlp=(64, 32),
        n_users=1024, n_items=2048, n_geo=64, n_tags=64,
        d_id=16, d_small=8, d_dense=4, hist_len=8, tags_len=4)


def recsys_shapes(cfg) -> list:
    return [
        ShapeCell("train_batch", "train", dict(batch=65536)),
        ShapeCell("serve_p99", "serve", dict(batch=512)),
        ShapeCell("serve_bulk", "bulk", dict(batch=262144)),
        ShapeCell("retrieval_cand", "retrieval",
                  dict(batch=1, n_candidates=1_000_000)),
    ]


ARCH = register(ArchSpec(
    name="two-tower-retrieval", family="recsys", build=build,
    build_smoke=build_smoke, shapes=recsys_shapes,
    source="RecSys'19 (YouTube); unverified"))
