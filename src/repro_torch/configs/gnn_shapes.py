"""The four assigned GNN shape cells (shared by all gnn archs).

Counts are padded to multiples of 2048 (fixed-shape pipeline with masks);
`raw_*` keeps the assigned numbers. minibatch_lg carries the real sampler's
padded budgets (batch 1024, fanout 15-10 over a 233k-node graph).
"""
from __future__ import annotations

from repro_torch.configs.base import ShapeCell


def _pad(x: int, m: int = 2048) -> int:
    return -(-x // m) * m


def gnn_shapes(cfg) -> list:
    needs_triplets = cfg.name == "dimenet"
    cap = 16

    def cell(name, kind, n, e, d_feat, n_graphs=1, note=None, **extra):
        meta = dict(
            n_nodes=_pad(n), n_edges=_pad(e), d_feat=d_feat,
            raw_nodes=n, raw_edges=e, n_graphs=n_graphs,
            n_triplets=_pad(e * cap) if needs_triplets else 0, **extra)
        return ShapeCell(name, kind, meta, skip_reason=note)

    return [
        # Cora-scale full batch [n=2708 e=10556 d=1433]
        cell("full_graph_sm", "train", 2708, 10556, 1433),
        # Reddit-scale sampled training: budgets of the fanout-15-10 sampler
        cell("minibatch_lg", "train",
             1024 * (1 + 15 + 150), 1024 * 15 + 1024 * 150, 602,
             batch_nodes=1024, fanout=(15, 10),
             full_graph=dict(n_nodes=232965, n_edges=114615892)),
        # ogbn-products full batch [n=2449029 e=61859140 d=100]
        cell("ogb_products", "train", 2449029, 61859140, 100),
        # batched small molecules [30 nodes, 64 edges, batch 128]
        cell("molecule", "train", 30 * 128, 64 * 2 * 128, 32, n_graphs=128),
    ]
