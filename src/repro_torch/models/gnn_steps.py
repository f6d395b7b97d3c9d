"""Train/serve step factories for the GNN stack + synthetic batch builders:
the port of the reference's `repro.models.gnn_steps`.

The batch builders are numpy and give the reference's arrays for the same
seed; `to_device` moves a batch onto a torch device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.triplets import build_triplets
from repro_torch.models import gnn as G
from repro_torch.models.recsys import to_device  # noqa: F401  (batch dicts)
from repro_torch.optim import AdamWConfig, apply_gradients


FORWARD = {
    "meshgraphnet": (G.MeshGraphNetConfig, G.mgn_init, G.mgn_forward, "node"),
    "schnet": (G.SchNetConfig, G.schnet_init, G.schnet_forward, "energy"),
    "dimenet": (G.DimeNetConfig, G.dimenet_init, G.dimenet_forward, "energy"),
    "mace": (G.MACEConfig, G.mace_init, G.mace_forward, "energy"),
}


def gnn_loss(arch: str, cfg, params: torch.nn.Module,
             batch: Dict[str, torch.Tensor], n_graphs: int) -> torch.Tensor:
    """Energy archs: the mean square of the pooled energies' error over
    `n_graphs` graphs; MeshGraphNet: the masked mean square over nodes."""
    _, _, fwd, task = FORWARD[arch]
    out = fwd(cfg, params, batch)                    # (N,) node-level
    mask = batch["node_mask"].to(out.dtype)
    if task == "energy":
        pred = G.pool_energy(out * mask, batch["graph_id"], n_graphs)
        tgt = G.pool_energy(batch["targets"] * mask, batch["graph_id"],
                            n_graphs)
        return torch.mean(torch.square(pred - tgt))
    diff = torch.square(out - batch["targets"]) * mask
    return torch.sum(diff) / torch.clamp(torch.sum(mask), min=1.0)


def make_gnn_train_step(arch: str, cfg, n_graphs: int,
                        opt_cfg: AdamWConfig = AdamWConfig(weight_decay=0.0),
                        lr: float = 1e-3):
    """step(params, opt_state, batch) -> (params, opt_state, loss):
    `gnn_loss`, its backward, then one AdamW step that updates `params`
    in place."""
    def step(params: torch.nn.Module, opt_state, batch):
        loss = gnn_loss(arch, cfg, params, batch, n_graphs)
        opt_state = apply_gradients(params, loss, opt_state, lr, opt_cfg)
        return params, opt_state, loss.detach()
    return step


def make_gnn_infer_step(arch: str, cfg):
    _, _, fwd, _ = FORWARD[arch]

    @torch.no_grad()
    def step(params: torch.nn.Module, batch):
        return fwd(cfg, params, batch)
    return step


# ---------------------------------------------------------------------------
# Synthetic batch builders (smoke tests + examples)
# ---------------------------------------------------------------------------

def batch_from_graph(g: CSRGraph, d_feat: int, seed: int = 0,
                     with_triplets: bool = False, cap_per_edge: int = 16,
                     n_graphs: int = 1) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    ei = g.edge_index()
    src, dst = ei[0], ei[1]
    batch = dict(
        node_feat=rng.normal(size=(g.n, d_feat)).astype(np.float32),
        positions=rng.normal(size=(g.n, 3)).astype(np.float32),
        node_mask=np.ones(g.n, dtype=bool),
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        edge_mask=np.ones(len(src), dtype=bool),
        graph_id=np.zeros(g.n, dtype=np.int32),
        targets=rng.normal(size=(g.n,)).astype(np.float32),
    )
    if with_triplets:
        kj, ji, m = build_triplets(src, dst, g.n, cap_per_edge)
        batch["trip_kj"] = kj
        batch["trip_ji"] = ji
        batch["trip_mask"] = m
    return batch


def batch_molecules(n_graphs: int, nodes_per_graph: int, d_feat: int,
                    seed: int = 0, with_triplets: bool = False,
                    cap_per_edge: int = 16) -> Dict[str, np.ndarray]:
    """Batched random geometric molecules (cutoff graph over random coords)."""
    rng = np.random.default_rng(seed)
    n = n_graphs * nodes_per_graph
    pos = rng.normal(size=(n_graphs, nodes_per_graph, 3)).astype(np.float32) * 2.0
    srcs, dsts = [], []
    for b in range(n_graphs):
        d = np.linalg.norm(pos[b][:, None] - pos[b][None, :], axis=-1)
        a, bb = np.nonzero((d < 3.0) & (d > 0))
        srcs.append(a + b * nodes_per_graph)
        dsts.append(bb + b * nodes_per_graph)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    batch = dict(
        node_feat=rng.normal(size=(n, d_feat)).astype(np.float32),
        positions=pos.reshape(n, 3),
        node_mask=np.ones(n, dtype=bool),
        src=src, dst=dst,
        edge_mask=np.ones(len(src), dtype=bool),
        graph_id=np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per_graph),
        targets=rng.normal(size=(n,)).astype(np.float32),
    )
    if with_triplets:
        kj, ji, m = build_triplets(src, dst, n, cap_per_edge)
        batch["trip_kj"] = kj
        batch["trip_ji"] = ji
        batch["trip_mask"] = m
    return batch
