"""Multi-hop uniform neighbor sampler (GraphSAGE-style) with fixed shapes:
the port's copy of the reference's `repro.graph.sampler` (numpy only).

Produces padded, fixed-shape sampled subgraphs for fixed-shape training
steps: the `minibatch_lg` shape (batch_nodes=1024, fanout 15-10) requires a
real sampler over the full CSR graph. Sampling is a host-side data-pipeline
stage (numpy), as in production systems (DGL/PyG samplers run on CPU workers).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class SampledBlock:
    """One bipartite message-passing block (layer) of a sampled subgraph.

    edge src/dst are indices into the *global* node id table `node_ids` of the
    parent SampledSubgraph. Padded edges have src == dst == pad_node and
    mask == False.
    """

    src: np.ndarray          # (E_pad,) int32 — local node index of message source
    dst: np.ndarray          # (E_pad,) int32 — local node index of message target
    mask: np.ndarray         # (E_pad,) bool  — valid-edge mask


@dataclasses.dataclass
class SampledSubgraph:
    node_ids: np.ndarray     # (N_pad,) int32 global ids (padded with 0)
    node_mask: np.ndarray    # (N_pad,) bool
    blocks: List[SampledBlock]
    seeds: np.ndarray        # (batch,) int32 — local indices of seed nodes


class NeighborSampler:
    """Uniform fanout sampler. Deterministic given (seed, batch_index)."""

    def __init__(self, g: CSRGraph, fanouts: Tuple[int, ...], batch_nodes: int, seed: int = 0):
        self.g = g
        self.fanouts = tuple(fanouts)
        self.batch_nodes = batch_nodes
        self.seed = seed
        # fixed output shapes (padded): layer l has at most batch * prod(fanout[:l+1]) edges
        self.node_budget = batch_nodes
        self.edge_budgets = []
        cur = batch_nodes
        for f in self.fanouts:
            self.edge_budgets.append(cur * f)
            cur = cur * f
            self.node_budget += cur

    def sample(self, batch_index: int) -> SampledSubgraph:
        rng = np.random.default_rng((self.seed, batch_index))
        n = self.g.n
        seeds = rng.choice(n, size=self.batch_nodes, replace=n < self.batch_nodes)
        frontier = seeds.astype(np.int64)
        all_nodes = [frontier]
        raw_blocks = []  # (src_global, dst_global) per hop
        for f in self.fanouts:
            deg = self.g.degrees()[frontier]
            # uniform with replacement; deg-0 nodes get self edges (masked out)
            offs = rng.integers(0, np.maximum(deg, 1)[:, None],
                                size=(len(frontier), f))
            src = self.g.indices[
                np.minimum(self.g.indptr[frontier][:, None] + offs, len(self.g.indices) - 1)
            ].astype(np.int64)
            valid = (deg > 0)[:, None] & (offs < deg[:, None])
            dst = np.broadcast_to(frontier[:, None], src.shape)
            raw_blocks.append((src.ravel(), dst.ravel(), valid.ravel()))
            frontier = np.unique(src[valid])
            all_nodes.append(frontier)
        # build global->local map over the union of sampled nodes
        uniq = np.unique(np.concatenate(all_nodes))
        n_pad = self.node_budget
        if len(uniq) > n_pad:  # cannot happen (budget is the worst case) but guard
            uniq = uniq[:n_pad]
        local = {int(v): i for i, v in enumerate(uniq.tolist())}
        node_ids = np.zeros(n_pad, dtype=np.int32)
        node_ids[: len(uniq)] = uniq
        node_mask = np.zeros(n_pad, dtype=bool)
        node_mask[: len(uniq)] = True
        blocks = []
        for (src, dst, valid), budget in zip(raw_blocks, self.edge_budgets):
            ls = np.array([local.get(int(s), 0) for s in src.tolist()], dtype=np.int32)
            ld = np.array([local.get(int(d), 0) for d in dst.tolist()], dtype=np.int32)
            pad = budget - len(ls)
            assert pad >= 0
            blocks.append(
                SampledBlock(
                    src=np.concatenate([ls, np.zeros(pad, np.int32)]),
                    dst=np.concatenate([ld, np.zeros(pad, np.int32)]),
                    mask=np.concatenate([valid, np.zeros(pad, bool)]),
                )
            )
        seed_local = np.array([local[int(s)] for s in seeds.tolist()], dtype=np.int32)
        return SampledSubgraph(node_ids=node_ids, node_mask=node_mask, blocks=blocks, seeds=seed_local)
