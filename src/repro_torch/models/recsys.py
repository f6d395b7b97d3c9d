"""Two-tower retrieval model (YouTube DNN / RecSys'19 lineage): the serving
half of the reference's `repro.models.recsys`.

Architecture (assigned config): embed_dim=256, tower MLP 1024-512-256,
dot-product interaction.

The hot path is the sparse embedding lookup over huge tables. The bag
features (the user's item history, an item's tags) go through the port's
EmbeddingBag entry point, `kernels.embedding_bag.ops.embedding_bag`: the
hand-written `embedding_bag_sum` kernel on the card, its plain version on
the CPU. The reference computes the same bags in plain jnp.

Feature schema (fixed, production-plausible):
  user tower:  user_id (1-hot, huge table), user_geo (1-hot),
               user_hist (bag of item ids, shares the item_id table),
               user_dense (16 floats)
  item tower:  item_id (1-hot, huge table), item_cat (1-hot),
               item_tags (bag, small table)

``retrieval_cand`` scores one query against n_candidates=1e6 candidate
items via one batched item tower, a matrix-vector product and a top-k.
Training (`retrieval_loss`, the train step) comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models.layers import dense_init, ordered_top_k


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256                     # final tower output dim
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    interaction: str = "dot"
    # sparse feature tables: rows × dim
    n_users: int = 1 << 25                   # 33.5M user ids
    n_items: int = 1 << 24                   # 16.7M item ids
    n_geo: int = 100_000
    n_tags: int = 100_000
    d_id: int = 128                          # id-table embedding dim
    d_small: int = 32                        # small-table embedding dim
    d_dense: int = 16                        # dense float features
    hist_len: int = 32                       # user history bag length
    tags_len: int = 8                        # item tag bag length
    temperature: float = 0.05
    dtype: str = "float32"

    def param_count(self) -> int:
        emb = (self.n_users * self.d_id + self.n_items * self.d_id
               + self.n_geo * self.d_small + self.n_tags * self.d_small)
        mlp = 0
        for d_in in (self.user_in, self.item_in):
            dims = (d_in,) + self.tower_mlp
            mlp += sum(dims[i] * dims[i + 1] + dims[i + 1]
                       for i in range(len(dims) - 1))
        return emb + mlp

    @property
    def user_in(self) -> int:
        return self.d_id + self.d_id + self.d_small + self.d_dense

    @property
    def item_in(self) -> int:
        return self.d_id + self.d_small


# ---------------------------------------------------------------------------
# EmbeddingBag (the substrate op) and lookups
# ---------------------------------------------------------------------------

def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mode: str = "mean") -> torch.Tensor:
    """table: (V, D); ids: (B, L) int, -1 = padding. Returns (B, D)
    float32: the bag's row sum ('sum') or the sum over max(bag size, 1)
    ('mean'), through the EmbeddingBag kernel's entry point."""
    return bag_ops.embedding_bag(table, ids, mode)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-valued categorical lookup: (B,) -> (B, D)."""
    return table[ids.long()]


# ---------------------------------------------------------------------------
# Params / towers
# ---------------------------------------------------------------------------

def _weight(t: torch.Tensor) -> nn.Parameter:
    # serving weights; the training slice turns gradients on
    return nn.Parameter(t, requires_grad=False)


class MLP(nn.Module):
    """w[i] (dims[i], dims[i+1]) and b[i] (dims[i+1],): the reference's
    w{i} / b{i} leaves."""

    def __init__(self, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor]):
        super().__init__()
        self.w = nn.ParameterList(_weight(t) for t in ws)
        self.b = nn.ParameterList(_weight(t) for t in bs)


class TwoTower(nn.Module):
    """The four tables and the two towers' MLPs, float32 as the
    reference stores them (cast to cfg.dtype at use)."""

    def __init__(self, cfg: TwoTowerConfig, user_id_table: torch.Tensor,
                 item_id_table: torch.Tensor, geo_table: torch.Tensor,
                 tag_table: torch.Tensor, user_mlp: MLP, item_mlp: MLP):
        super().__init__()
        self.cfg = cfg
        self.user_id_table = _weight(user_id_table)
        self.item_id_table = _weight(item_id_table)
        self.geo_table = _weight(geo_table)
        self.tag_table = _weight(tag_table)
        self.user_mlp = user_mlp
        self.item_mlp = item_mlp


def _mlp_params(generator: torch.Generator, dims) -> MLP:
    n = len(dims) - 1
    return MLP([dense_init(generator, (dims[i], dims[i + 1]))
                for i in range(n)],
               [torch.zeros(dims[i + 1], device=generator.device)
                for i in range(n)])


def _mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    n = len(p.w)
    for i, (w, b) in enumerate(zip(p.w, p.b)):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i < n - 1:
            x = F.relu(x)
    return x


def init_params(cfg: TwoTowerConfig, generator: torch.Generator) -> TwoTower:
    """Random weights on the generator's device, the reference's scales."""
    def table(rows, dim):
        return dense_init(generator, (rows, dim), scale=0.02)
    return TwoTower(
        cfg,
        user_id_table=table(cfg.n_users, cfg.d_id),
        item_id_table=table(cfg.n_items, cfg.d_id),
        geo_table=table(cfg.n_geo, cfg.d_small),
        tag_table=table(cfg.n_tags, cfg.d_small),
        user_mlp=_mlp_params(generator, (cfg.user_in,) + cfg.tower_mlp),
        item_mlp=_mlp_params(generator, (cfg.item_in,) + cfg.tower_mlp))


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-6)


def user_tower(cfg: TwoTowerConfig, params: TwoTower,
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch: user_id (B,), user_geo (B,), user_hist (B, L), user_dense (B, Dd)."""
    dt = getattr(torch, cfg.dtype)
    uid = embedding_lookup(params.user_id_table, batch["user_id"]).to(dt)
    geo = embedding_lookup(params.geo_table, batch["user_geo"]).to(dt)
    hist = embedding_bag(params.item_id_table, batch["user_hist"]).to(dt)
    x = torch.cat([uid, hist, geo, batch["user_dense"].to(dt)], dim=-1)
    return _unit(_mlp(params.user_mlp, x))


def item_tower(cfg: TwoTowerConfig, params: TwoTower,
               batch: Dict[str, torch.Tensor], prefix: str = "item"
               ) -> torch.Tensor:
    """batch: {prefix}_id (B,), {prefix}_tags (B, Lt)."""
    dt = getattr(torch, cfg.dtype)
    iid = embedding_lookup(params.item_id_table, batch[f"{prefix}_id"]).to(dt)
    tags = embedding_bag(params.tag_table, batch[f"{prefix}_tags"]).to(dt)
    x = torch.cat([iid, tags], dim=-1)
    return _unit(_mlp(params.item_mlp, x))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def make_serve_step(cfg: TwoTowerConfig):
    """Online scoring: user tower + dot against per-request candidate embs."""

    @torch.no_grad()
    def serve_step(params: TwoTower, batch: Dict[str, torch.Tensor]):
        u = user_tower(cfg, params, batch)                   # (B, D)
        cand = batch["cand_emb"]                             # (B, C, D)
        return torch.einsum("bd,bcd->bc", u, cand.to(u.dtype))
    return serve_step


def make_bulk_score_step(cfg: TwoTowerConfig):
    """Offline scoring: full forward of both towers + elementwise dot."""

    @torch.no_grad()
    def bulk_step(params: TwoTower, batch: Dict[str, torch.Tensor]):
        u = user_tower(cfg, params, batch)
        v = item_tower(cfg, params, batch)
        return (u * v).sum(dim=-1)
    return bulk_step


def make_retrieval_step(cfg: TwoTowerConfig, top_k: int = 100):
    """One query vs n_candidates≈1e6: item tower over the candidate corpus
    shard + batched dot + global top-k (ties to the lower candidate index,
    as the reference's `jax.lax.top_k`). No loop over candidates."""

    @torch.no_grad()
    def retrieval_step(params: TwoTower, batch: Dict[str, torch.Tensor]):
        u = user_tower(cfg, params, batch)                   # (1, D)
        v = item_tower(cfg, params, batch, prefix="cand")    # (C, D)
        scores = (v @ u[0]).float()                          # (C,)
        return ordered_top_k(scores, top_k)
    return retrieval_step


# ---------------------------------------------------------------------------
# Synthetic batches
# ---------------------------------------------------------------------------

def synth_batch(cfg: TwoTowerConfig, batch: int, seed: int = 0,
                with_items: bool = True) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = dict(
        user_id=rng.integers(0, cfg.n_users, batch).astype(np.int32),
        user_geo=rng.integers(0, cfg.n_geo, batch).astype(np.int32),
        user_hist=np.where(
            rng.random((batch, cfg.hist_len)) < 0.8,
            rng.integers(0, cfg.n_items, (batch, cfg.hist_len)), -1
        ).astype(np.int32),
        user_dense=rng.normal(size=(batch, cfg.d_dense)).astype(np.float32),
    )
    if with_items:
        out["item_id"] = rng.integers(0, cfg.n_items, batch).astype(np.int32)
        out["item_tags"] = np.where(
            rng.random((batch, cfg.tags_len)) < 0.7,
            rng.integers(0, cfg.n_tags, (batch, cfg.tags_len)), -1
        ).astype(np.int32)
    return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}

