"""Two-tower retrieval model (YouTube DNN / RecSys'19 lineage): the port
of the reference's `repro.models.recsys`, serving and training.

Architecture (assigned config): embed_dim=256, tower MLP 1024-512-256,
dot-product interaction.

The hot path is the sparse embedding lookup over huge tables. The bag
features (the user's item history, an item's tags) go through the port's
EmbeddingBag entry point, `kernels.embedding_bag.ops.embedding_bag`: the
hand-written `embedding_bag_sum` kernel on the card (its backward kernel
gives the tables their gradient), the plain versions on the CPU. The
reference computes the same bags in plain jnp.

Feature schema (fixed, production-plausible):
  user tower:  user_id (1-hot, huge table), user_geo (1-hot),
               user_hist (bag of item ids, shares the item_id table),
               user_dense (16 floats)
  item tower:  item_id (1-hot, huge table), item_cat (1-hot),
               item_tags (bag, small table)

``retrieval_cand`` scores one query against n_candidates=1e6 candidate
items via one batched item tower, a matrix-vector product and a top-k.
Training: sampled softmax with in-batch negatives (`retrieval_loss`),
AdamW without weight decay (`make_train_step`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models.layers import (dense_init, ordered_top_k,
                                       replicated_as, row_diagonal)
from repro_torch.optim import AdamWConfig, apply_gradients


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
    ('mean'), through the EmbeddingBag kernel's entry point. A DTensor
    table takes `row_sharded_bag`."""
    if isinstance(table, DTensor):
        return row_sharded_bag(table, ids, mode)
    return bag_ops.embedding_bag(table, ids, mode)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-valued categorical lookup: (B,) -> (B, D). A DTensor table
    takes `row_sharded_bag` over bags of one id."""
    if isinstance(table, DTensor):
        return row_sharded_bag(table, ids[:, None], "sum")
    return table[ids.long()]


class _SumOverRanks(torch.autograd.Function):
    """The sum over the ranks of `group` of each rank's partial rows; the
    gradient passes through as it is, since every rank of the group holds
    the same downstream gradient (Megatron's reduce out of the
    model-parallel region)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def row_sharded_bag(table: DTensor, ids: torch.Tensor,
                    mode: str = "mean") -> DTensor:
    """`embedding_bag` of a table whose rows are split over one mesh axis
    (replicated over the others), as Megatron's vocab-parallel embedding:
    each rank bags the ids that fall in its rows (the others masked as
    padding) with the kernel's entry point on its local rows, the partial
    bags are summed over the table axis, and 'mean' divides by the whole
    bag's size. ids: (B, L), a DTensor or a plain tensor that every rank
    holds alike; the result (B, D) float32 is laid out as the ids' rows
    (gathered over the table axis). The float32 sum adds the ranks'
    partial bags in another order than one bag does; an id at or above V
    reads row V - 1, as the kernel. The table's gradient on each rank is
    its rows', summed over the ranks that split the batch."""
    mesh = table.device_mesh
    rows = [i for i, p in enumerate(table.placements)
            if isinstance(p, Shard) and p.dim == 0]
    if len(rows) != 1 or len(rows) + sum(
            isinstance(p, Replicate) for p in table.placements) != mesh.ndim:
        raise ValueError(f"row_sharded_bag: the table's rows must be split "
                         f"over one mesh axis, got {table.placements}")
    ax = rows[0]
    ids = replicated_as(table, ids)
    idp = tuple(p if i != ax and isinstance(p, Shard) else Replicate()
                for i, p in enumerate(ids.placements))
    ids = ids.redistribute(mesh, idp).to_local()
    local = table.to_local(grad_placements=tuple(
        Shard(0) if i == ax else Partial() if isinstance(p, Shard)
        else Replicate() for i, p in enumerate(idp)))
    v = table.shape[0]
    lo = mesh.get_coordinate()[ax] * -(-v // mesh.size(ax))
    real = ids >= 0
    row = torch.where(real, ids, 0).clamp(max=v - 1) - lo
    mine = real & (row >= 0) & (row < local.shape[0])
    out = bag_ops.embedding_bag(local, torch.where(mine, row, -1), "sum")
    out = _SumOverRanks.apply(out, mesh.get_group(ax))
    if mode == "mean":
        out = out / real.sum(dim=1, keepdim=True).clamp(min=1)
    return DTensor.from_local(out, mesh, idp, run_check=False)


# ---------------------------------------------------------------------------
# Params / towers
# ---------------------------------------------------------------------------

def _weight(t: torch.Tensor) -> nn.Parameter:
    # trainable; the serving steps run under torch.no_grad()
    return nn.Parameter(t)


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
# Training: sampled softmax with in-batch negatives
# ---------------------------------------------------------------------------

def retrieval_loss(cfg: TwoTowerConfig, params: TwoTower,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """In-batch sampled softmax: the positives on the diagonal of
    U @ I^T / temperature (uniform negatives, no log-Q correction)."""
    u = user_tower(cfg, params, batch)                       # (B, D)
    v = item_tower(cfg, params, batch)                       # (B, D)
    logp = torch.log_softmax((u @ v.T) / cfg.temperature, dim=-1)
    return -row_diagonal(logp).mean()


def make_train_step(cfg: TwoTowerConfig, opt_cfg=None, lr: float = 1e-3):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss):
    `retrieval_loss`, its backward, one AdamW step (no weight decay) that
    updates `params` in place."""
    opt_cfg = opt_cfg or AdamWConfig(weight_decay=0.0)

    def train_step(params: TwoTower, opt_state,
                   batch: Dict[str, torch.Tensor]):
        loss = retrieval_loss(cfg, params, batch)
        opt_state = apply_gradients(params, loss, opt_state, lr, opt_cfg)
        return params, opt_state, loss.detach()
    return train_step


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


def batch_spec(cfg: TwoTowerConfig, kind: str, batch: int,
               n_candidates: int = 0) -> Dict[str, torch.Tensor]:
    """Tensors on the meta device standing in for a `kind` batch ('train',
    'bulk', 'serve' or 'retrieval'): the reference's names, shapes and
    types, nothing allocated."""
    def meta(shape, dt=torch.int32):
        return torch.empty(shape, dtype=dt, device="meta")
    user = dict(
        user_id=meta((batch,)),
        user_geo=meta((batch,)),
        user_hist=meta((batch, cfg.hist_len)),
        user_dense=meta((batch, cfg.d_dense), torch.float32),
    )
    if kind == "train" or kind == "bulk":
        return user | dict(item_id=meta((batch,)),
                           item_tags=meta((batch, cfg.tags_len)))
    if kind == "serve":
        return user | dict(cand_emb=meta((batch, 256, cfg.tower_mlp[-1]),
                                         torch.float32))
    if kind == "retrieval":
        return user | dict(cand_id=meta((n_candidates,)),
                           cand_tags=meta((n_candidates, cfg.tags_len)))
    raise ValueError(kind)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}

