"""GNN architectures: MeshGraphNet, SchNet, DimeNet, MACE; the port of the
reference's `repro.models.gnn`.

All four share one batch format (a dict of tensors) with fixed, padded
shapes:
  * node features (N, F) + positions (N, 3) + validity masks,
  * directed edge list (src, dst) with mask,
  * triplet list (edge_kj, edge_ji) with mask for the angular archs
    (DimeNet),
  * graph_id per node for batched-small-graph pooling.

Each model is an `nn.Module` holding the reference's parameter tree under
the same names (`blocks` a `ModuleList`, MACE's `w_prod` a
`ParameterList`, each MLP's w{i} / b{i} as `w.<i>` / `b.<i>`); the
forward functions take (cfg, module, batch) as the reference's take
(cfg, params, batch). Message passing is a segment sum on `index_add`
(the reference's `jax.ops.segment_sum`, XLA's scatter); on the card it
adds with atomics, so two runs may differ in the last bits. Ids outside
[0, n) are refused (`index_add` raises on the CPU and asserts on the
card), where the reference's segment sum drops them; the batch builders
never make such ids. Tasks: node regression (MeshGraphNet) and
graph-level energy regression (SchNet/DimeNet/MACE).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import equivariant as E3
from repro_torch.models.layers import dense_init, layer_norm

Batch = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Batch format and shared pieces
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GraphShapes:
    n_nodes: int
    n_edges: int
    d_feat: int
    n_triplets: int = 0
    n_graphs: int = 1


def batch_spec(shapes: GraphShapes, dtype: torch.dtype = torch.float32
               ) -> Dict[str, torch.Tensor]:
    """Tensors on the meta device standing in for a batch of `shapes`: the
    reference's names, shapes and types (its `ShapeDtypeStruct`s), nothing
    allocated."""
    n, e = shapes.n_nodes, shapes.n_edges

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    s = dict(
        node_feat=meta((n, shapes.d_feat), dtype),
        positions=meta((n, 3), dtype),
        node_mask=meta((n,), torch.bool),
        src=meta((e,), torch.int32),
        dst=meta((e,), torch.int32),
        edge_mask=meta((e,), torch.bool),
        graph_id=meta((n,), torch.int32),
        targets=meta((n,), dtype),
    )
    if shapes.n_triplets:
        t = shapes.n_triplets
        s["trip_kj"] = meta((t,), torch.int32)
        s["trip_ji"] = meta((t,), torch.int32)
        s["trip_mask"] = meta((t,), torch.bool)
    return s


class MLP(nn.Module):
    """The reference's `mlp_params` dict (w{i} (dims[i], dims[i+1]) at
    `dense_init`'s scale, b{i} zeros) with the `mlp_apply` it is always
    called with: `act` between layers, and after the last when
    `final_act`."""

    def __init__(self, generator: torch.Generator, dims: List[int],
                 act: Callable = F.silu, final_act: bool = False):
        super().__init__()
        n = len(dims) - 1
        self.w = nn.ParameterList(
            dense_init(generator, (dims[i], dims[i + 1])) for i in range(n))
        self.b = nn.ParameterList(
            torch.zeros(dims[i + 1], device=generator.device)
            for i in range(n))
        self.act = act
        self.final_act = final_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w.to(x.dtype) + b.to(x.dtype)
            if i < n - 1 or self.final_act:
                x = self.act(x)
        return x


def _weight(generator: torch.Generator, shape, scale: float = 1.0
            ) -> nn.Parameter:
    return nn.Parameter(dense_init(generator, shape) * scale)


def seg_sum(msgs: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Σ of the rows of `msgs` into `n` segments by `dst` (int64, in
    [0, n)): (n, *msgs.shape[1:])."""
    return msgs.new_zeros((n,) + msgs.shape[1:]).index_add(0, dst, msgs)


def rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along dim 0 (idx int64), as `index_select`: its backward is
    `index_add_`, which sums in one order on the CPU, where the backward
    of `x[idx]` (`index_put_` with accumulation) adds with atomics across
    threads and so differs from run to run in the last bits."""
    return x.index_select(0, idx)


def _edges(batch: Batch):
    return batch["src"].long(), batch["dst"].long()


def _edge_vectors(batch: Batch, src: torch.Tensor, dst: torch.Tensor):
    pos = batch["positions"]
    vec = rows(pos, dst) - rows(pos, src)
    dist = torch.linalg.vector_norm(vec + 1e-12, dim=-1)
    return vec, dist


def _linspace(start: float, stop: float, num: int, like: torch.Tensor
              ) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` in float32 bit for bit (its
    formula, start·(1 − s) + stop·s with s = i / (num − 1), and stop
    itself last; torch's and numpy's round otherwise)."""
    s = torch.arange(num - 1, dtype=torch.float32, device=like.device)
    s = s / float(num - 1)
    out = start * (1 - s) + stop * s
    return torch.cat([out, out.new_full((1,), stop)]).to(like.dtype)


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis on [0, cutoff] (SchNet-style)."""
    centers = _linspace(0.0, cutoff, n_rbf, dist)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * torch.square(dist[..., None] - centers))


def bessel_rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """DimeNet spherical Bessel radial basis."""
    d = torch.clamp(dist, 1e-6, cutoff)[..., None]
    n = torch.arange(1, n_rbf + 1, device=dist.device)
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d / cutoff) / d


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    return 0.5 * (torch.cos(math.pi * torch.clamp(dist / cutoff, 0, 1)) + 1.0)


# ===========================================================================
# MeshGraphNet  [arXiv:2010.03409]
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_out: int = 1
    aggregator: str = "sum"


class MGNBlock(nn.Module):
    def __init__(self, generator: torch.Generator, h: int, hidden: List[int]):
        super().__init__()
        dev = generator.device
        self.edge = MLP(generator, [3 * h] + hidden)
        self.node = MLP(generator, [2 * h] + hidden)
        self.ln_e = nn.Parameter(torch.ones(h, device=dev))
        self.ln_e_b = nn.Parameter(torch.zeros(h, device=dev))
        self.ln_n = nn.Parameter(torch.ones(h, device=dev))
        self.ln_n_b = nn.Parameter(torch.zeros(h, device=dev))


class MeshGraphNet(nn.Module):
    """Encoders of nodes and edges (vec, |vec|), `n_layers` blocks of edge
    and node MLPs with residual layer norms, a node decoder."""

    def __init__(self, cfg: MeshGraphNetConfig, generator: torch.Generator,
                 d_feat: int):
        super().__init__()
        h = cfg.d_hidden
        hidden = [h] * cfg.mlp_layers
        self.enc_node = MLP(generator, [d_feat] + hidden, final_act=True)
        self.enc_edge = MLP(generator, [4] + hidden, final_act=True)
        self.dec = MLP(generator, hidden + [cfg.d_out])
        self.blocks = nn.ModuleList(MGNBlock(generator, h, hidden)
                                    for _ in range(cfg.n_layers))


mgn_init = MeshGraphNet


def mgn_forward(cfg: MeshGraphNetConfig, params: MeshGraphNet, batch: Batch):
    n = batch["node_feat"].shape[0]
    src, dst = _edges(batch)
    vec, dist = _edge_vectors(batch, src, dst)
    e_feat = torch.cat([vec, dist[:, None]], dim=-1)
    h = params.enc_node(batch["node_feat"])
    e = params.enc_edge(e_feat)
    emask = batch["edge_mask"][:, None]
    for blk in params.blocks:
        msg_in = torch.cat([e, rows(h, src), rows(h, dst)], dim=-1)
        e = e + layer_norm(blk.edge(msg_in), blk.ln_e, blk.ln_e_b)
        agg = seg_sum(e * emask, dst, n)
        h = h + layer_norm(blk.node(torch.cat([h, agg], dim=-1)),
                           blk.ln_n, blk.ln_n_b)
    return params.dec(h)[..., 0]                    # node-level output


# ===========================================================================
# SchNet  [arXiv:1706.08566]
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0


def ssp(x: torch.Tensor) -> torch.Tensor:  # shifted softplus
    return F.softplus(x) - math.log(2.0)


class SchNetBlock(nn.Module):
    def __init__(self, generator: torch.Generator, cfg: SchNetConfig):
        super().__init__()
        h = cfg.d_hidden
        self.filt = MLP(generator, [cfg.n_rbf, h, h], act=ssp,
                        final_act=True)
        self.in_dense = MLP(generator, [h, h])
        self.out_dense = MLP(generator, [h, h, h], act=ssp)


class SchNet(nn.Module):
    """Embedding, `n_interactions` continuous-filter convolutions, an
    atom-wise energy head."""

    def __init__(self, cfg: SchNetConfig, generator: torch.Generator,
                 d_feat: int):
        super().__init__()
        h = cfg.d_hidden
        self.embed = MLP(generator, [d_feat, h])
        self.out = MLP(generator, [h, h // 2, 1], act=ssp)
        self.blocks = nn.ModuleList(SchNetBlock(generator, cfg)
                                    for _ in range(cfg.n_interactions))


schnet_init = SchNet


def schnet_forward(cfg: SchNetConfig, params: SchNet, batch: Batch):
    n = batch["node_feat"].shape[0]
    src, dst = _edges(batch)
    _, dist = _edge_vectors(batch, src, dst)
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
    fcut = cosine_cutoff(dist, cfg.cutoff) * batch["edge_mask"]
    h = params.embed(batch["node_feat"])
    for blk in params.blocks:
        w = blk.filt(rbf) * fcut[:, None]
        x = blk.in_dense(h)
        msgs = rows(x, src) * w                     # cfconv
        agg = seg_sum(msgs, dst, n)
        h = h + blk.out_dense(agg)
    atom_e = params.out(h)[..., 0]
    return atom_e * batch["node_mask"]              # per-atom energies


def pool_energy(atom_e: torch.Tensor, graph_id: torch.Tensor, n_graphs: int):
    return seg_sum(atom_e, graph_id.long(), n_graphs)


# ===========================================================================
# DimeNet  [arXiv:2003.03123]
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0


def _angular_basis(cos_angle: torch.Tensor, n_spherical: int) -> torch.Tensor:
    """Chebyshev angular basis T_k(cosθ) — stands in for the spherical
    Bessel × Legendre 2-D basis of the paper (same span for fixed radius)."""
    out = [torch.ones_like(cos_angle), cos_angle]
    for _ in range(2, n_spherical):
        out.append(2 * cos_angle * out[-1] - out[-2])
    return torch.stack(out[:n_spherical], dim=-1)


class DimeNetBlock(nn.Module):
    def __init__(self, generator: torch.Generator, cfg: DimeNetConfig):
        super().__init__()
        h = cfg.d_hidden
        self.w_sbf = _weight(generator, (cfg.n_spherical * cfg.n_radial,
                                         cfg.n_bilinear))
        self.w_bilin = _weight(generator, (cfg.n_bilinear, h, h), 0.1)
        self.w_rbf = _weight(generator, (cfg.n_radial, h))
        self.msg = MLP(generator, [h, h])
        self.upd = MLP(generator, [h, h])


class DimeNet(nn.Module):
    """Node and edge embeddings, `n_blocks` directional message-passing
    blocks over triplets, an atom-wise output head."""

    def __init__(self, cfg: DimeNetConfig, generator: torch.Generator,
                 d_feat: int):
        super().__init__()
        h = cfg.d_hidden
        self.embed_node = MLP(generator, [d_feat, h])
        self.embed_edge = MLP(generator, [2 * h + cfg.n_radial, h],
                              final_act=True)
        self.out = MLP(generator, [h, h, 1])
        self.blocks = nn.ModuleList(DimeNetBlock(generator, cfg)
                                    for _ in range(cfg.n_blocks))


dimenet_init = DimeNet


def _bilinear(a: torch.Tensor, w_bilin: torch.Tensor, mk: torch.Tensor
              ) -> torch.Tensor:
    """Σ_b a[t, b] Σ_h w_bilin[b, h, g] mk[t, h], the reference's einsum
    "tb,bhg,th->tg", in a fixed order: mk @ w_bilin laid out (H, nb·G),
    then the sum over b weighted by a. No intermediate is larger than
    (T, nb, G); contracting a with w_bilin first, as a left-to-right
    einsum does, would build (T, H, G)."""
    nb, h, g = w_bilin.shape
    y = mk @ w_bilin.to(mk.dtype).permute(1, 0, 2).reshape(h, nb * g)
    return torch.bmm(a.unsqueeze(1), y.view(-1, nb, g)).squeeze(1)


def dimenet_forward(cfg: DimeNetConfig, params: DimeNet, batch: Batch):
    n = batch["node_feat"].shape[0]
    src, dst = _edges(batch)
    e = src.shape[0]
    vec, dist = _edge_vectors(batch, src, dst)
    rbf = (bessel_rbf(dist, cfg.n_radial, cfg.cutoff)
           * batch["edge_mask"][:, None])
    h = params.embed_node(batch["node_feat"])
    m = params.embed_edge(torch.cat([rows(h, src), rows(h, dst), rbf],
                                    dim=-1))

    # triplet angles: for triplet (kj, ji): angle between edge kj and ji
    kj, ji = batch["trip_kj"].long(), batch["trip_ji"].long()
    vkj = rows(vec, kj)
    vji = rows(vec, ji)
    cosang = (vkj * vji).sum(-1) / (
        torch.linalg.vector_norm(vkj + 1e-12, dim=-1)
        * torch.linalg.vector_norm(vji + 1e-12, dim=-1))
    ang = _angular_basis(torch.clamp(cosang, -1, 1), cfg.n_spherical)
    sbf = (ang[:, :, None] * rows(rbf, kj)[:, None, :]).reshape(
        ang.shape[0], -1)
    tmask = batch["trip_mask"][:, None]

    for blk in params.blocks:
        # directional message passing over triplets
        a = sbf @ blk.w_sbf.to(sbf.dtype)                      # (T, nb)
        mk = rows(blk.msg(m), kj)                               # (T, H)
        inter = _bilinear(a, blk.w_bilin, mk)
        agg = seg_sum(inter * tmask, ji, e)
        m = m + agg + blk.upd(m * (rbf @ blk.w_rbf.to(m.dtype)))
    atom = seg_sum(m * batch["edge_mask"][:, None], dst, n)
    return params.out(atom)[..., 0] * batch["node_mask"]


# ===========================================================================
# MACE  [arXiv:2206.07697]
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0


class MACEBlock(nn.Module):
    def __init__(self, generator: torch.Generator, cfg: MACEConfig):
        super().__init__()
        h = cfg.d_hidden
        self.radial = MLP(generator, [cfg.n_rbf, h, h], final_act=True)
        self.w_msg = _weight(generator, (h, h))
        # per-correlation-order mixing weights (product basis)
        self.w_prod = nn.ParameterList(_weight(generator, (h, h), 0.5)
                                       for _ in range(cfg.correlation))
        self.w_upd = _weight(generator, (h, h))


class MACE(nn.Module):
    """Embedding into the l = 0 slice of an (N, 9, H) irreps state,
    `n_layers` equivariant blocks, a readout of the invariant slice."""

    def __init__(self, cfg: MACEConfig, generator: torch.Generator,
                 d_feat: int):
        super().__init__()
        h = cfg.d_hidden
        self.embed = MLP(generator, [d_feat, h])
        self.readout = MLP(generator, [h, h // 2, 1])
        self.blocks = nn.ModuleList(MACEBlock(generator, cfg)
                                    for _ in range(cfg.n_layers))


mace_init = MACE


def mace_forward(cfg: MACEConfig, params: MACE, batch: Batch):
    """Equivariant message passing with Gaunt tensor products.

    Node state: (N, 9, H) — l≤2 irreps × channels. Scalar (l=0) slice is the
    invariant readout channel. correlation_order=3 is realised as iterated
    Gaunt products of the aggregated A-features (MACE product basis,
    truncated to l ≤ 2)."""
    pos = batch["positions"]
    g = torch.tensor(E3.gaunt_tensor(), dtype=pos.dtype, device=pos.device)
    n = batch["node_feat"].shape[0]
    src, dst = _edges(batch)
    vec, dist = _edge_vectors(batch, src, dst)
    unit = vec / torch.clamp(dist[:, None], min=1e-9)
    sh = E3.real_sph_harm_l2(unit)                           # (E, 9)
    rbf = bessel_rbf(dist, cfg.n_rbf, cfg.cutoff)
    fcut = (cosine_cutoff(dist, cfg.cutoff) * batch["edge_mask"])[:, None]

    h0 = params.embed(batch["node_feat"])                     # (N, H)
    # the reference's state.at[:, 0, :].set(h0), out of place
    state = torch.cat([h0[:, None, :],
                       h0.new_zeros(n, E3.SH_DIM - 1, h0.shape[-1])], dim=1)

    for blk in params.blocks:
        r = blk.radial(rbf) * fcut                            # (E, H)
        # message: R(r) · (Y(r̂) ⊗ h_j), Gaunt-coupled to l≤2
        hj = rows(state, src) @ blk.w_msg.to(state.dtype)     # (E, 9, H)
        sh_c = sh[:, :, None].expand(hj.shape)
        msg = E3.tensor_product(sh_c, hj, g) * r[:, None, :]
        a = seg_sum(msg, dst, n)                              # (N, 9, H)
        # product basis: B = Σ_ν w_ν · a^(⊗ν) (iterated Gaunt products)
        b = torch.zeros_like(a)
        prod = a
        for nu, w in enumerate(blk.w_prod):
            b = b + prod @ w.to(a.dtype)
            if nu + 1 < len(blk.w_prod):
                prod = E3.tensor_product(prod, a, g)
        state = state + b @ blk.w_upd.to(b.dtype)
    inv = state[:, 0, :]                                  # invariant slice
    return params.readout(inv)[..., 0] * batch["node_mask"]
