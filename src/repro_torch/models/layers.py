"""Shared neural building blocks: plain functions on tensors.

Conventions (as in the reference's `repro.models.layers`):
  * matrices are cast to the compute dtype at use, norm weights to float32;
  * `blockwise_attention` is the plain streaming (log-sum-exp over KV
    blocks) attention, what the models take wherever the flash kernel's
    contract does not hold (decode over a cache, a prompt past a sliding
    window); see `repro_torch.models.transformer._attention`;
  * ties in `ordered_top_k` go to the lower index, as `jax.lax.top_k`.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint


def replicated_as(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`t`, a plain tensor that every rank holds alike (positions, RoPE
    frequencies, token ids, an arange), as a replicated DTensor on `ref`'s
    mesh when `ref` is a DTensor, so the two can meet in an op; otherwise
    `t` itself."""
    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        mesh = ref.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return t


def sharded_lookup(table: DTensor, ids: DTensor) -> DTensor:
    """`table[ids]` (rows of a (V, D) DTensor by a DTensor of ids) on each
    rank's shards: a rank looks its ids up in its own rows, zero where
    another rank holds the row, so the rows are a partial sum over the
    axes that split V, reduced and split along D over them (as DTensor's
    own rule lays them out); they come out split as the ids are. The
    table's gradient is a partial sum over the axes that split the ids.
    Written out because torch 2.11's DTensor refuses the index op on ids
    split over two mesh axes, and its backward (`index_put_`) on ids split
    over one."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = table.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    batch = [isinstance(p, Shard) and p.dim == 0 and not v
             for p, v in zip(ids.placements, vocab)]
    ids = ids.redistribute(mesh, [Shard(0) if b else Replicate()
                                  for b in batch])
    if any(isinstance(p, Partial) for p in table.placements):
        table = table.redistribute(mesh, [Replicate() if isinstance(
            p, Partial) else p for p in table.placements])
    rows, off = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    local = table.to_local(grad_placements=[
        Partial() if b and isinstance(p, Replicate) else p
        for b, p in zip(batch, table.placements)])
    i = ids.to_local().long() - off[0]
    hit = (i >= 0) & (i < rows[0])
    out = local[i.clamp(0, max(rows[0] - 1, 0))]
    if any(vocab):
        out = out * hit[..., None].to(out.dtype)
    place = []
    for v, b, p in zip(vocab, batch, table.placements):
        if v:
            place.append(Partial())
        elif b:
            place.append(Shard(0))
        elif isinstance(p, Shard):                  # D split: the last dim
            place.append(Shard(ids.ndim))
        else:
            place.append(Replicate())
    shape = tuple(ids.shape) + tuple(table.shape[1:])
    out = DTensor.from_local(out, mesh, place, run_check=False, shape=shape,
                             stride=torch.empty(shape, device="meta").stride())
    if any(vocab):
        out = out.redistribute(mesh, [Shard(ids.ndim) if v else p
                                      for v, p in zip(vocab, place)])
    return out


def _viewable(t: DTensor, shape) -> DTensor:
    """`t` redistributed so that DTensor can view it as `shape`: in the
    block of dims the view merges or splits (between the leading and the
    trailing dims it keeps), a split survives only on the block's major
    dim and only if the ranks splitting it divide that dim's size on both
    sides; every other split in the block is gathered."""
    shape = tuple(torch.empty(t.shape, device="meta").view(shape).shape)
    n_keep = min(len(shape), t.ndim)
    lo = 0
    while lo < n_keep and shape[lo] == t.shape[lo]:
        lo += 1
    tail = 0
    while tail < n_keep - lo and shape[-1 - tail] == t.shape[-1 - tail]:
        tail += 1
    mesh = t.device_mesh
    keep = []
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and lo <= p.dim < t.ndim - tail:
            n = math.prod(mesh.size(j) for j, q in enumerate(t.placements)
                          if q == p)
            ok = (p.dim == lo and lo < len(shape) and t.shape[lo] % n == 0
                  and shape[lo] % n == 0)
            keep.append(p if ok else Replicate())
        else:
            keep.append(p)
    if tuple(keep) == tuple(t.placements):
        return t
    return t.redistribute(mesh, keep)


class _ShardedView(torch.autograd.Function):
    """A view of a DTensor whose forward and backward each gather first
    what DTensor cannot view (`_viewable`)."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.in_shape = t.shape
        return _viewable(t, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _viewable(g, ctx.in_shape).reshape(ctx.in_shape), None


def sharded_view(t: torch.Tensor, shape) -> torch.Tensor:
    """`t.reshape(shape)`, also for a DTensor whose split dims the reshape
    may merge or split unevenly (e.g. (H·k) over more ranks than divide
    H), which DTensor refuses or gets wrong: such splits are gathered
    first, in the forward and in the backward."""
    if isinstance(t, DTensor):
        return _ShardedView.apply(t, tuple(shape))
    return t.reshape(shape)


def dense_init(generator: torch.Generator, shape, scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, scale^2) draws on the generator's device, in float32, then cast
    to `dtype`. Without `scale`, 1/sqrt(fan-in), the fan-in being the first
    dim of a shape of two or more dims, as the reference's `dense_init`.
    The draws are torch's, not `jax.random`'s: tests carry the reference's
    weights across instead (`repro_torch.interop`)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    out = torch.randn(tuple(shape), generator=generator,
                      device=generator.device) * scale
    return out.to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight + bias
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, rotary_dims: Optional[int] = None,
               device=None) -> torch.Tensor:
    """(d_rot / 2,) float32 inverse frequencies, computed in numpy float32
    as the reference does, so both packages rotate by the same angles."""
    d_rot = rotary_dims or d_head
    inv = 1.0 / (theta ** (np.arange(0, d_rot, 2, dtype=np.float32) / d_rot))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
               rotary_dims: Optional[int] = None) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. GPT-NeoX rotate-half on the
    first `rotary_dims` dims (partial rotary, ChatGLM-style, when < D)."""
    d = x.shape[-1]
    d_rot = rotary_dims or d
    ang = positions[..., None].float() * inv_freq[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :d_rot].float()
    x1, x2 = xr[..., : d_rot // 2], xr[..., d_rot // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), x[..., d_rot:]], dim=-1)


def rope_positions_2d(b: int, s: int, prefix_len: Optional[int] = None,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """ChatGLM 2-D RoPE position channels: (pos_channel, block_channel).

    For pure causal LM data the block channel is zeros (no prefix part);
    the two channels drive the two halves of the rotary dims."""
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(
        b, s)
    blk = torch.zeros((b, s), dtype=torch.int32, device=device)
    return pos, blk


# ---------------------------------------------------------------------------
# Blockwise (streaming) attention — the plain version
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, mask, scale):
    """q: (B, H, Sq, D), k/v: (B, H, Skb, D), mask: (B|1, 1, Sq, Skb).
    Scores in float32 from the inputs' values; probabilities cast to v's
    type before the product with v, as the reference's einsums with
    `preferred_element_type=float32`."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o, m, l


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, q_offset: int = 0,
                        window: Optional[int] = None, kv_block: int = 1024,
                        valid_kv: Optional[torch.Tensor] = None,
                        remat_blocks: bool = False) -> torch.Tensor:
    """Streaming softmax attention.

    q: (B, Sq, H, D); k, v: (B, Sk, H, D) (same head count — GQA expansion is
    done by the caller). Walks KV blocks carrying (acc, max, sum); memory is
    O(Sq·kv_block) instead of O(Sq·Sk).

    `window`: sliding-window attention width (Mistral/Mixtral SWA) — queries
    attend to keys in (pos_q - window, pos_q].
    `valid_kv`: (B, Sk) bool mask for ragged/rolling caches.
    `remat_blocks`: while gradients are on, recompute each block's scores
    and probabilities in the backward instead of saving them (a
    checkpoint around each block's step, as the reference's flash-style
    backward).
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dev = q.device
    scale = 1.0 / np.sqrt(d)
    qt = q.transpose(1, 2)                          # (B, H, Sq, D)
    kv_block = min(kv_block, sk)
    n_blocks = -(-sk // kv_block)
    sk_pad = n_blocks * kv_block
    if sk_pad != sk:
        k = F.pad(k, (0, 0, 0, 0, 0, sk_pad - sk))
        v = F.pad(v, (0, 0, 0, 0, 0, sk_pad - sk))
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)   # (B, H, Sk_pad, D)
    q_pos = q_offset + torch.arange(sq, device=dev)

    def step(acc, m_run, l_run, kb, vb, mask):
        o, m, l = _attend_block(qt, kb, vb, mask, scale)
        m_new = torch.maximum(m_run, m)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(m - m_new)
        return (acc * alpha[..., None] + o * beta[..., None],
                m_new, l_run * alpha + l * beta)

    if remat_blocks and torch.is_grad_enabled():
        step = functools.partial(checkpoint, step, use_reentrant=False)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    m_run = torch.full((b, h, sq), -1e30, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    for blk in range(n_blocks):
        lo = blk * kv_block
        k_pos = lo + torch.arange(kv_block, device=dev)
        mask = torch.ones((1, 1, sq, kv_block), dtype=torch.bool, device=dev)
        if causal:
            mask &= (q_pos[:, None] >= k_pos[None, :])[None, None]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :] < window)[None, None]
        if sk_pad != sk:
            mask &= (k_pos < sk)[None, None, None, :]
        if valid_kv is not None:
            vk = valid_kv[:, k_pos.clamp(0, sk - 1)]
            mask = mask & vk[:, None, None, :]
        acc, m_run, l_run = step(acc, m_run, l_run,
                                 kt[:, :, lo:lo + kv_block],
                                 vt[:, :, lo:lo + kv_block], mask)
    out = acc / l_run.clamp(min=1e-30)[..., None]
    return out.to(q.dtype).transpose(1, 2)          # (B, Sq, H, D)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV*n_rep, D), kv head h serves q heads
    [h*n_rep, (h+1)*n_rep)."""
    if n_rep == 1:
        return x
    b, s, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


def ordered_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, largest
    first and ties to the lower index, as `jax.lax.top_k` (`torch.topk`
    orders ties arbitrarily). A DTensor is sorted on each rank's rows
    (its last dim whole): torch 2.11's backward of a DTensor sort mixes
    in a plain tensor."""
    if isinstance(x, DTensor):
        x, local, place = _row_shards(x)
        vals, idx = ordered_top_k(local, k)
        shape = tuple(x.shape[:-1]) + (vals.shape[-1],)
        stride = torch.empty(shape, device="meta").stride()
        return tuple(DTensor.from_local(t, x.device_mesh, place,
                                        run_check=False, shape=shape,
                                        stride=stride) for t in (vals, idx))
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _row_shards(x: DTensor):
    """x laid out with its last dim whole and nothing partial, its local
    shard (whose gradient is laid out as x), and those placements."""
    last = x.ndim - 1
    place = [Replicate() if isinstance(p, Partial) or (
        isinstance(p, Shard) and p.dim in (last, -1)) else p
        for p in x.placements]
    x = x.redistribute(x.device_mesh, place)
    return x, x.to_local(), place


def row_diagonal(x: torch.Tensor) -> torch.Tensor:
    """The diagonal of a square (B, B) matrix; a DTensor's taken on each
    rank's rows (torch 2.11 has no DTensor rule for its backward), split
    as the rows are."""
    if not isinstance(x, DTensor):
        return x.diagonal()
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    x, local, place = _row_shards(x)
    _, off = compute_local_shape_and_global_offset(x.shape, x.device_mesh,
                                                   place)
    return DTensor.from_local(local.diagonal(offset=off[0]), x.device_mesh,
                              place, run_check=False, shape=x.shape[:1],
                              stride=(1,))


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu is the tanh approximation by default
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot; an index outside [0, n) gives a zero row, as
    `jax.nn.one_hot`."""
    ar = replicated_as(idx, torch.arange(n, device=idx.device))
    return (idx[..., None] == ar).float()


# ---------------------------------------------------------------------------
# FFN: GLU (dense) + GShard-style top-k MoE
# ---------------------------------------------------------------------------

def glu_ffn(x: torch.Tensor, w_in: torch.Tensor, w_gate: torch.Tensor,
            w_out: torch.Tensor, act: str = "silu", hint=None) -> torch.Tensor:
    """(act(x @ w_gate) * (x @ w_in)) @ w_out; `hint` (Megatron-TP: the
    (B, S, F) products sharded on F) applied to both products."""
    h = x @ w_in.to(x.dtype)
    g = x @ w_gate.to(x.dtype)
    if hint is not None:
        h, g = hint(h), hint(g)
    return (h * _act(g, act)) @ w_out.to(x.dtype)


class _Dense(torch.autograd.Function):
    """A copy of a DTensor in the contiguous layout, its gradient too.
    DTensor decides a view or a copy from the global strides, which an
    einsum's permuted output (or its gradient) need not share with the
    local shard; a fresh copy has the same layout on both."""

    @staticmethod
    def forward(ctx, t):
        return t.clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return g.clone(memory_format=torch.contiguous_format)


def _expert_operand(t: torch.Tensor, like: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """An operand or a product of `moe_ffn`'s expert einsums as DTensor
    can take it: plain tensors pass as they are, a DTensor is copied
    densely (`_Dense`). With `like`, it is first laid out as `like`'s
    groups (split on dim 0 where `like` is, replicated on every other
    mesh axis): DTensor's own layout for an expert product may split the
    capacity or the expert dim unevenly (mixtral's 8 experts on a 16-wide
    axis), which the next einsum's views refuse."""
    if not isinstance(t, DTensor):
        return t
    if like is not None:
        keep = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in like.placements]
        t = t.redistribute(t.device_mesh, keep)
    return _Dense.apply(t)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
            w_gate: torch.Tensor, w_out: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, group_size: int = 1024,
            act: str = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard/Mixtral top-k MoE with grouped capacity dispatch.

    x: (B, S, D); router_w: (D, E); expert weights: (E, D, F) / (E, F, D).
    Tokens are processed in groups so dispatch tensors stay bounded; a
    (token, choice) past its expert's capacity is dropped. Routing, queue
    positions and combine weights are float32, as the reference's.
    Returns (y, aux_loss).
    """
    b, s, d = x.shape
    e = router_w.shape[1]
    t = b * s
    g = max(t // group_size, 1)
    gs = t // g
    xg = sharded_view(x, (g, gs, d))
    logits = torch.einsum("gtd,de->gte", xg, router_w.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # aux load-balance loss (Switch): E * mean(fraction) . mean(prob)
    me = probs.mean(dim=1)                                    # (G, E)
    gates, top_idx = ordered_top_k(probs, top_k)              # (G, T, K)
    onehot = _one_hot(top_idx, e)                             # (G, T, K, E)
    ce = onehot.sum(dim=2).mean(dim=1)                        # (G, E)
    aux = (me * ce).sum(dim=-1).mean() * e

    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    capacity = int(np.ceil(gs * top_k * capacity_factor / e))
    # position of each (token, k) within its expert queue
    flat = onehot.reshape(g, gs * top_k, e)
    pos = (flat.cumsum(dim=1) - flat).reshape(g, gs, top_k, e)
    keep = onehot * (pos < capacity)
    pos_onehot = _one_hot((pos * onehot).sum(dim=-1).to(torch.int32),
                          capacity)                           # (G,T,K,C)
    dispatch = torch.einsum("gtke,gtkc->gtec", keep, pos_onehot)
    combine = torch.einsum("gtke,gtk,gtkc->gtec", keep, gates, pos_onehot)
    dense = _expert_operand
    xe = dense(torch.einsum("gtec,gtd->gecd", dense(dispatch.to(x.dtype)),
                            dense(xg)))
    hh = dense(torch.einsum("gecd,edf->gecf", xe, w_in.to(x.dtype)))
    gg = _act(dense(torch.einsum("gecd,edf->gecf", xe,
                                 w_gate.to(x.dtype))), act)
    ye = torch.einsum("gecf,efd->gecd", dense(hh * gg), w_out.to(x.dtype))
    y = dense(torch.einsum("gtec,gecd->gtd", dense(combine.to(x.dtype), xg),
                           dense(ye, xg)))
    return sharded_view(y, (b, s, d)), aux
