"""Decoder-only LM transformer covering the five assigned LM architectures:
the port of the reference's `repro.models.transformer`, serving and
training.

One parameterised implementation:
  * GQA with arbitrary (n_heads, n_kv_heads),
  * RoPE (standard / partial / ChatGLM 2-D), configurable theta,
  * optional per-head qk RMS-norm (Qwen3),
  * optional sliding-window attention + rolling KV cache (Mixtral),
  * dense GLU FFN or GShard-style top-k MoE (Mixtral, Phi-3.5-MoE),
  * bias-free projections (all five archs are no-bias).

The weights are a `Transformer` module: a `ModuleList` of `Layer`s in
place of the reference's stacked (n_layers, ...) leaves and `lax.scan`.
Norm weights are float32; matrices are stored in the type `init_params`
is given. The reference stores float32 and casts each matrix to
`cfg.dtype` at every use, as the port's products do. Training stores
float32 (master weights: an update below cfg.dtype's resolution is kept);
serving stores cfg.dtype, the cast made once, which rounds to nearest
even in both packages and so computes the same values at half the memory.

Forward modes:
  * `forward(cfg, params, tokens)`           — full-sequence logits,
  * `lm_loss(cfg, params, tokens, targets)`  — training loss (mean next-
    token NLL + the MoE aux loss), chunked over the sequence when
    `cfg.loss_chunk` is set; each layer under the remat policy
    `cfg.remat` while gradients are on,
  * `lm_steps.make_prefill_step(cfg)`        — last logits + KV cache,
  * `decode_step(cfg, params, cache, token)` — single-token serve step.

The full-sequence attention runs on the flash kernel, forward and
backward (`kernels.flash_attention.ops.mha`).

Sharded runs: lay the weights out as DTensors (`sharding.lm`'s rules,
`sharding.lm.shard_transformer`) and every function here runs on them,
plain tensors made inside (positions, RoPE frequencies, masks) taken as
replicated. `cfg.shard_hints` pins the activations' layout where the
reference pins it with `with_sharding_constraint` (`_hint`): each hint is
a DTensor redistribution, and on plain tensors it changes nothing. Every
weight product (the projections, the GLU, the head; the MoE's router and
experts in `layers.moe_ffn`) takes the rules' layout on local shards,
forward and backward (`layers.pinned_matmul`), so a rank's work is shape
arithmetic under any torch version; a hint redistributes its output
after. The attention runs on each rank's local shards (`_attention`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models import layers as L

# weights held in float32 whatever cfg.dtype is (rms_norm casts them)
NORM_WEIGHTS = ("ln_attn", "ln_ffn", "q_norm", "k_norm")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # MoE (None -> dense)
    n_experts: Optional[int] = None
    top_k: int = 2
    capacity_factor: float = 1.25
    # attention details
    rope_theta: float = 10000.0
    rope_style: str = "neox"            # 'neox' | '2d'
    rotary_pct: float = 1.0
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    # misc
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # training: the remat policy of each layer, XLA's scan unrolling (no
    # torch counterpart: the layers are a Python loop), chunked
    # cross-entropy, recompute of the blockwise attention's blocks
    remat: str = "nothing_saveable"     # 'none' | 'nothing_saveable' | 'dots'
    moe_group_size: int = 1024
    unroll_scans: bool = False
    loss_chunk: int = 0
    # activation layouts of a sharded run: (dp_axes, tp_axis, heads_tp,
    # ctx, ffn_tp, seq_res), the last three optional (see `_hint`)
    shard_hints: Optional[Tuple] = None
    remat_blocks: bool = False

    @property
    def is_moe(self) -> bool:
        return self.n_experts is not None

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
            + self.n_heads * self.d_head * d
        if self.is_moe:
            ffn = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
            + self.n_heads * self.d_head * d
        ffn = self.top_k * 3 * d * f + d * self.n_experts
        per_layer = attn + ffn + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _weight(t: torch.Tensor) -> nn.Parameter:
    # trainable; the serving steps run under torch.no_grad()
    return nn.Parameter(t)


class Layer(nn.Module):
    """One decoder layer's weights, named as the reference's leaves:
    ln_attn (D,), wq (D, H, hd), wk / wv (D, KV, hd), wo (H, hd, D),
    ln_ffn (D,), q_norm / k_norm (hd,) with qk_norm; dense: w_in / w_gate
    (D, F), w_out (F, D); MoE: router (D, E), w_in / w_gate (E, D, F),
    w_out (E, F, D)."""

    def __init__(self, weights: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in weights.items():
            setattr(self, name, _weight(t))


class Transformer(nn.Module):
    """embed (V, D), `layers`, ln_final (D,), lm_head (D, V) unless the
    config ties it to embed; the RoPE frequencies as a buffer `inv_freq`
    on the weights' device (made once: a host-to-device copy a layer
    would wait for the card's queue each time)."""

    def __init__(self, cfg: TransformerConfig, embed: torch.Tensor,
                 layers: List[Dict[str, torch.Tensor]],
                 ln_final: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} layers for "
                             f"n_layers={cfg.n_layers}")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: lm_head must be given exactly "
                             "when the embeddings are not tied")
        self.cfg = cfg
        self.embed = _weight(embed)
        self.layers = nn.ModuleList(Layer(w) for w in layers)
        self.ln_final = _weight(ln_final)
        self.lm_head = None if lm_head is None else _weight(lm_head)
        self.register_buffer("inv_freq", rope_inv_freq(cfg, embed.device),
                             persistent=False)

    def head(self) -> torch.Tensor:
        """(D, V) output projection."""
        return self.embed.T if self.lm_head is None else self.lm_head

    def forward(self, tokens: torch.Tensor):
        return forward(self.cfg, self, tokens)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None) -> Transformer:
    """Random weights on the generator's device, matrices stored in `dtype`
    (cfg.dtype by default, for serving; float32 for training). Each matrix
    is drawn in float32 and cast before the next is drawn, so the peak
    memory is the model's plus one float32 matrix.

    Scales are the reference's. It draws each stacked (n_layers, ...) leaf
    with `dense_init`, whose fan-in is the first dim, so the leaves without
    an explicit scale (wq, wk, wv, and the dense w_in, w_gate) are
    N(0, 1/n_layers); the others are as written below."""
    dt = dtype or compute_dtype(cfg)
    dev = generator.device
    d, hd, nl = cfg.d_model, cfg.d_head, cfg.n_layers
    stacked = 1.0 / np.sqrt(nl)

    def mat(*shape, scale=stacked):
        return L.dense_init(generator, shape, scale, dt)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=dev)

    layers = []
    for _ in range(nl):
        w = dict(ln_attn=ones(d), wq=mat(d, cfg.n_heads, hd),
                 wk=mat(d, cfg.n_kv_heads, hd), wv=mat(d, cfg.n_kv_heads, hd),
                 wo=mat(cfg.n_heads, hd, d,
                        scale=1.0 / np.sqrt(cfg.n_heads * hd)),
                 ln_ffn=ones(d))
        if cfg.qk_norm:
            w.update(q_norm=ones(hd), k_norm=ones(hd))
        if cfg.is_moe:
            e = cfg.n_experts
            w.update(router=mat(d, e, scale=0.02),
                     w_in=mat(e, d, cfg.d_ff, scale=1.0 / np.sqrt(d)),
                     w_gate=mat(e, d, cfg.d_ff, scale=1.0 / np.sqrt(d)),
                     w_out=mat(e, cfg.d_ff, d, scale=1.0 / np.sqrt(cfg.d_ff)))
        else:
            w.update(w_in=mat(d, cfg.d_ff), w_gate=mat(d, cfg.d_ff),
                     w_out=mat(cfg.d_ff, d, scale=1.0 / np.sqrt(cfg.d_ff)))
        layers.append(w)
    embed = mat(cfg.vocab, d, scale=1.0)
    lm_head = None if cfg.tie_embeddings else mat(d, cfg.vocab, scale=None)
    return Transformer(cfg, embed, layers, ones(d), lm_head)


# ---------------------------------------------------------------------------
# Layer body (shared by forward / prefill / decode)
# ---------------------------------------------------------------------------

def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bsd,dhk->bshk': x (B, S, D) by w (D, H, k) in x's type
    (`layers.pinned_matmul`)."""
    b, s, _ = x.shape
    wf = L.sharded_view(w.to(x.dtype), (w.shape[0], -1))
    return L.sharded_view(L.pinned_matmul(x, wf), (b, s, *w.shape[1:]))


def _out_proj(a: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """'bshk,hkd->bsd'."""
    b, s = a.shape[:2]
    wf = L.sharded_view(wo.to(a.dtype), (-1, wo.shape[-1]))
    return L.pinned_matmul(L.sharded_view(a, (b, s, -1)), wf)


def rotary_dims(cfg: TransformerConfig) -> int:
    """The head dims the position rotates. ChatGLM 2-D RoPE: two position
    channels drive the two halves of the rotary dims; causal LM uses
    (pos, 0) channels, and the second channel's rotation by 0 is the
    identity, so only the first half turns."""
    d_rot = int(cfg.d_head * cfg.rotary_pct)
    return d_rot // 2 if cfg.rope_style == "2d" else d_rot


def rope_inv_freq(cfg: TransformerConfig, device=None) -> torch.Tensor:
    return L.rope_freqs(cfg.d_head, cfg.rope_theta, rotary_dims(cfg), device)


def _hint_spec(cfg: TransformerConfig, kind: str):
    """The layout `cfg.shard_hints` = (dp_axes, tp_axis, heads_tp, ctx,
    ffn_tp, seq_res) pins an activation of `kind` to, as a spec
    (`sharding.spec`):
      heads_tp — shard attention heads over tp (requires divisibility);
      ctx      — shard the QUERY sequence dim over tp instead (context
                 parallelism: every query row consumes the same KV stream);
                 used when the head count does not divide tp (qwen3);
      ffn_tp   — (default on) the GLU's (B, S, F) sharded on F over tp
                 (Megatron-TP); off: ZeRO-style, weights gathered at use,
                 activations batch-parallel;
      seq_res  — Megatron sequence parallelism: the residual stream
                 sequence-sharded over tp between blocks."""
    h = cfg.shard_hints
    dp, tp, heads_tp = h[:3]
    ctx = h[3] if len(h) > 3 else False
    ffn_tp = h[4] if len(h) > 4 else True
    seq_res = h[5] if len(h) > 5 else False
    q_spec = ((dp, None, tp, None) if heads_tp else
              (dp, tp, None, None) if ctx else
              (dp, None, None, None))
    return {
        "tokens3d": (dp, tp, None) if seq_res else (dp, None, None),
        "heads": q_spec,                                     # (B, S, H, dh)
        "kv": (dp, None, None, None),                        # (B, S, KV, dh)
        "ffn": (dp, None, tp) if ffn_tp else (dp, None, None),
        "logits": (dp, None, tp),                            # (B, S, V)
    }[kind]


def _hint(cfg: TransformerConfig, x: torch.Tensor, kind: str) -> torch.Tensor:
    """Pin activation `x` to `_hint_spec(cfg, kind)`'s layout: a DTensor
    redistribution (collectives where the layout changes; none on a world
    of one). Without hints, or on a plain tensor, `x` itself."""
    if cfg.shard_hints is None or not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.spec import placements  # sharding imports T
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(_hint_spec(cfg, kind), mesh))


def _qkv(cfg: TransformerConfig, lp: Layer, x: torch.Tensor,
         positions: torch.Tensor, inv_freq: torch.Tensor,
         hints: bool = True):
    """Normed, projected, qk-normed and rotated q (B, S, H, hd) and k, v
    (B, S, KV, hd) of x (B, S, D) at `positions` (B, S); with `hints`, q
    pinned by the "heads" hint and k, v by "kv" after the projections, as
    the reference's forward (its decode step pins none)."""
    h = L.rms_norm(x, lp.ln_attn, cfg.norm_eps)
    q, k, v = (_proj(h, w) for w in (lp.wq, lp.wk, lp.wv))
    if hints:
        q = _hint(cfg, q, "heads")
        k, v = _hint(cfg, k, "kv"), _hint(cfg, v, "kv")
    if cfg.qk_norm:
        q = L.rms_norm(q, lp.q_norm, cfg.norm_eps)
        k = L.rms_norm(k, lp.k_norm, cfg.norm_eps)
    d_rot = rotary_dims(cfg)
    return (L.apply_rope(q, positions, inv_freq, d_rot),
            L.apply_rope(k, positions, inv_freq, d_rot), v)


def takes_flash(cfg: TransformerConfig, s: int, *, cache_kv=None,
                q_offset: int = 0, valid_kv=None) -> bool:
    """Whether `_attention` over s queries starting at position q_offset
    runs on the flash kernel: causal attention over keys from position 0
    (no cache, no validity mask; the kernel masks k_pos > q_pos + q_offset)
    within the sliding window if there is one (the last query, at
    q_offset + s - 1, sees every earlier key)."""
    return (cache_kv is None and valid_kv is None
            and (cfg.sliding_window is None
                 or q_offset + s <= cfg.sliding_window))


def _attention(cfg: TransformerConfig, lp: Layer, x: torch.Tensor,
               positions: torch.Tensor, *, cache_kv=None, q_offset: int = 0,
               valid_kv=None, kv_block: int = 1024, inv_freq: torch.Tensor):
    """x: (B, S, D); inv_freq: the model's RoPE frequencies
    (`Transformer.inv_freq`). Returns (out, (k, v) of this call).

    A static rule on shapes picks the attention (`takes_flash`): the
    prefill and the full forward, with no window or a prompt no longer
    than it, call `flash_attention.ops.mha` on the GQA-expanded heads (the
    kernel on the card, its plain version on the CPU); otherwise (a cache,
    a validity mask, a prompt past the window) the plain
    `blockwise_attention`, as the reference everywhere. Both compute the
    same function."""
    q, k, v = _qkv(cfg, lp, x, positions, inv_freq)
    k_all, v_all = (k, v) if cache_kv is None else cache_kv
    k_exp = L.repeat_kv(k_all, cfg.q_per_kv)
    v_exp = L.repeat_kv(v_all, cfg.q_per_kv)
    kw = dict(cache_kv=cache_kv, q_offset=q_offset, valid_kv=valid_kv,
              kv_block=kv_block)
    if isinstance(q, DTensor):
        out = _local_attention(cfg, q, k_exp, v_exp, **kw)
    else:
        out = _attend(cfg, q, k_exp, v_exp, **kw)
    return _hint(cfg, _out_proj(out, lp.wo), "tokens3d"), (k, v)


def _attend(cfg: TransformerConfig, q, k_exp, v_exp, *, cache_kv, q_offset,
            valid_kv, kv_block):
    """Attention of q (B, S, H, hd), its rows at positions q_offset on,
    over the GQA-expanded k, v (plain tensors): the flash kernel where
    `takes_flash`, else the plain `blockwise_attention`."""
    if takes_flash(cfg, q.shape[1], cache_kv=cache_kv, q_offset=q_offset,
                   valid_kv=valid_kv):
        return flash.mha(q, k_exp, v_exp, causal=True, q_offset=q_offset)
    return L.blockwise_attention(
        q, k_exp, v_exp, causal=cache_kv is None, q_offset=q_offset,
        window=cfg.sliding_window, valid_kv=valid_kv, kv_block=kv_block,
        remat_blocks=cfg.remat_blocks)


def _local_attention(cfg: TransformerConfig, q: DTensor, k_exp: DTensor,
                     v_exp: DTensor, **kw) -> DTensor:
    """`_attend` on each rank's shards of DTensor q (B, S, H, hd) and the
    expanded k, v: q keeps its layout (a partial sum reduced first), k and
    v take it too except along the sequence, which they hold whole, so a
    rank's query heads keep their GQA KV heads and every query row sees
    its keys. Under context parallelism (q's rows split over a mesh axis)
    a rank's rows start at an offset, which the flash kernel's causal mask
    takes (`flash.mha(..., q_offset=)`), so every rank runs the kernel.
    The result is a DTensor laid out as q."""
    mesh = q.device_mesh
    qp = tuple(p if isinstance(p, Shard) and p.dim < 3 else Replicate()
               for p in q.placements)
    ctx = [isinstance(p, Shard) and p.dim == 1 for p in qp]
    kvp = tuple(Replicate() if c else p for c, p in zip(ctx, qp))
    # a rank's rows reach all keys: their gradient sums over the row split
    kv_grad = tuple(Partial() if c else p for c, p in zip(ctx, qp))
    q = q.redistribute(mesh, qp)
    ql = q.to_local()
    kl = k_exp.redistribute(mesh, kvp).to_local(grad_placements=kv_grad)
    vl = v_exp.redistribute(mesh, kvp).to_local(grad_placements=kv_grad)
    offset = kw.pop("q_offset")
    coord = mesh.get_coordinate()
    for i, c in enumerate(ctx):
        if c:
            # DTensor's split: ceil(S / n) rows a rank, the last short
            offset += coord[i] * -(-q.shape[1] // mesh.size(i))
    out = _attend(cfg, ql, kl, vl, q_offset=offset, **kw)
    # contiguous: DTensor's views read the global (contiguous) strides
    return DTensor.from_local(out.contiguous(), mesh, qp, run_check=False,
                              shape=q.shape, stride=q.stride())


def _ffn(cfg: TransformerConfig, lp: Layer, x: torch.Tensor):
    h = L.rms_norm(x, lp.ln_ffn, cfg.norm_eps)
    if cfg.is_moe:
        y, aux = L.moe_ffn(h, lp.router, lp.w_in, lp.w_gate, lp.w_out,
                           top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           group_size=cfg.moe_group_size, act=cfg.act)
        return _hint(cfg, y, "tokens3d"), aux
    y = L.glu_ffn(h, lp.w_in, lp.w_gate, lp.w_out, cfg.act,
                  hint=functools.partial(_hint, cfg, kind="ffn"))
    return _hint(cfg, y, "tokens3d"), 0.0


def _layer(cfg: TransformerConfig, lp: Layer, x: torch.Tensor,
           positions: torch.Tensor, **kw):
    x = _hint(cfg, x, "tokens3d")
    a, kv = _attention(cfg, lp, x, positions, **kw)
    x = x + a
    f, aux = _ffn(cfg, lp, x)
    return x + f, aux, kv


def embed_tokens(cfg: TransformerConfig, params: Transformer,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embedding rows in cfg.dtype (plain tokens beside DTensor
    weights are taken as the same on every rank)."""
    tokens = L.replicated_as(params.embed, tokens)
    if isinstance(tokens, DTensor):
        return L.sharded_lookup(params.embed, tokens).to(compute_dtype(cfg))
    return params.embed[tokens.long()].to(compute_dtype(cfg))


def positions_of(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


# ---------------------------------------------------------------------------
# Forward modes
# ---------------------------------------------------------------------------

# the matrix products a 'dots' remat saves: those without batch dims, as
# the reference's `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`
# (the weight products; attention's and the MoE dispatch's batched
# products are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(cfg: TransformerConfig, fn):
    """The reference's remat policy of a layer (`jax.checkpoint` with a
    policy) in torch, applied while gradients are on: 'nothing_saveable'
    recomputes the whole layer in the backward (a non-reentrant
    `torch.utils.checkpoint.checkpoint`), 'dots' saves the matrix products'
    outputs and recomputes the rest (a selective checkpoint), 'none'
    saves every activation."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = dict(use_reentrant=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat != "nothing_saveable":
        raise ValueError(f"{cfg.name}: unknown remat policy {cfg.remat!r}")
    return functools.partial(checkpoint, fn, **kw)


def _trunk(cfg: TransformerConfig, params: Transformer, tokens: torch.Tensor):
    """The embedded tokens through every layer, each under the remat
    policy: (x (B, S, D) in cfg.dtype, the layers' aux loss summed)."""
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = L.replicated_as(x, positions_of(b, s, x.device))
    inv_freq = L.replicated_as(x, params.inv_freq)

    def body(lp, x):
        x2, aux2, _ = _layer(cfg, lp, x, positions, inv_freq=inv_freq)
        return x2, aux2

    body = _remat_wrap(cfg, body)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        x, aux_l = body(lp, x)
        aux = aux + aux_l
    return x, aux


def forward(cfg: TransformerConfig, params: Transformer, tokens: torch.Tensor):
    """tokens: (B, S) -> (logits (B, S, V) float32, aux_loss)."""
    x, aux = _trunk(cfg, params, tokens)
    x = L.rms_norm(x, params.ln_final, cfg.norm_eps)
    logits = _hint(cfg, L.pinned_matmul(x, params.head().to(x.dtype)),
                   "logits")
    return logits.float(), aux / cfg.n_layers


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[target] a position."""
    logp = torch.log_softmax(logits, dim=-1)
    targets = L.replicated_as(logp, targets)
    return -logp.gather(-1, targets.long()[..., None])[..., 0]


def lm_loss(cfg: TransformerConfig, params: Transformer, tokens: torch.Tensor,
            targets: torch.Tensor, aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token NLL of `targets` (B, S) + aux_weight * the MoE aux
    loss, a float32 scalar (a DTensor, partial over the batch's ranks, when
    the weights are DTensors: `.full_tensor()` reduces it). With
    cfg.loss_chunk, `_lm_loss_chunked`."""
    if not cfg.loss_chunk:
        logits, aux = forward(cfg, params, tokens)
        return _nll(logits, targets).mean() + aux_weight * aux
    return _lm_loss_chunked(cfg, params, tokens, targets, aux_weight)


def _lm_loss_chunked(cfg: TransformerConfig, params: Transformer,
                     tokens: torch.Tensor, targets: torch.Tensor,
                     aux_weight: float) -> torch.Tensor:
    """Memory-lean loss: run the trunk once, then the vocab projection and
    log-softmax one sequence chunk of cfg.loss_chunk positions at a time,
    each under a checkpoint, so no more than one chunk's (B, c, V) logits
    live at once; the backward recomputes each. As in the reference, a
    sequence that the chunk does not divide is padded with zero
    activations and target 0, and the padded positions' NLL (log V each)
    counts in the sum, which is divided by B * S."""
    x, aux = _trunk(cfg, params, tokens)
    x = L.rms_norm(x, params.ln_final, cfg.norm_eps)
    head = params.head()
    b, s = tokens.shape
    c = cfg.loss_chunk
    pad = -s % c
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))

    def chunk_nll(xi, ti):
        return _nll(_hint(cfg, L.pinned_matmul(xi, head.to(xi.dtype)),
                          "logits").float(), ti).sum()

    nll = chunk_nll if not torch.is_grad_enabled() else functools.partial(
        checkpoint, chunk_nll, use_reentrant=False)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s + pad, c):
        total = total + nll(x[:, i:i + c], targets[:, i:i + c])
    return total / (b * s) + aux_weight * aux / cfg.n_layers


# ---- serving --------------------------------------------------------------

def cache_len(cfg: TransformerConfig, seq_len: int) -> int:
    """Rolling SWA caches hold only the window (Mixtral rolling buffer)."""
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg: TransformerConfig, batch: int, seq_len: int, dtype=None,
               device=None) -> dict:
    """k, v: (n_layers, B, cache_len, KV, hd) zeros; pos: tokens inside."""
    dt = dtype or compute_dtype(cfg)
    c = cache_len(cfg, seq_len)
    shape = (cfg.n_layers, batch, c, cfg.n_kv_heads, cfg.d_head)
    return dict(k=torch.zeros(shape, dtype=dt, device=device),
                v=torch.zeros(shape, dtype=dt, device=device), pos=0)


def _decode_cache_layout(cache: dict, ref: torch.Tensor) -> dict:
    """`cache` as the sharded decode step reads it: k, v DTensors on
    `ref`'s mesh (a plain cache replicated), the batch (dim 1) and the
    slots (dim 2) split as the caller laid them out (`sharding.lm.
    cache_spec`), nothing else split or partial."""
    k = L.replicated_as(ref, cache["k"])
    mesh = k.device_mesh
    place = [p if isinstance(p, Shard) and p.dim in (1, 2) else Replicate()
             for p in k.placements]
    return dict(cache, k=k.redistribute(mesh, place),
                v=L.replicated_as(k, cache["v"]).redistribute(mesh, place))


def _decode_attention_sharded(cfg: TransformerConfig, q, k, v, cache: dict,
                              i: int, slot: int, n_filled: int,
                              kv_block: int) -> DTensor:
    """Layer i's decode attention on each rank's shards of the cache
    (`_decode_cache_layout`), the reference's layout: q (B, 1, H, hd) and
    the new k, v take the cache's batch split, and a rank attends its
    query rows over its own slots. The new k, v go into the slot's
    owner's shard in place. Where the slots are split, each rank's
    `blockwise_partial` carry is rescaled to the maxima's max and summed
    over those axes (all-reduces of max and sum). Returns (B, 1, H, hd),
    split as the cache's batch."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    kc, vc = cache["k"], cache["v"]
    mesh = kc.device_mesh
    place = [Shard(0) if isinstance(p, Shard) and p.dim == 1
             else Replicate() for p in kc.placements]
    q_l, k_l, v_l = (L.replicated_as(kc, t).redistribute(mesh, place)
                     .to_local() for t in (q, k, v))
    local, off = compute_local_shape_and_global_offset(kc.shape, mesh,
                                                       kc.placements)
    n_slots, first = local[2], off[2]
    kc_l, vc_l = kc.to_local()[i], vc.to_local()[i]
    if first <= slot < first + n_slots:
        kc_l[:, slot - first] = k_l[:, 0].to(kc_l.dtype)
        vc_l[:, slot - first] = v_l[:, 0].to(vc_l.dtype)
    valid = first + torch.arange(n_slots, device=q_l.device) < n_filled
    acc, m, l = L.blockwise_partial(
        q_l, L.repeat_kv(kc_l, cfg.q_per_kv), L.repeat_kv(vc_l, cfg.q_per_kv),
        causal=False, valid_kv=valid[None, :].expand(q_l.shape[0], n_slots),
        kv_block=kv_block)
    groups = [mesh.get_group(d) for d, p in enumerate(kc.placements)
              if isinstance(p, Shard) and p.dim == 2]
    if groups:
        top = m
        for g in groups:
            top = funcol.all_reduce(top, "max", g)
        w = torch.exp(m - top)
        acc, l = acc * w[..., None], l * w
        for g in groups:
            acc, l = funcol.all_reduce(acc, "sum", g), funcol.all_reduce(
                l, "sum", g)
    out = (acc / l.clamp(min=1e-30)[..., None]).to(q_l.dtype).transpose(1, 2)
    return DTensor.from_local(
        out.contiguous(), mesh, place, run_check=False, shape=q.shape,
        stride=torch.empty(q.shape, device="meta").stride())


@torch.no_grad()
def decode_step(cfg: TransformerConfig, params: Transformer, cache: dict,
                token: torch.Tensor):
    """token: (B, 1) int. Returns (logits (B, 1, V) float32, cache).

    The cache position `cache["pos"]` (an int) is the number of tokens
    already inside. The new token's k, v are written into the cache's
    tensors in place (slot `pos`, or `pos % cache_len` for a rolling SWA
    cache; a full non-rolling cache keeps writing its last slot, as the
    reference's clamped update does), then each layer attends over the
    filled slots with the plain `blockwise_attention` (a sharded step on
    each rank's shards of the cache, `_decode_attention_sharded`, its
    weight products by `layers.pinned_matmul`); the returned cache
    holds the same tensors and pos + 1."""
    b = token.shape[0]
    c = cache["k"].shape[2]
    pos = int(cache["pos"])
    x = embed_tokens(cfg, params, token)
    sharded = isinstance(x, DTensor)
    if sharded:
        cache = _decode_cache_layout(cache, x)
    dev = x.device
    positions = L.replicated_as(x, torch.full((b, 1), pos, dtype=torch.int32,
                                              device=dev))
    inv_freq = L.replicated_as(x, params.inv_freq)
    slot = pos % c if cfg.sliding_window is not None else min(pos, c - 1)
    n_filled = min(pos + 1, c)
    valid = (torch.arange(c, device=dev) < n_filled)[None, :]   # every row
    # rolling buffer: every filled slot is within the window by
    # construction; position masking is handled by validity
    kv_block = 2048 if cfg.sliding_window is None else min(2048, c)
    for i, lp in enumerate(params.layers):
        q, k, v = _qkv(cfg, lp, x, positions, inv_freq, hints=False)
        if sharded:
            out = _decode_attention_sharded(cfg, q, k, v, cache, i, slot,
                                            n_filled, kv_block)
        else:
            k_l, v_l = cache["k"][i], cache["v"][i]
            k_l[:, slot] = k[:, 0].to(k_l.dtype)
            v_l[:, slot] = v[:, 0].to(v_l.dtype)
            k_exp = L.repeat_kv(k_l, cfg.q_per_kv)
            v_exp = L.repeat_kv(v_l, cfg.q_per_kv)
            out = L.blockwise_attention(q, k_exp, v_exp, causal=False,
                                        valid_kv=valid.expand(b, c),
                                        kv_block=kv_block)
        x = x + _out_proj(out, lp.wo)
        f, _ = _ffn(cfg, lp, x)
        x = x + f
    x = L.rms_norm(x, params.ln_final, cfg.norm_eps)
    logits = L.pinned_matmul(x, params.head().to(x.dtype))
    return logits.float(), dict(k=cache["k"], v=cache["v"], pos=pos + 1)
