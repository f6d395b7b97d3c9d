"""Decoder-only LM transformer covering the five assigned LM architectures:
the serving half of the reference's `repro.models.transformer`.

One parameterised implementation:
  * GQA with arbitrary (n_heads, n_kv_heads),
  * RoPE (standard / partial / ChatGLM 2-D), configurable theta,
  * optional per-head qk RMS-norm (Qwen3),
  * optional sliding-window attention + rolling KV cache (Mixtral),
  * dense GLU FFN or GShard-style top-k MoE (Mixtral, Phi-3.5-MoE),
  * bias-free projections (all five archs are no-bias).

The weights are a `Transformer` module: a `ModuleList` of `Layer`s in
place of the reference's stacked (n_layers, ...) leaves and `lax.scan`.
Matrices are held in `cfg.dtype` and norm weights in float32: the
reference stores float32 and casts each matrix to `cfg.dtype` at every
use, and the cast rounds to nearest even in both packages, so holding the
cast computes the same values at half the memory.

Forward modes:
  * `forward(cfg, params, tokens)`           — full-sequence logits,
  * `lm_steps.make_prefill_step(cfg)`        — last logits + KV cache,
  * `decode_step(cfg, params, cache, token)` — single-token serve step.

Training (`lm_loss`, remat, chunked loss) comes with the training slice;
`shard_hints` (GSPMD sharding constraints) with the sharding slice: a
config that sets it is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

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
    # training-only in the reference (remat policy, XLA scan unrolling,
    # chunked cross-entropy, flash-block remat): kept so that configs
    # compare field by field; serving reads none of them
    remat: str = "nothing_saveable"     # 'none' | 'nothing_saveable' | 'dots'
    moe_group_size: int = 1024
    unroll_scans: bool = False
    loss_chunk: int = 0
    # GSPMD activation sharding constraints in the reference; the port
    # refuses a config that sets them (see check_supported)
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


def check_supported(cfg: TransformerConfig) -> None:
    """Refuse what the port does not run yet."""
    if cfg.shard_hints is not None:
        raise ValueError(
            f"{cfg.name}: shard_hints {cfg.shard_hints!r} are GSPMD sharding "
            "constraints, which have no torch form; sharded serving comes "
            "with the port's sharding slice (repro_torch.sharding). Use "
            "dataclasses.replace(cfg, shard_hints=None)")


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _weight(t: torch.Tensor) -> nn.Parameter:
    # serving weights; the training slice turns gradients on
    return nn.Parameter(t, requires_grad=False)


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
        check_supported(cfg)
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


def init_params(cfg: TransformerConfig, generator: torch.Generator
                ) -> Transformer:
    """Random weights on the generator's device. Each matrix is drawn in
    float32 and cast to cfg.dtype before the next is drawn, so the peak
    memory is the model's plus one float32 matrix.

    Scales are the reference's. It draws each stacked (n_layers, ...) leaf
    with `dense_init`, whose fan-in is the first dim, so the leaves without
    an explicit scale (wq, wk, wv, and the dense w_in, w_gate) are
    N(0, 1/n_layers); the others are as written below."""
    check_supported(cfg)
    dt = compute_dtype(cfg)
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
    """'bsd,dhk->bshk': x (B, S, D) by w (D, H, k) in x's type."""
    b, s, _ = x.shape
    return (x @ w.to(x.dtype).flatten(1)).view(b, s, *w.shape[1:])


def _out_proj(a: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """'bshk,hkd->bsd'."""
    b, s = a.shape[:2]
    return a.reshape(b, s, -1) @ wo.to(a.dtype).flatten(0, 1)


def rotary_dims(cfg: TransformerConfig) -> int:
    """The head dims the position rotates. ChatGLM 2-D RoPE: two position
    channels drive the two halves of the rotary dims; causal LM uses
    (pos, 0) channels, and the second channel's rotation by 0 is the
    identity, so only the first half turns."""
    d_rot = int(cfg.d_head * cfg.rotary_pct)
    return d_rot // 2 if cfg.rope_style == "2d" else d_rot


def rope_inv_freq(cfg: TransformerConfig, device=None) -> torch.Tensor:
    return L.rope_freqs(cfg.d_head, cfg.rope_theta, rotary_dims(cfg), device)


def _qkv(cfg: TransformerConfig, lp: Layer, x: torch.Tensor,
         positions: torch.Tensor, inv_freq: torch.Tensor):
    """Normed, projected, qk-normed and rotated q (B, S, H, hd) and k, v
    (B, S, KV, hd) of x (B, S, D) at `positions` (B, S)."""
    h = L.rms_norm(x, lp.ln_attn, cfg.norm_eps)
    q, k, v = _proj(h, lp.wq), _proj(h, lp.wk), _proj(h, lp.wv)
    if cfg.qk_norm:
        q = L.rms_norm(q, lp.q_norm, cfg.norm_eps)
        k = L.rms_norm(k, lp.k_norm, cfg.norm_eps)
    d_rot = rotary_dims(cfg)
    return (L.apply_rope(q, positions, inv_freq, d_rot),
            L.apply_rope(k, positions, inv_freq, d_rot), v)


def takes_flash(cfg: TransformerConfig, s: int, *, cache_kv=None,
                q_offset: int = 0, valid_kv=None) -> bool:
    """Whether `_attention` over s queries runs on the flash kernel: causal
    self-attention of the whole sequence from position 0 (no cache, no
    validity mask, q_offset 0: the kernel's causal mask is top-left
    aligned with Sq == Sk) within the sliding window if there is one."""
    return (cache_kv is None and valid_kv is None and q_offset == 0
            and (cfg.sliding_window is None or s <= cfg.sliding_window))


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
    if takes_flash(cfg, x.shape[1], cache_kv=cache_kv, q_offset=q_offset,
                   valid_kv=valid_kv):
        out = flash.mha(q, k_exp, v_exp, causal=True)
    else:
        out = L.blockwise_attention(
            q, k_exp, v_exp, causal=cache_kv is None, q_offset=q_offset,
            window=cfg.sliding_window, valid_kv=valid_kv, kv_block=kv_block)
    return _out_proj(out, lp.wo), (k, v)


def _ffn(cfg: TransformerConfig, lp: Layer, x: torch.Tensor):
    h = L.rms_norm(x, lp.ln_ffn, cfg.norm_eps)
    if cfg.is_moe:
        return L.moe_ffn(h, lp.router, lp.w_in, lp.w_gate, lp.w_out,
                         top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                         group_size=cfg.moe_group_size, act=cfg.act)
    return L.glu_ffn(h, lp.w_in, lp.w_gate, lp.w_out, cfg.act), 0.0


def _layer(cfg: TransformerConfig, lp: Layer, x: torch.Tensor,
           positions: torch.Tensor, **kw):
    a, kv = _attention(cfg, lp, x, positions, **kw)
    x = x + a
    f, aux = _ffn(cfg, lp, x)
    return x + f, aux, kv


def embed_tokens(cfg: TransformerConfig, params: Transformer,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens.long()].to(compute_dtype(cfg))


def positions_of(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


# ---------------------------------------------------------------------------
# Forward modes
# ---------------------------------------------------------------------------

def forward(cfg: TransformerConfig, params: Transformer, tokens: torch.Tensor):
    """tokens: (B, S) -> (logits (B, S, V) float32, aux_loss)."""
    check_supported(cfg)
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = positions_of(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        x, aux_l, _ = _layer(cfg, lp, x, positions, inv_freq=params.inv_freq)
        aux = aux + aux_l
    x = L.rms_norm(x, params.ln_final, cfg.norm_eps)
    logits = x @ params.head().to(x.dtype)
    return logits.float(), aux / cfg.n_layers


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


@torch.no_grad()
def decode_step(cfg: TransformerConfig, params: Transformer, cache: dict,
                token: torch.Tensor):
    """token: (B, 1) int. Returns (logits (B, 1, V) float32, cache).

    The cache position `cache["pos"]` (an int) is the number of tokens
    already inside. The new token's k, v are written into the cache's
    tensors in place (slot `pos`, or `pos % cache_len` for a rolling SWA
    cache; a full non-rolling cache keeps writing its last slot, as the
    reference's clamped update does), then each layer attends over the
    filled slots with the plain `blockwise_attention`; the returned cache
    holds the same tensors and pos + 1."""
    check_supported(cfg)
    b = token.shape[0]
    c = cache["k"].shape[2]
    pos = int(cache["pos"])
    x = embed_tokens(cfg, params, token)
    dev = x.device
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    slot = pos % c if cfg.sliding_window is not None else min(pos, c - 1)
    n_filled = min(pos + 1, c)
    valid = (torch.arange(c, device=dev) < n_filled)[None, :].expand(b, c)
    # rolling buffer: every filled slot is within the window by
    # construction; position masking is handled by validity
    kv_block = 2048 if cfg.sliding_window is None else min(2048, c)
    for i, lp in enumerate(params.layers):
        q, k, v = _qkv(cfg, lp, x, positions, params.inv_freq)
        k_l, v_l = cache["k"][i], cache["v"][i]
        k_l[:, slot] = k[:, 0].to(k_l.dtype)
        v_l[:, slot] = v[:, 0].to(v_l.dtype)
        out = L.blockwise_attention(
            q, L.repeat_kv(k_l, cfg.q_per_kv), L.repeat_kv(v_l, cfg.q_per_kv),
            causal=False, valid_kv=valid, kv_block=kv_block)
        x = x + _out_proj(out, lp.wo)
        f, _ = _ffn(cfg, lp, x)
        x = x + f
    x = L.rms_norm(x, params.ln_final, cfg.norm_eps)
    logits = x @ params.head().to(x.dtype)
    return logits.float(), dict(k=cache["k"], v=cache["v"], pos=pos + 1)
