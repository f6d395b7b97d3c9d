"""Step functions for LM training and serving: the port of the
reference's `repro.models.lm_steps`."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, apply_gradients


def make_train_step(cfg: T.TransformerConfig,
                    opt_cfg: AdamWConfig = AdamWConfig(), lr: float = 3e-4):
    """train_step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss): `lm_loss`, its backward (the flash kernel's on the card), then
    one AdamW step at `lr` that updates `params` (a `Transformer`, float32
    master weights for training) in place."""

    def train_step(params: T.Transformer, opt_state, tokens: torch.Tensor,
                   targets: torch.Tensor):
        loss = T.lm_loss(cfg, params, tokens, targets)
        opt_state = apply_gradients(params, loss, opt_state, lr, opt_cfg)
        return params, opt_state, loss.detach()

    return train_step


def make_prefill_step(cfg: T.TransformerConfig):
    """prefill(params, tokens) -> (last-token logits (B, V) float32, kv cache).

    Builds the cache with one full forward (the flash kernel's attention,
    `transformer._attention`), then stacks per-layer K/V into
    (n_layers, B, cache_len, KV, hd). Rolling SWA caches keep the trailing
    window."""

    @torch.no_grad()
    def prefill(params: T.Transformer, tokens: torch.Tensor):
        b, s = tokens.shape
        x = T.embed_tokens(cfg, params, tokens)
        positions = T.positions_of(b, s, x.device)
        c = T.cache_len(cfg, s)
        ks, vs = [], []
        for lp in params.layers:
            x, _, (k, v) = T._layer(cfg, lp, x, positions,
                                    inv_freq=params.inv_freq)
            if c != s:
                # rolling buffer layout: entry for absolute position p lives
                # in slot p % c; the last c tokens occupy the buffer
                k, v = _roll_pack(k, c), _roll_pack(v, c)
            ks.append(k)
            vs.append(v)
        x = L.rms_norm(x[:, -1], params.ln_final, cfg.norm_eps)
        logits = x @ params.head().to(x.dtype)
        return logits.float(), dict(k=torch.stack(ks), v=torch.stack(vs),
                                    pos=s)

    return prefill


def _roll_pack(k: torch.Tensor, c: int) -> torch.Tensor:
    """Keep the last c positions, placed at slot (abs_pos % c)."""
    s = k.shape[1]
    tail = k[:, s - c:]
    return torch.roll(tail, shifts=(s - c) % c, dims=1)


def make_decode_step(cfg: T.TransformerConfig):
    def decode(params: T.Transformer, cache: dict, token: torch.Tensor):
        return T.decode_step(cfg, params, cache, token)
    return decode
