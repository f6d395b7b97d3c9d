"""Step functions for LM serving: the serving half of the reference's
`repro.models.lm_steps` (the train step comes with the training slice)."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def make_prefill_step(cfg: T.TransformerConfig):
    """prefill(params, tokens) -> (last-token logits (B, V) float32, kv cache).

    Builds the cache with one full forward (the flash kernel's attention,
    `transformer._attention`), then stacks per-layer K/V into
    (n_layers, B, cache_len, KV, hd). Rolling SWA caches keep the trailing
    window."""

    @torch.no_grad()
    def prefill(params: T.Transformer, tokens: torch.Tensor):
        T.check_supported(cfg)
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
