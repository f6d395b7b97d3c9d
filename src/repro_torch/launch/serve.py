"""Serving driver: batched LM decode loop + recsys scoring service.

A fixed-shape prefill and decode step, a batch of requests, KV caches as
device-resident state; for recsys, the retrieval path scores a query
against a candidate corpus shard. Both run on the CUDA card unless asked
for the CPU (`device="cpu"`, `--device cpu`); without a card they raise.
The LM prefill's attention runs on the flash kernel, the two-tower bags
on the EmbeddingBag kernel.

Usage:
  python -m repro_torch.launch.serve --arch qwen3-14b --smoke --tokens 32
  python -m repro_torch.launch.serve --arch two-tower-retrieval --smoke
  python -m repro_torch.launch.serve --arch qwen3-14b --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.engine.loop import resolve_device


def _now(dev: torch.device) -> float:
    """The host clock once the device's queued work is done."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@torch.no_grad()
def serve_lm(arch: str, smoke: bool = True, batch: int = 4,
             prompt_len: int = 16, new_tokens: int = 16,
             temperature: float = 0.0, *, device=None, seed: int = 0,
             params=None) -> Dict:
    """Prefill a batch of prompts, then greedy/temperature decode.

    Random weights from `seed` (or `params`, a `Transformer` whose config
    is served), prompts from numpy's generator at `seed`. The first token
    is the prefill's greedy pick; then each step decodes the last token
    and picks the next by argmax (the first index on ties), or, at
    `temperature > 0`, samples from softmax(logits / temperature) with a
    torch generator seeded `seed + 1` (not the reference's jax.random
    stream). prefill_s covers the prefill and the cache's move into a
    buffer sized for the whole conversation; decode_s the decode loop."""
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_steps import make_decode_step, make_prefill_step

    dev = resolve_device(device)
    spec = get_arch(arch)
    if spec.family != "lm":
        raise ValueError(f"{arch} is not an LM arch")
    if params is None:
        cfg = spec.build_smoke() if smoke else spec.build()
        params = T.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed))
    cfg = params.cfg

    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)

    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    t0 = _now(dev)
    # serve caches sized for the full conversation
    total = prompt_len + new_tokens
    logits, cache = prefill(params, torch.from_numpy(prompts).to(dev))
    # re-home the prefill cache into a total-length buffer
    full = T.init_cache(cfg, batch, total, device=dev)
    c = cache["k"].shape[2]
    full["k"][:, :, :c] = cache["k"]
    full["v"][:, :, :c] = cache["v"]
    cache = dict(k=full["k"], v=full["v"], pos=cache["pos"])
    del full
    t_prefill = _now(dev) - t0

    out_tokens: List[np.ndarray] = []
    tok = logits.argmax(dim=-1)[:, None]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t0 = _now(dev)
    for _ in range(new_tokens):
        out_tokens.append(tok[:, 0].cpu().numpy())
        logits, cache = decode(params, cache, tok)
        if temperature > 0:
            probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = logits[:, -1].argmax(dim=-1)[:, None]
    t_decode = _now(dev) - t0
    gen_tokens = np.stack(out_tokens, axis=1).astype(np.int32)
    return dict(generated=gen_tokens, prefill_s=t_prefill, decode_s=t_decode,
                tok_per_s=batch * new_tokens / max(t_decode, 1e-9))


@torch.no_grad()
def serve_recsys(smoke: bool = True, batch: int = 64,
                 n_candidates: int = 4096, top_k: int = 10, *, device=None,
                 seed: int = 0, params=None) -> Dict:
    """One retrieval query against `n_candidates` candidates (item tower
    over the corpus, dot, top-k), then one online scoring batch of `batch`
    users against 256 candidate embeddings each. Random weights from
    `seed` (or `params`, a `TwoTower` whose config is served); requests
    from numpy's generator, as the reference's. Each time covers moving
    the request to the device, the step and a sync."""
    from repro_torch.models import recsys as R

    dev = resolve_device(device)
    if params is None:
        spec = get_arch("two-tower-retrieval")
        cfg = spec.build_smoke() if smoke else spec.build()
        params = R.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed))
    cfg = params.cfg
    rng = np.random.default_rng(seed)

    retrieval = R.make_retrieval_step(cfg, top_k=top_k)
    b = R.synth_batch(cfg, 1, seed=seed, with_items=False)
    b["cand_id"] = rng.integers(0, cfg.n_items, n_candidates).astype(np.int32)
    b["cand_tags"] = rng.integers(-1, cfg.n_tags,
                                  (n_candidates, cfg.tags_len)).astype(np.int32)
    t0 = _now(dev)
    scores, idx = retrieval(params, R.to_device(b, dev))
    t_retrieval = _now(dev) - t0

    serve = R.make_serve_step(cfg)
    sb = R.synth_batch(cfg, batch, seed=seed + 1, with_items=False)
    sb["cand_emb"] = rng.normal(
        size=(batch, 256, cfg.tower_mlp[-1])).astype(np.float32)
    t0 = _now(dev)
    s = serve(params, R.to_device(sb, dev))
    t_serve = _now(dev) - t0
    return dict(top_idx=idx.cpu().numpy(), top_scores=scores.cpu().numpy(),
                serve_scores=s.cpu().numpy(), retrieval_s=t_retrieval,
                serve_s=t_serve, qps=batch / max(t_serve, 1e-9))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    # as the reference's flag: store_true with default True, so --smoke
    # cannot be turned off here; full width is serve_lm(..., smoke=False)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    spec = get_arch(args.arch)
    if spec.family == "lm":
        out = serve_lm(args.arch, smoke=args.smoke, new_tokens=args.tokens,
                       device=args.device)
        print(f"prefill {out['prefill_s']:.2f}s decode {out['decode_s']:.2f}s "
              f"({out['tok_per_s']:.1f} tok/s)")
    elif spec.family == "recsys":
        out = serve_recsys(smoke=args.smoke, device=args.device)
        print(f"retrieval {out['retrieval_s']*1e3:.1f}ms "
              f"serve {out['serve_s']*1e3:.1f}ms ({out['qps']:.0f} qps)")
    else:
        raise SystemExit(f"serving drives lm/recsys archs, got {spec.family}")


if __name__ == "__main__":
    main()
