"""Synthetic LM token stream: deterministic, Zipf-distributed, seekable.

A production data pipeline is a seekable shard reader; here the "shards" are
PRNG streams. Determinism contract: batch(step) depends only on
(seed, step, global_batch, seq_len), and equals the reference's
`repro.data.tokens.TokenStream` bit for bit (the same numpy draws).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens, targets): (B, S) int32 each; targets shift by 1."""
        rng = np.random.default_rng((self.seed, step))
        # Zipf body + uniform tail mixture, clipped into vocab
        z = rng.zipf(self.zipf_a, size=(self.global_batch, self.seq_len + 1))
        u = rng.integers(0, self.vocab, size=z.shape)
        pick = rng.random(z.shape) < 0.9
        toks = np.where(pick, np.minimum(z - 1, self.vocab - 1), u)
        return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def synth_tokens(vocab: int, batch: int, seq: int, seed: int = 0) -> np.ndarray:
    return TokenStream(vocab, seq, batch, seed).batch(0)[0]
