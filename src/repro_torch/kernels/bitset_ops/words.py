"""Word-level bitset helpers in plain PyTorch, on every device.

These have no kernel behind them in either package (the reference runs
them as plain jnp on every backend): an elementwise SWAR popcount, its
sum over the word axis, and the broadcast AND of rows with a mask. Words
are int32 holding the reference's uint32 bit patterns (see `ref`).
"""
from __future__ import annotations

import torch

WORD = 32


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of int32 words (SWAR; exact for every pattern,
    0, 0xFFFFFFFF and 0x80000000 included)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    # the top byte of the product is the byte sum (<= 32, so >> stays
    # positive); the product wraps modulo 2^32 like the unsigned original
    return (x * 0x01010101) >> 24


def popcount_words(bits: torch.Tensor) -> torch.Tensor:
    """Total set-bit count over the trailing word axis: (..., W) -> (...)."""
    return popcount(bits).sum(-1, dtype=torch.int32)


def and_rows(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """rows & mask broadcast over the row axis (materialised intersection)."""
    return rows & mask.unsqueeze(-2)
