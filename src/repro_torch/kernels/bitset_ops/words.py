"""Word-level bitset helpers in plain PyTorch, on every device.

These have no kernel behind them in either package (the reference runs
them as plain jnp on every backend): an elementwise SWAR popcount, its
sum over the word axis, the lowest set bit, the broadcast AND of rows
with a mask, the unpacking of bitsets to bool masks and the packing
back, and the OR and AND of selected rows. Words are int32 holding the reference's uint32 bit
patterns (see `ref`).
"""
from __future__ import annotations

import functools

import numpy as np
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


def first_bit_index(bits: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit of each (..., W) bitset, int64. An
    all-zero bitset gives 32 (word 0, position 32), as in the reference:
    callers that gather with it clamp first (torch raises on an
    out-of-range index where jax clamps silently)."""
    w = (bits != 0).to(torch.int32).argmax(-1)
    word = bits.gather(-1, w.unsqueeze(-1)).squeeze(-1)
    return w * WORD + popcount((word & -word) - 1)


def and_rows(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """rows & mask broadcast over the row axis (materialised intersection)."""
    return rows & mask.unsqueeze(-2)


@functools.lru_cache(maxsize=64)
def _mask_layout(n: int, device: torch.device):
    """(word index, in-word shift) of bits 0..n-1, cached per size and
    device."""
    idx = torch.arange(n, device=device)
    return idx // WORD, (idx % WORD).to(torch.int32)


def bits_to_mask(bits: torch.Tensor, n: int) -> torch.Tensor:
    """(..., W) bitsets -> (..., n) bool: bit i of the words, i < n."""
    word_idx, shift = _mask_layout(n, bits.device)
    return ((bits[..., word_idx] >> shift) & 1) != 0


@functools.lru_cache(maxsize=64)
def onehot(device: torch.device) -> torch.Tensor:
    """The 32 one-hot word values (bit 31 is INT_MIN), cached per device;
    callers must not write to it."""
    return torch.from_numpy(
        (np.uint32(1) << np.arange(WORD, dtype=np.uint32)).view(np.int32)
    ).to(device)


def mask_to_bits(mask: torch.Tensor, words: int) -> torch.Tensor:
    """(..., K) bool -> (..., words) bitsets (bit k set iff mask[k]),
    K <= 32·words; the bits past K are 0.

    The bits are disjoint, so the OR over them is their wrapping int32
    sum: one multiply-and-sum instead of the reference's OR reduction over
    one-hot rows."""
    k = mask.shape[-1]
    bit = onehot(mask.device)
    if k <= WORD and words == 1:
        return (mask * bit[:k]).sum(-1, keepdim=True, dtype=torch.int32)
    if k > WORD * words:
        raise ValueError(f"mask of {k} bits does not fit {words} words")
    if k < WORD * words:
        mask = torch.nn.functional.pad(mask, (0, WORD * words - k))
    m = mask.reshape(mask.shape[:-1] + (words, WORD))
    return (m * bit).sum(-1, dtype=torch.int32)


def _or_fold(x: torch.Tensor) -> torch.Tensor:
    """OR over axis -2 by pairwise halving (log2(K) rounds); torch has no
    bitwise reduction, and unpacking to bits would cost 8x the bytes."""
    while x.shape[-2] > 1:
        k = x.shape[-2]
        h = k // 2
        y = x[..., :h, :] | x[..., h:2 * h, :]
        if k % 2:
            y[..., :1, :] |= x[..., 2 * h:, :]
        x = y
    return x.squeeze(-2)


def or_reduce(rows: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """OR of the rows selected by sel: (..., K, W), (..., K) -> (..., W)."""
    return _or_fold(rows * sel.unsqueeze(-1))


def and_reduce(rows: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """AND of the selected rows (all-ones when none is selected), by De
    Morgan over the same fold."""
    return ~_or_fold(~rows * sel.unsqueeze(-1))
