"""Plain PyTorch versions of the bitset AND+popcount kernels.

Bitsets keep the reference package's layout: W words of 32 bits per row,
bit i of a row in word i // 32 at position i % 32. The words are stored
as `torch.int32` and read bit for bit as unsigned (torch's `uint32` lacks
`~`, shifts, add/sub, `max` and `index_put`). With int32 storage `>>` is
arithmetic, so every shift that extracts bits masks after shifting, and
`1 << 31` is the bit pattern of INT_MIN.

Every function takes explicit leading batch dims (the engine passes the
bucket's root batch first: rows (R, K, W), masks (R, W)). These are the
CPU path of `ops` and the oracle the CUDA kernels are held against.
The word-level helpers they share with the engine live in `words`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.bitset_ops.words import (WORD, and_rows,  # noqa: F401
                                                  popcount, popcount_words)


def and_popcount_rows(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """popcount(rows & mask) reduced over the word axis.

    rows: (..., K, W) int32, mask: (..., W) int32 -> (..., K) int32. This
    is `|N(u) ∩ P|` for every u at once."""
    return popcount_words(rows & mask.unsqueeze(-2))


def and_popcount_argmax(rows: torch.Tensor, mask: torch.Tensor,
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused pivot-select: argmax over popcount(rows & mask) scores.

    rows: (..., K, W) int32, mask: (..., W) int32, valid: (..., K) bool.
    Returns (idx, best), both (...,) int32: the index of the first
    best-scoring row and its score. Invalid rows score -1, so an
    all-invalid batch row gives (0, -1). torch.argmax returns the first
    maximal index, as jnp.argmax does."""
    scores = and_popcount_rows(rows, mask)
    if valid is not None:
        scores = torch.where(valid, scores, -1)
    idx = scores.argmax(-1)
    best = scores.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    return idx.to(torch.int32), best


def frame_step(rows: torch.Tensor, p: torch.Tensor, xp: torch.Tensor,
               wrow: torch.Tensor):
    """Fused BK frame step: child-set construction + degree/partner sweep.

    rows: (..., K, W) int32 adjacency, p/xp/wrow: (..., W) int32.
    Returns (childp, childxp, deg, partner):
      childp  = p  & wrow                      (..., W)  child candidate set
      childxp = xp & wrow                      (..., W)  child forbidden set
      deg[k]  = popcount(rows[k] & childp)     (..., K)  child degree vector
      partner[k] = Σ_words (32·w + lowest-set-bit-pos) over nonzero words of
      rows[k] & childp — the exact bit index when deg[k] == 1 (the Lemma-7
      partner), deterministic garbage otherwise.
    """
    childp = p & wrow
    childxp = xp & wrow
    anded = rows & childp.unsqueeze(-2)
    deg = popcount_words(anded)
    pos = popcount((anded & -anded) - 1)
    wi = WORD * torch.arange(anded.shape[-1], dtype=torch.int32,
                             device=rows.device)
    partner = torch.where(anded != 0, wi + pos, 0).sum(-1, dtype=torch.int32)
    return childp, childxp, deg, partner
