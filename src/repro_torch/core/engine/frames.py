"""Frame & stack layout for the bitset BK engine (DESIGN.md §2.3).

A BK call is a fixed-shape *frame* of bitsets over the root's local
universe; the explicit DFS stack is one pre-allocated buffer per frame
field, depth-indexed. Everything here is shape/layout plumbing — the
search semantics live in `reductions`, `pivot`, and `loop`.

Unlike the reference, which writes one root and lets `jax.vmap` add the
root batch, every tensor here carries the bucket's root batch R as its
leading axis: a bitset is (R, W) int32 words, a row matrix (R, K, W), a
per-vertex vector (R, K). Words hold the reference's uint32 bit patterns
(see `kernels.bitset_ops.ref`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.bitset_ops import ops as bitops

WORD = 32


# ===========================================================================
# Small bitset helpers (device) — index/layout glue; all popcount/AND set
# algebra over row matrices goes through repro_torch.kernels.bitset_ops.ops.
# ===========================================================================

@functools.lru_cache(maxsize=64)
def _bit_layout(u: int, device: torch.device):
    """(word index, in-word shift) of bits 0..u-1, and the 32 one-hot word
    values (bit 31 is INT_MIN) — constants cached per size and device."""
    idx = torch.arange(u, device=device)
    onehot = torch.from_numpy(
        (np.uint32(1) << np.arange(WORD, dtype=np.uint32)).view(np.int32))
    return (idx // WORD, (idx % WORD).to(torch.int32), onehot.to(device))


def popcount(bits):
    return bitops.popcount_words(bits)


def any_bit(bits):
    return (bits != 0).any(-1)


def first_bit_index(bits):
    """Index of the lowest set bit of each (..., W) bitset, int64.

    An all-zero bitset gives 32 (word 0, position 32), as in the
    reference: callers that gather with it clamp first (torch raises on an
    out-of-range index where jax clamps silently)."""
    w = (bits != 0).to(torch.int32).argmax(-1)
    word = bits.gather(-1, w.unsqueeze(-1)).squeeze(-1)
    pos = bitops.popcount((word & -word) - 1)
    return w * WORD + pos


def bitset_to_mask(bits, u):
    """(..., W) bitsets -> (..., u) bool membership masks."""
    word_idx, shift, _ = _bit_layout(u, bits.device)
    return ((bits[..., word_idx] >> shift) & 1) != 0


def eye_bits(u, words, device=None):
    """(U, W) constant: EYE[i] = bitset with only bit i."""
    idx = np.arange(u)
    col = np.arange(words)
    eye = np.where(col[None, :] == (idx[:, None] // WORD),
                   np.uint32(1) << (idx[:, None] % WORD).astype(np.uint32),
                   np.uint32(0)).astype(np.uint32)
    return torch.from_numpy(eye.view(np.int32)).to(device)


def mask_to_bitset(mask, words):
    """(..., K) bool -> (..., words) bitsets (bit k set iff mask[k]).

    The bits are disjoint, so the OR over them is their wrapping int32
    sum: one multiply-and-sum instead of the reference's OR reduction over
    one-hot rows. K is a multiple of 32, or fits in one word."""
    k = mask.shape[-1]
    _, _, onehot = _bit_layout(WORD, mask.device)
    if k % WORD:
        if words != 1:
            raise ValueError(f"mask of {k} bits does not fill {words} words")
        return (mask * onehot[:k]).sum(-1, keepdim=True, dtype=torch.int32)
    m = mask.reshape(mask.shape[:-1] + (k // WORD, WORD))
    return (m * onehot).sum(-1, dtype=torch.int32)


def _or_fold(x):
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


def or_reduce(rows, sel):
    """OR of the rows selected by sel: (..., K, W), (..., K) -> (..., W)."""
    return _or_fold(rows * sel.unsqueeze(-1))


def and_reduce(rows, sel):
    """AND of the selected rows (all-ones when none is selected), by De
    Morgan over the same fold."""
    return ~_or_fold(~rows * sel.unsqueeze(-1))


def single_bit_index_rows(rows):
    """(..., K, W) -> (..., K): lowest set bit of each row's first nonzero
    word (the bit's index when the row has exactly one)."""
    word_idx = (rows != 0).to(torch.int32).argmax(-1)
    word = rows.gather(-1, word_idx.unsqueeze(-1)).squeeze(-1)
    pos = bitops.popcount((word & -word) - 1)
    return word_idx * WORD + pos


# ===========================================================================
# Engine configuration
# ===========================================================================

BACKENDS = ("pivot", "rcd", "revised", "hybrid")
# What this port runs so far; 'rcd' and 'hybrid' wait for ROADMAP Queue 1
# item 5.
PORTED_BACKENDS = ("pivot", "revised")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    dynamic_red: bool = True
    backend: str = "pivot"          # one of PORTED_BACKENDS
    out_cap: int = 0                # >0: enumerate into a fixed buffer
    max_iters: int = 1 << 30


# ===========================================================================
# Per-bucket constant context + per-call frame + DFS stack
# ===========================================================================

class RootContext(NamedTuple):
    """Per-bucket constants threaded through the DFS (never stacked)."""
    A: torch.Tensor          # (R, U, W) induced adjacency bitsets
    x_rows: torch.Tensor     # (R, XC, W) X0 row bitsets
    not_x_rows: torch.Tensor  # (R, XC, W) ~x_rows, hoisted out of the loop
    eye: torch.Tensor        # (U, W) one-hot bitsets over the universe
    ar: torch.Tensor         # (R,) root index, for per-root gathers

    @property
    def u(self) -> int:
        return self.A.shape[1]

    @property
    def words(self) -> int:
        return self.A.shape[2]

    @property
    def xc(self) -> int:
        return self.x_rows.shape[1]

    @property
    def xc_words(self) -> int:
        return max(-(-self.xc // WORD), 1)


def make_context(a, x_rows) -> RootContext:
    # ~x_rows is the same on every step (the Lemma-8 X-subset test); eager
    # torch would not hoist it, and it is the bucket's largest tensor
    return RootContext(A=a, x_rows=x_rows, not_x_rows=~x_rows,
                       eye=eye_bits(a.shape[1], a.shape[2], a.device),
                       ar=torch.arange(a.shape[0], device=a.device))


class Frame(NamedTuple):
    """One BK call per root: (R, P, X) in bitset form plus the branch set."""
    P: torch.Tensor          # (R, W)  candidate bitset
    B: torch.Tensor          # (R, W)  branch set (pivot-pruned P)
    Xp: torch.Tensor         # (R, W)  universe members moved into X
    Rb: torch.Tensor         # (R, W)  universe additions to the base clique
    rsz: torch.Tensor        # (R,)    |R| including the host-side base
    xal: torch.Tensor        # (R, XCW) packed alive mask over X0 rows


class FrameStack(NamedTuple):
    """Depth-indexed DFS stack per root: one buffer per Frame field,
    (R, D, ...). Writes are in place (the reference's functional updates
    give the same values; nothing keeps an older stack)."""
    P: torch.Tensor          # (R, D, W)
    B: torch.Tensor          # (R, D, W)
    Xp: torch.Tensor         # (R, D, W)
    Rb: torch.Tensor         # (R, D, W)
    rsz: torch.Tensor        # (R, D)
    xal: torch.Tensor        # (R, D, XCW)

    @staticmethod
    def alloc(roots: int, depth: int, words: int, xc_words: int,
              device) -> "FrameStack":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)
        return FrameStack(P=z(roots, depth, words), B=z(roots, depth, words),
                          Xp=z(roots, depth, words), Rb=z(roots, depth, words),
                          rsz=z(roots, depth),
                          xal=z(roots, depth, xc_words))

    def read(self, ar, d) -> Frame:
        """Frame of root ar[i] at depth d[i]."""
        return Frame(P=self.P[ar, d], B=self.B[ar, d], Xp=self.Xp[ar, d],
                     Rb=self.Rb[ar, d], rsz=self.rsz[ar, d],
                     xal=self.xal[ar, d])

    def write(self, ar, d, **fields) -> "FrameStack":
        """Write a subset of frame fields at per-root depth d (others
        untouched, so pop-path-dead slots need no extra stores)."""
        for k, v in fields.items():
            getattr(self, k)[ar, d] = v
        return self

    def push(self, ar, d, frame: Frame) -> "FrameStack":
        return self.write(ar, d, **frame._asdict())


# ===========================================================================
# Counter/enumeration carry
# ===========================================================================

def carry_init(cfg: EngineConfig, roots: int, words: int, device):
    """Per-root counters (R,) int32 and, when enumerating, per-root
    clique buffers with one spare row at index out_cap that absorbs the
    writes the reference drops (`mode="drop"`); it is sliced off at the
    end."""
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)
    carry = dict(cliques=z(roots), calls=z(roots), branches=z(roots),
                 sum_px=z(roots))
    if cfg.out_cap:
        cap = cfg.out_cap
        carry.update(out_rows=z(roots, cap + 1, words),
                     out_sizes=z(roots, cap + 1), out_n=z(roots),
                     overflow=z(roots, dtype=torch.bool))
    return carry


def report_single(carry, cfg, bits, size, enable):
    """Count (and, enumerating, append) one clique per root where enabled.
    bits (R, W), size (R,), enable (R,) bool."""
    cnt = enable.to(torch.int32)
    carry["cliques"] = carry["cliques"] + cnt
    if cfg.out_cap:
        cap = cfg.out_cap
        out_n = carry["out_n"]
        pos = torch.where(enable & (out_n < cap), out_n, cap).long()
        ar = torch.arange(bits.shape[0], device=bits.device)
        carry["out_rows"][ar, pos] = bits
        carry["out_sizes"][ar, pos] = size
        carry["overflow"] = carry["overflow"] | (enable & (out_n >= cap))
        carry["out_n"] = torch.clamp(out_n + cnt, max=cap)
    return carry


def report_multi(carry, cfg, rows, sizes, mask):
    """Count (and, enumerating, append) the masked rows of each root.
    rows (R, K, W) (may be None when not enumerating), sizes (R, K),
    mask (R, K) bool."""
    cnt = mask.sum(-1, dtype=torch.int32)
    carry["cliques"] = carry["cliques"] + cnt
    if cfg.out_cap:
        cap = cfg.out_cap
        out_n = carry["out_n"]
        offs = (out_n.unsqueeze(-1)
                + mask.to(torch.int32).cumsum(-1, dtype=torch.int32) - 1)
        pos = torch.where(mask & (offs < cap), offs, cap).long()
        ar = torch.arange(rows.shape[0], device=rows.device).unsqueeze(-1)
        # every dropped row lands in the spare row `cap`; which of them
        # wins there does not matter
        carry["out_rows"][ar, pos] = rows
        carry["out_sizes"][ar, pos] = sizes
        carry["overflow"] = (carry["overflow"]
                             | (mask & (offs >= cap)).any(-1))
        carry["out_n"] = torch.clamp(out_n + cnt, max=cap)
    return carry
