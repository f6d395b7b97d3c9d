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

def popcount(bits):
    return bitops.popcount_words(bits)


def any_bit(bits):
    return (bits != 0).any(-1)


# (..., W) bitsets -> (...,) index of the lowest set bit (32 when empty)
first_bit_index = bitops.first_bit_index


# (..., W) bitsets -> (..., u) bool membership masks
bitset_to_mask = bitops.bits_to_mask


@functools.lru_cache(maxsize=64)
def _eye_bits(u: int, words: int, device) -> torch.Tensor:
    idx = np.arange(u)
    col = np.arange(words)
    eye = np.where(col[None, :] == (idx[:, None] // WORD),
                   np.uint32(1) << (idx[:, None] % WORD).astype(np.uint32),
                   np.uint32(0)).astype(np.uint32)
    return torch.from_numpy(eye.view(np.int32)).to(device)


def eye_bits(u, words, device=None):
    """(U, W) constant: EYE[i] = bitset with only bit i. Cached per size
    and device; callers must not write to it."""
    return _eye_bits(u, words, torch.device(device or "cpu"))


# (..., K) bool masks -> (..., words) bitsets, and the OR / AND of the
# selected rows of (..., K, W) row matrices
mask_to_bitset = bitops.mask_to_bits
or_reduce = bitops.or_reduce
and_reduce = bitops.and_reduce


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
# Backends that precompute a branch set B at call entry ('rcd' re-selects
# per visit instead, so it carries nothing a steal could split); 'hybrid'
# is pivot-family with a per-node vertex-branching override plus early
# termination (DESIGN.md §2.7).
PIVOT_BACKENDS = ("pivot", "revised", "hybrid")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    dynamic_red: bool = True
    backend: str = "pivot"          # one of BACKENDS
    out_cap: int = 0                # >0: enumerate into a fixed buffer
    max_iters: int = 1 << 30
    # Reuse the post-reduction degree vector for pivot scoring via
    # deg_P''(u) = deg_P'(u) − |full| (full vertices neighbor all of P'),
    # and the frame step's degrees when reduction is off: one AND+popcount
    # sweep over A fewer per call. False: `pivot_select` sweeps A itself.
    reuse_degrees: bool = True
    # 'hybrid' branch selection: switch from pivot- to vertex-branching
    # (B = P) when the induced density 2|E[P]| / (|P|·(|P|−1)) reaches this
    # threshold — near-clique nodes early-terminate in their children, so
    # the pivot sweep's pruning buys nothing there (DESIGN.md §2.7).
    hybrid_density: float = bitops.HYBRID_DENSITY
    # Persistent-engine lane work stealing (DESIGN.md §2.6 STEAL): when the
    # root queue is drained and a lane idles, it adopts half of a live
    # lane's shallowest splittable branch set. Pure scheduling — counters
    # and enumerated sets are bit-identical either way.
    steal: bool = True
    # Steal victim policy: 'branchiest' picks the lane whose donation slot
    # has the largest remaining branch set, 'deepest' the deepest lane.
    steal_victim: str = "branchiest"
    # Stack windowing: >0 walks up to K frame-steps per trip over a
    # window of stack frames. Eligible configs (pivot backend, dynamic
    # reduction off, counting only) use the fused `dfs_step_window`
    # kernels; other persistent configs window the ordinary dfs_step.
    # 0 = off. Pure scheduling — counters/sets bit-identical.
    window_steps: int = 0
    # Engine-step window depth in frames. 0 = auto: the kernel path uses
    # `bitset_ops.ops.WINDOW_FRAMES`, the engine-step path the full stack
    # (no re-centering, no boundary stops). A kernel-eligible config stays
    # kernel-eligible only at 0 or WINDOW_FRAMES.
    window_frames: int = 0


# ===========================================================================
# Per-bucket constant context + per-call frame + DFS stack
# ===========================================================================

class RootContext(NamedTuple):
    """Per-bucket constants threaded through the DFS (never stacked)."""
    A: torch.Tensor          # (R, U, W) induced adjacency bitsets
    x_rows: torch.Tensor     # (R, XC, W) X0 row bitsets
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
    # Every kernel entry point reads A and x_rows as they are: the context
    # holds no derived rows ('rcd's maximality test takes its complement
    # in the kernel).
    return RootContext(
        A=a, x_rows=x_rows,
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

    def window(self, base, size: int) -> "FrameStack":
        """Per-root copy of `size` consecutive slots from slot base[i]:
        (R, size, ...) buffers (the reference's vmapped
        dynamic_slice_in_dim; callers keep base within [0, D - size])."""
        return FrameStack(*(slot_window(f, base, size) for f in self))

    def put_window(self, base, win: "FrameStack") -> "FrameStack":
        """Write a `window` back at the same per-root base, in place."""
        for f, w in zip(self, win):
            put_slot_window(f, base, w)
        return self


def slot_window(buf, base, size: int):
    """(R, size, ...) copy of `size` consecutive slots of an (R, D, ...)
    buffer from slot base[i] of root i."""
    return buf.gather(1, _window_index(base, size, buf))


def put_slot_window(buf, base, win):
    """Write a `slot_window` back at the same per-root base, in place."""
    buf.scatter_(1, _window_index(base, win.shape[1], buf), win)
    return buf


def _window_index(base, size, buf):
    idx = base.long().unsqueeze(-1) + torch.arange(size, device=base.device)
    if buf.dim() == 2:
        return idx
    return idx.unsqueeze(-1).expand(-1, -1, buf.shape[2])


# ===========================================================================
# Counter/enumeration carry
# ===========================================================================

def carry_init(cfg: EngineConfig, roots: int, words: int, device,
               track_root: bool = False):
    """Per-root counters (R,) int32 and, when enumerating, per-root
    clique buffers with one spare row at index out_cap that absorbs the
    writes the reference drops (`mode="drop"`); it is sliced off at the
    end.

    `track_root` (persistent lanes, which interleave roots): every
    enumerated clique also records `cur_root`, the queue slot the lane
    is walking, in `out_root`."""
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)
    carry = dict(cliques=z(roots), calls=z(roots), branches=z(roots),
                 sum_px=z(roots))
    if cfg.out_cap:
        cap = cfg.out_cap
        carry.update(out_rows=z(roots, cap + 1, words),
                     out_sizes=z(roots, cap + 1), out_n=z(roots),
                     overflow=z(roots, dtype=torch.bool))
        if track_root:
            carry.update(cur_root=z(roots), out_root=z(roots, cap + 1))
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
        if "out_root" in carry:
            carry["out_root"][ar, pos] = carry["cur_root"]
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
        if "out_root" in carry:
            carry["out_root"][ar, pos] = carry["cur_root"].unsqueeze(-1) \
                .expand_as(pos)
        carry["overflow"] = (carry["overflow"]
                             | (mask & (offs >= cap)).any(-1))
        carry["out_n"] = torch.clamp(out_n + cnt, max=cap)
    return carry
