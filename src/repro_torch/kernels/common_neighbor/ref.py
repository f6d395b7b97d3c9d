"""Plain PyTorch version: common-neighbour existence per edge.

Given pre-gathered padded adjacency rows for both endpoints of each edge
(`adj_u`, `adj_v`: (E, D) int32, padded with -1), decide whether the two
endpoints share any real common neighbour. This is the inner test of the
paper's non-triangle edge reduction (§4.3, Lemma 4): edges with no common
neighbour are maximal 2-cliques and are deleted.
"""
from __future__ import annotations

import torch

# Edges per slice of the all-pairs formula are cut so that one slice's
# (edges, D, D) temporaries hold at most this many elements: at the
# Graph500 scale-12 width (D = 1,336) the whole (E, D, D) would be 87 GB.
PAIRS_PER_SLICE = 1 << 27


def has_common_neighbor(adj_u: torch.Tensor,
                        adj_v: torch.Tensor) -> torch.Tensor:
    """(E, D) x (E, D) -> (E,) bool. Padding entries must be -1."""
    e, d = adj_u.shape
    step = max(1, PAIRS_PER_SLICE // max(d * d, 1))
    out = [torch.zeros(0, dtype=torch.bool, device=adj_u.device)]
    for s in range(0, e, step):
        au, av = adj_u[s:s + step], adj_v[s:s + step]
        eq = au[:, :, None] == av[:, None, :]
        valid = (au[:, :, None] >= 0) & (av[:, None, :] >= 0)
        out.append((eq & valid).flatten(1).any(1))
    return torch.cat(out)
