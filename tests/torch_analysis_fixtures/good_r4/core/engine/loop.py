"""A DFS step that reads nothing back: shapes, static config and Python
values only."""
import torch

from good_r4.core.engine import pivot
from good_r4.kernels.bits import ops

LIVE_CHECK_EVERY = 64


def dfs_step(cfg, ctx, depth, stack, carry, live, w=None):
    r = depth.shape[0]
    given = () if w is None else (w,)
    if given:
        depth = depth + 0
    if cfg.dynamic_red and r > 1 and live.dim() == 1:
        depth = torch.where(live, depth - 1, depth)
    b = pivot.branch(cfg, ctx, stack, live, revised=cfg.backend == "revised")
    out = ops.popcount(b)
    return torch.where(live, depth, depth + 1), out


def run(cfg, ctx, depth, stack, carry):
    """Outside the roots: the live check reads the device every 64 steps,
    by design."""
    steps = 0
    while True:
        live = depth >= 0
        if steps % LIVE_CHECK_EVERY == 0 and not bool(live.any()):
            break
        depth, _ = dfs_step(cfg, ctx, depth, stack, carry, live)
        steps += 1
    return depth
