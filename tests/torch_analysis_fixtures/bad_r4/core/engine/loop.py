"""A DFS step that reads the device back to the host."""
import numpy as np
import torch

from bad_r4.core.engine import pivot
from bad_r4.kernels.bits import ops


def dfs_step(cfg, ctx, depth, stack, carry, live):
    if live.any():  # EXPECT-R4
        depth = depth - 1
    n = int(live.sum())  # EXPECT-R4
    top = depth.max().item()  # EXPECT-R4
    rows = stack[0].tolist()  # EXPECT-R4
    words = np.asarray(stack[1])  # EXPECT-R4
    step = 1 if carry["calls"].sum() > 0 else 0  # EXPECT-R4
    b = pivot.branch(cfg, ctx, stack, live)
    out = ops.popcount(b)
    return depth + step + n + top, rows, words, out
