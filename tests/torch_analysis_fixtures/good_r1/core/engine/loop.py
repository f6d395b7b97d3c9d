"""The engine reaches the kernel through `ops` only."""
from good_r1.kernels.bag import ops


def step(x):
    return ops.bag(x)
