"""A helper of the step: `int()` of a Python bool, a table of static
checks."""
import torch


def branch(cfg, ctx, stack, live, revised=False):
    flag = int(revised)
    want = {"stack": (stack, torch.int32, (2,)), "live": (live, torch.bool,
                                                         (2,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or len(shape) != 1:
            raise ValueError(name)
    return stack[flag]
