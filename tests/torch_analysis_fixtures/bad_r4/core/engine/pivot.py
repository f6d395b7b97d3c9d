"""A helper of the step: the taint follows the call."""
import torch


def branch(cfg, ctx, stack, live):
    while bool(live.any()):  # EXPECT-R4
        live = live & False
    if cfg.revised:
        return stack[0]
    return stack[0].cpu()  # EXPECT-R4
