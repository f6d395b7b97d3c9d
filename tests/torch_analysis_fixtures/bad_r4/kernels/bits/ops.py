"""An entry point that synchronises the device."""
import torch


def popcount(bits):
    out = bits.sum(-1)
    torch.cuda.synchronize()  # EXPECT-R4
    return out
