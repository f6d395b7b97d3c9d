"""An entry point that checks shapes and launches, reading nothing."""
import torch


def popcount(bits):
    if bits.dim() != 2 or bits.numel() == 0:
        raise ValueError("popcount: (R, W) words")
    return bits.sum(-1)
