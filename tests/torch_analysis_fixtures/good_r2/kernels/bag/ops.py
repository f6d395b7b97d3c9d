"""Accumulated arguments handed zeros, zeroed, or zeroed in the entry."""
import ctypes
from pathlib import Path

import torch

from good_r2.kernels._build import CudaLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "bag.cu"
_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(SOURCE, {"bag_bwd": [_p, _p, _p, _i, _i, _p],
                               "bag_counts": [_p, _p, _i, _p]})


def bag_bwd(grad_out, ids, num_rows):
    b, d = grad_out.shape
    grad = torch.zeros(num_rows, d, device=grad_out.device)
    LIBRARY.load().bag_bwd(grad_out.data_ptr(), ids.data_ptr(),
                           grad.data_ptr(), b, d, 0)
    return grad


def bag_bwd_into(grad_out, ids, grad):
    grad = torch.empty_like(grad)
    grad.zero_()
    LIBRARY.load().bag_bwd(grad_out.data_ptr(), ids.data_ptr(),
                           grad.data_ptr(), *grad_out.shape, 0)
    return grad


def bag_counts(ids, num_rows):
    counts = ids.new_empty(num_rows)   # the entry point zeroes it first
    LIBRARY.load().bag_counts(ids.data_ptr(), counts.data_ptr(),
                              ids.shape[0], 0)
    return counts
