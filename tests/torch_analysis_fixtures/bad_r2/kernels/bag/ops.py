"""Wrappers that hand an accumulated argument a tensor with no values."""
import ctypes
from pathlib import Path

import torch

from bad_r2.kernels._build import CudaLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "bag.cu"
_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(SOURCE, {"bag_bwd": [_p, _p, _p, _i, _i, _p],
                               "bag_counts": [_p, _p, _i, _p]})


def bag_bwd(grad_out, ids, num_rows):
    b, d = grad_out.shape
    grad = torch.empty(num_rows, d, device=grad_out.device)  # EXPECT-R2
    LIBRARY.load().bag_bwd(grad_out.data_ptr(), ids.data_ptr(),
                           grad.data_ptr(), b, d, 0)
    return grad


def bag_counts(ids, num_rows):
    counts = ids.new_empty(num_rows)  # EXPECT-R2
    LIBRARY.load().bag_counts(ids.data_ptr(), counts.data_ptr(),
                              ids.shape[0], 0)
    return counts
