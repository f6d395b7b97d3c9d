"""Declarations that agree with the C prototypes."""
import ctypes
from pathlib import Path

from good_r3.kernels._build import CudaLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "bag.cu"
_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_TAIL = [_i, _i, _p]
LIBRARY = CudaLibrary(SOURCE, {
    "bag_sum": [_p, _p, _p, _ll] + _TAIL,
    "bag_scale": [_p, _ll, _f, _p],
    "bag_mean": [_p] * 3 + [_ll] + _TAIL,
})
