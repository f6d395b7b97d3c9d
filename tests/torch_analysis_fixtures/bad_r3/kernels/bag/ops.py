"""Declarations that only the card would catch."""
import ctypes
from pathlib import Path

from bad_r3.kernels._build import CudaLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "bag.cu"
_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_TAIL = [_i, _i, _p]
LIBRARY = CudaLibrary(SOURCE, {
    "bag_sum": [_p, _p, _p, _ll] + [_i, _p],  # EXPECT-R3
    "bag_scale": [_p, _ll, _i, _p],  # EXPECT-R3
    "bag_mean": [_p] * 3 + [_ll] + _TAIL,
    "bag_max": [_p, _p, _p, _ll, _i, _i, _p],  # EXPECT-R3
})
