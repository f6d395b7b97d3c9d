"""The bitset kernels' shared library (`csrc/bitset_ops.cu`), built and
loaded by the port's one build helper (`repro_torch.kernels._build`) at
first use, never at import."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import CudaLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitset_ops.cu"
_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
LIBRARY = CudaLibrary(SOURCE, {
    "bitset_and_popcount_rows": [_p, _p, _p, _ll, _i, _i, _p],
    "bitset_and_popcount_argmax": [_p, _p, _p, _p, _p, _ll, _i, _i, _p],
    "bitset_frame_step": [_p, _p, _p, _p, _p, _p, _p, _p, _ll, _i, _i, _p],
    "bitset_branch_step": [_p] * 19 + [_ll] + [_i] * 5 + [_p],
    "bitset_clique_counts": [_p] * 6 + [_ll, _i, _i, _i, _p],
    "bitset_hybrid_census": [_p] * 8 + [_ll] + [_i] * 5 + [_p],
    "bitset_lemma8_reduce": [_p] * 14 + [_ll] + [_i] * 4 + [_p],
    "bitset_pivot_select": [_p] * 8 + [_ll] + [_i] * 6 + [_f, _p],
    "bitset_and_popcount_many": [_p, _p, _p, _ll, _i, _i, _i, _p],
    "bitset_rcd_dominated": [_p] * 7 + [_ll] + [_i] * 4 + [_p],
    "bitset_dfs_step_window": [_p] * 15 + [_ll] + [_i] * 10 + [_p],
    "bitset_window_lane_bytes": [_i] * 6,
})

