"""Build and load the bitset kernels' shared library (nvcc + ctypes).

`csrc/bitset_ops.cu` has a plain C interface, so it compiles in seconds
with nvcc alone (no PyTorch headers) into `build/repro_torch/` at the root
of the checkout, named by a hash of the source and flags: an edited source
builds anew, an unchanged one loads the library already there. The build
happens at first use, never at import. Without nvcc it raises; nothing
falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitset_ops.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # nvcc wall time of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda"
                       "/bin): the bitset CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbitset_ops_{digest}.so"


def build() -> Path:
    """Compile the library unless this exact source is already built."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)     # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The loaded library with every entry point's signature declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bitset_and_popcount_rows.argtypes = [p, p, p, ll, i, i, p]
    lib.bitset_and_popcount_argmax.argtypes = [p, p, p, p, p, ll, i, i, p]
    lib.bitset_frame_step.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, p]
    for fn in (lib.bitset_and_popcount_rows, lib.bitset_and_popcount_argmax,
               lib.bitset_frame_step):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
