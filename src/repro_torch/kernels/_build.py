"""Build and load a kernel package's CUDA library (nvcc + ctypes).

Every kernel source of the port (`kernels/<name>/csrc/<name>.cu`) has a
plain C interface, so it compiles in seconds with nvcc alone (no PyTorch
headers) into `build/repro_torch/` at the root of the checkout, named by a
hash of the source and flags: an edited source builds anew, an unchanged
one loads the library already there. The build happens at first use,
never at import. Without nvcc it raises; nothing falls back to the plain
PyTorch versions.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda"
                       "/bin): the port's CUDA kernels cannot be built")


class CudaLibrary:
    """One `.cu` source's shared library: built at first use, loaded once,
    with each C entry point's argument types declared (`signatures`: name
    -> ctypes types; every entry point returns its launch's cudaError)."""

    def __init__(self, source: Path,
                 signatures: Dict[str, Sequence[type]]) -> None:
        self.source = source
        self.signatures = signatures
        self.build_dir = BUILD_DIR
        self.build_seconds: Optional[float] = None   # this process's nvcc
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
        return self.build_dir / f"lib{self.source.stem}_{digest}.so"

    def build(self) -> Path:
        """Compile the library unless this exact source is already built."""
        out = self.path()
        if out.exists():
            return out
        exe = nvcc()
        self.build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [exe, *NVCC_FLAGS, "-o", tmp, str(self.source)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                                   f"{self.source.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent build never sees half
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_seconds = time.perf_counter() - t0
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded library with every entry point's signature declared."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


class Launches(dict):
    """A kernel package's launch counts (kernel name -> launches): its
    wrappers add one where they launch, and nowhere else."""

    def reset(self) -> None:
        for name in self:
            self[name] = 0


_SHAPES_ONLY = [0]          # depth of `shapes_only()` scopes now open


@contextlib.contextmanager
def shapes_only() -> Iterator[None]:
    """A scope in which every kernel wrapper also takes meta tensors (on
    their own or beside CPU tensors) to its plain version, which then
    computes only shapes: the dry run's path (`launch/dryrun.py`). Outside
    it, meta tensors raise as any other device does; CUDA tensors launch
    the kernel inside it and out."""
    _SHAPES_ONLY[0] += 1
    try:
        yield
    finally:
        _SHAPES_ONLY[0] -= 1


def on_cpu(*tensors: torch.Tensor) -> bool:
    """Dispatch rule of every kernel wrapper: True for CPU tensors (the
    plain version), False for CUDA tensors (the kernel), else raise;
    inside `shapes_only()`, meta tensors (with or without CPU ones) take
    the plain version too."""
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    if _SHAPES_ONLY[0] and "meta" in devs and devs <= {"cpu", "meta"}:
        return True
    raise ValueError(f"kernel ops take CPU or CUDA tensors on one device, "
                     f"got {sorted(devs)}")


def stream() -> int:
    """PyTorch's current CUDA stream, the one every kernel launches on."""
    return torch.cuda.current_stream().cuda_stream


def raise_on(name: str, err: int) -> None:
    """Raise if a C entry point reported a failed launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
