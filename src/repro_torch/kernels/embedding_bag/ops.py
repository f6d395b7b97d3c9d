"""Dispatching wrapper for EmbeddingBag.

Dispatch is by the device of the tensors handed in, and by nothing else:
a CPU tensor takes the plain version in `ref`; a CUDA tensor launches the
hand-written Hopper kernel `csrc/embedding_bag.cu` (built at first use by
the port's build helper) or raises. `LAUNCHES["embedding_bag_sum"]`
counts the kernel's launches.

The reference sends only vocabularies up to `ONEHOT_VOCAB_LIMIT` (65,536)
to its TPU kernel, because it computes the bag as a one-hot GEMM over
vocabulary tiles and pays for every row of the table. The Hopper kernel
is a gather: its cost is the rows the bags name, whatever V is, so it
takes every vocabulary. 'mean' divides the kernel's sum by the bag sizes,
so a CUDA tensor never reaches `ref`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import (CudaLibrary, Launches, on_cpu,
                                        raise_on, stream)
from repro_torch.kernels.embedding_bag import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary(SOURCE, {
    "embedding_bag_sum": [_p, _p, _p, _ll, _i, _ll, _i, _i, _p]})
LAUNCHES = Launches({"embedding_bag_sum": 0})
COMBINERS = ("sum", "mean")


def embedding_bag_sum(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """out[b] = sum of table[ids[b, l]] over the ids >= 0, summed in slot
    order in float32. table: (V, D); ids: (B, L) -> (B, D) float32. The
    table is cast to float32 and the ids to int32 first, as the reference's
    kernel does (`embedding_bag/kernel.py:71`). An id at or above V reads
    row V - 1, as the plain version."""
    cpu = on_cpu(table, ids)
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"embedding_bag: table must be (V, D) and ids "
                         f"(B, L), got {tuple(table.shape)} and "
                         f"{tuple(ids.shape)}")
    table = table.to(torch.float32).contiguous()
    ids = ids.to(torch.int32).contiguous()
    if cpu:
        return ref.embedding_bag(table, ids, "sum")
    (v, d), (b, l) = table.shape, ids.shape
    if v == 0:
        raise ValueError("embedding_bag: empty table")
    out = torch.empty(b, d, dtype=torch.float32, device=table.device)
    if b and d:
        vec = int(d % 4 == 0 and table.data_ptr() % 16 == 0)
        raise_on("embedding_bag_sum", LIBRARY.load().embedding_bag_sum(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), b, l, v, d,
            vec, stream()))
        LAUNCHES["embedding_bag_sum"] += 1
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """table: (V, D); ids: (B, L) int32 padded with -1 -> (B, D)."""
    if combiner not in COMBINERS:
        raise ValueError(f"embedding_bag: combiner must be one of "
                         f"{COMBINERS}, got {combiner!r}")
    if on_cpu(table, ids):
        return ref.embedding_bag(table, ids, combiner)
    out = embedding_bag_sum(table, ids)
    if combiner == "mean":
        out = out / (ids >= 0).sum(dim=1, keepdim=True).clamp(min=1)
    return out
