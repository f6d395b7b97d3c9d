"""PyTorch port on the card: the CUDA kernels against their plain versions.

Every test here needs a CUDA device and nvcc (the kernels have no CPU
mode); without a card they skip. The file imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.engine import run
from repro_torch.graph import generators as gen
from repro_torch.kernels.bitset_ops import ops, ref

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1, 1), (3, 7, 4), (2, 100, 8), (2, 515, 4), (1, 64, 128),
          (2, 33, 160), (4, 257, 32), (3, 2048, 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _words(shape, seed, dev):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    w[rng.random(shape) < 0.15] |= np.uint32(0x80000000)
    w[rng.random(shape) < 0.05] = np.uint32(0xFFFFFFFF)
    w[rng.random(shape) < 0.05] = 0
    return torch.from_numpy(w.view(np.int32)).to(dev)


@pytest.mark.parametrize("r,k,w", SHAPES)
def test_cuda_kernels_match_plain_versions(cuda_device, r, k, w):
    rng = np.random.default_rng(k + w)
    rows = _words((r, k, w), k, cuda_device)
    p, xp, wrow = (_words((r, w), s, cuda_device) for s in (1, 2, 3))
    valid = torch.from_numpy(rng.random((r, k)) < 0.5).to(cuda_device)
    valid[0] = False                                   # all-invalid root
    tied = rows[:, :1].expand(r, k, w).contiguous()    # every score tied
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.and_popcount_rows(rows, p),
                       ref.and_popcount_rows(rows, p))
    for rr in (rows, tied):
        for g, w_ in zip(ops.and_popcount_argmax(rr, p, valid),
                         ref.and_popcount_argmax(rr, p, valid)):
            assert torch.equal(g, w_)
    for g, w_ in zip(ops.frame_step(rows, p, xp, wrow),
                     ref.frame_step(rows, p, xp, wrow)):
        assert torch.equal(g, w_)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["and_popcount_rows"] == before["and_popcount_rows"] + 1
    assert (ops.LAUNCHES["and_popcount_argmax"]
            == before["and_popcount_argmax"] + 2)
    assert ops.LAUNCHES["frame_step"] == before["frame_step"] + 1


@pytest.mark.parametrize("dynamic_red", [True, False])
def test_cuda_run_matches_cpu_run(cuda_device, dynamic_red):
    g = gen.erdos_renyi(150, 0.15, seed=4)
    on_card = run(g, dynamic_red=dynamic_red, enumerate_cliques=True,
                  bucket_sizes=(32, 64), device=cuda_device)
    on_cpu = run(g, dynamic_red=dynamic_red, enumerate_cliques=True,
                 bucket_sizes=(32, 64), device="cpu")
    for k in ("cliques", "calls", "branches", "sum_px", "iters_exhausted"):
        assert getattr(on_card, k) == getattr(on_cpu, k)
    assert set(on_card.enumerated) == set(on_cpu.enumerated)
