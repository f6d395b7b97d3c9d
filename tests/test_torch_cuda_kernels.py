"""PyTorch port on the card: the CUDA kernels against their plain versions,
and the engines on the card against the same runs on the CPU.

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
from torch_census_inputs import census_inputs

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


@pytest.mark.parametrize("r,k,w", SHAPES)
def test_cuda_census_and_many_match_plain_versions(cuda_device, r, k, w):
    """clique_counts and and_popcount_many against their plain versions:
    an empty and a one-bit mask, all-false selectors, K = 1 against many
    masks (the rcd shape), M = 1, and K, M off the 256-thread block."""
    rows, mask, in_p, in_x = (
        torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)
        .to(cuda_device) for x in census_inputs(r, k, w, k + w))
    before = dict(ops.LAUNCHES)
    got = ops.clique_counts(rows, mask, in_p, in_x)
    want = ref.clique_counts(rows, mask, in_p, in_x)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    masks = _words((r, 3 * k + 1, w), k, cuda_device)
    for rr, mm in ((rows, masks), (rows[:, :1].contiguous(), masks),
                   (rows, masks[:, :1].contiguous())):
        assert torch.equal(ops.and_popcount_many(rr, mm),
                           ref.and_popcount_many(rr, mm))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["clique_counts"] == before["clique_counts"] + 1
    assert ops.LAUNCHES["and_popcount_many"] == \
        before["and_popcount_many"] + 3


@pytest.mark.parametrize("backend", ["hybrid", "rcd"])
@pytest.mark.parametrize("engine", ["perroot", "persistent"])
def test_cuda_backend_run_matches_cpu_run(cuda_device, backend, engine):
    g = gen.caveman(12, 7, 0.2, seed=3)
    kw = dict(backend=backend, engine=engine, enumerate_cliques=True,
              bucket_sizes=(32, 64), lanes=8)
    ops.reset_launches()
    on_card = run(g, device=cuda_device, **kw)
    launched = dict(ops.LAUNCHES)
    on_cpu = run(g, device="cpu", **kw)
    for k in ("cliques", "calls", "branches", "sum_px", "iters_exhausted"):
        assert getattr(on_card, k) == getattr(on_cpu, k)
    assert set(on_card.enumerated) == set(on_cpu.enumerated)
    if engine == "persistent":
        for k in ("iters", "live_iters", "steals", "entry_terms"):
            assert on_card.stats[k] == on_cpu.stats[k], k
    assert launched["clique_counts" if backend == "hybrid"
                    else "and_popcount_many"] > 0


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


# (L, U, XC, T, W, steps): one and several lanes, W = 3, XC = 1, a window
# deeper than the engine's, K = 1 and K = 64
WINDOW_SHAPES = [(1, 32, 1, 8, 1, 16), (6, 64, 40, 8, 2, 1),
                 (5, 96, 300, 8, 3, 64), (4, 128, 128, 12, 4, 16),
                 (64, 32, 2048, 8, 1, 16)]


def _window_inputs(L, U, XC, T, W, seed, dev):
    rng = np.random.default_rng(seed)

    def bits(shape, density):
        b = rng.random(shape + (32,)) < density
        w = np.packbits(b, axis=-1, bitorder="little").view(np.uint32)
        return torch.from_numpy(w.reshape(shape).view(np.int32)).to(dev)

    a = bits((L, U, W), 0.4)
    x_rows = bits((L, XC, W), 0.5)
    alive0 = torch.from_numpy(
        (rng.random((L, XC)) < 0.8).astype(np.int32)).to(dev)
    wins = [bits((L, T, W), d) for d in (0.5, 0.3, 0.2, 0.05)]
    wins[1][:, :, :] &= wins[0]                        # B ⊆ P
    rsz = torch.from_numpy(rng.integers(1, 6, (L, T)).astype(np.int32)).to(dev)
    dloc = torch.from_numpy(rng.integers(-1, T, L).astype(np.int32)).to(dev)
    dloc[0] = T - 1                                    # blocked at once
    if L > 2:
        dloc[1] = -1                                   # dead lane
        wins[1][2] = 0                                 # empty B: w clamps
        dloc[2] = 0
    return [a, x_rows, alive0] + wins + [rsz, dloc]


@pytest.mark.parametrize("L,U,XC,T,W,steps", WINDOW_SHAPES)
def test_cuda_window_kernel_matches_plain_version(cuda_device, L, U, XC, T,
                                                  W, steps):
    args = _window_inputs(L, U, XC, T, W, L + U + W, cuda_device)
    before = dict(ops.LAUNCHES)
    got = ops.dfs_step_window_lanes(*args, steps=steps)
    want = ref.dfs_step_window_lanes(*args, steps=steps)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    one = ops.dfs_step_window(*(t[-1] for t in args), steps=steps)
    for g, w_ in zip(one, want):
        assert torch.equal(g, w_[-1])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dfs_step_window_lanes"] == \
        before["dfs_step_window_lanes"] + 1
    assert ops.LAUNCHES["dfs_step_window"] == before["dfs_step_window"] + 1


@pytest.mark.parametrize("kw", [
    dict(), dict(dynamic_red=False, window_steps=16),
    dict(window_steps=4, enumerate_cliques=True)],
    ids=["plain", "fused-window", "engine-window-enum"])
def test_cuda_persistent_matches_cpu_run(cuda_device, kw):
    """The lane engine on the card against the same run on the CPU: the
    schedule is deterministic, so the stats must agree too."""
    g = gen.erdos_renyi(70, 0.6, seed=1)        # two spans, many steals
    kw = dict(kw, engine="persistent", bucket_sizes=(32, 64), lanes=16)
    on_card = run(g, device=cuda_device, **kw)
    on_cpu = run(g, device="cpu", **kw)
    for k in ("cliques", "calls", "branches", "sum_px", "iters_exhausted"):
        assert getattr(on_card, k) == getattr(on_cpu, k)
    for k in ("iters", "live_iters", "lane_iters", "steals", "entry_terms",
              "window_spills", "window_hits", "spans"):
        assert on_card.stats[k] == on_cpu.stats[k], k
    assert on_card.stats["steals"] > 0
    if kw.get("enumerate_cliques"):
        assert set(on_card.enumerated) == set(on_cpu.enumerated)
