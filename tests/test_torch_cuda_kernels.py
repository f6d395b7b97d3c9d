"""PyTorch port on the card: the CUDA kernels against their plain versions,
and the engines on the card against the same runs on the CPU. The
substrate kernels (common_neighbor, embedding_bag, dense_spmm,
flash_attention) are held against their plain versions at the reference
tests' edge shapes and a few more (D past one staged tile, L past one
warp, N > 32, Sq != Sk, bfloat16; for the common-neighbour test also
values on one probe chain, negative padding other than -1, duplicates,
rows from one tile to several of the queued edges, and the entry point
on a shuffled table, its ids refused outside [0, N)), and
flash_attention's tensor-core kernel at D = 64 and 128 from one row to
several ragged tiles. The row
kernels' every instance (W = 1-5, G = 1, 2, 4, rows off the vector
loads' alignment, the two-step argmax) and the engine's two entry points
on them (`lemma8_reduce`, `pivot_select`) are held bit for bit, as are
`frame_step` and `and_popcount_many` at every instance and their entry
points (`branch_step`, with the stack after its in-place write, and
`rcd_dominated`). `pivot_select` is held at the hybrid densities 0.5 and
1.0 and with its own sweep of A (what `reuse_degrees=False` takes), and
the driver (`DistributedMCE`, one rank) on the card against the same
driver on the CPU. On the serving paths, a smoke LM prefill launches
flash_attention once per layer (and decode none) and a two-tower bulk
step launches embedding_bag_sum twice, each against the same model on
the CPU. The two backward kernels (flash attention's three passes and
the bag's atomic scatter) are held against their plain versions over
the dtypes, D = 64, 128 and 256, causal on and off, Sq != Sk, several
tiles with ragged tails (the attention backward on the tensor cores for
bfloat16 at D = 64 and 128, its first pass alone, two calls bit for bit,
and the CUDA-core backward forced on the same inputs), and bags
with padding and ids past the vocabulary; a loss through `mha` and
through `embedding_bag` on CUDA tensors gives q, k, v and the table
gradients equal to autograd through the plain versions. The four GNNs
at smoke give the CPU's forward, loss and gradients on the card, and
launch none of those kernels.

Every test here needs a CUDA device and nvcc (the kernels have no CPU
mode); without a card they skip. The file imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import itertools
import math

import numpy as np
import pytest
import torch

from repro_torch.core.engine import run
from repro_torch.graph import generators as gen
from repro_torch.core.global_reduction import _triangle_edge_mask
from repro_torch.kernels.bitset_ops import ops, ref
from repro_torch.kernels.common_neighbor import ops as cn_ops
from repro_torch.kernels.common_neighbor import ref as cn_ref
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.segment_spmm import ops as sp_ops
from repro_torch.kernels.segment_spmm import ref as sp_ref
from torch_census_inputs import (branch_inputs, census_inputs,
                                 frame_inputs, hybrid_inputs)

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


# (R, U, XC, W) of the census: K = U + XC under 32 and off every block
# size, R = 1 and the scale-12 buckets' 623 roots and 64 lanes, XC = 0,
# W = 1-4 (the vector instances and W = 3) and a runtime W past 4
CENSUS_CASES = [(1, 7, 5, 1), (4, 7, 5, 1), (623, 64, 512, 2),
                (64, 64, 512, 2), (64, 32, 2048, 1), (21, 128, 128, 4),
                (3, 50, 37, 2), (5, 70, 33, 3), (4, 32, 0, 1),
                (4, 100, 130, 4), (3, 200, 300, 8), (2, 160, 7, 5)]


def _unaligned(t):
    """A contiguous copy of `t` one word past an aligned address, so the
    census takes its word-by-word instance."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("r,u,xc,w", CENSUS_CASES)
def test_cuda_census_entry_points_match_plain_versions(cuda_device, r, u,
                                                       xc, w):
    """Both entry points of the census kernel bit for bit against their
    plain versions: `hybrid_census` on the engine's operands and
    `clique_counts` on the same rows stacked with the selectors the plain
    version derives, at every block size, and with rows off the vector
    loads' alignment."""
    a, xr, P, Xp, xal = (
        torch.from_numpy(x.view(np.int32)).to(cuda_device)[:r]
        for x in hybrid_inputs(max(r, 4), u, xc, w, seed=r + u + xc + w))
    a, xr, P, Xp, xal = (t.contiguous() for t in (a, xr, P, Xp, xal))
    want = ref.hybrid_census(a, xr, P, Xp, xal)
    rows = torch.cat([a, xr], 1)
    in_p = torch.nn.functional.pad(ref.bits_to_mask(P, u), (0, xc))
    in_x = torch.cat([ref.bits_to_mask(Xp, u), ref.bits_to_mask(xal, xc)],
                     -1)
    assert all(torch.equal(g, w_) for g, w_ in zip(
        ref.clique_counts(rows, P, in_p, in_x), want))
    before = ops.LAUNCHES["clique_counts"]
    calls = 0
    for threads in (0, 32, 64, 128, 256, 512):
        got = ops.hybrid_census(a, xr, P, Xp, xal, threads=threads)
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want)), threads
        got = ops.clique_counts(rows, P, in_p, in_x, threads=threads)
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want)), threads
        calls += 2
    got = ops.hybrid_census(_unaligned(a), _unaligned(xr), P, Xp, xal)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    got = ops.clique_counts(_unaligned(rows), P, in_p, in_x)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["clique_counts"] == before + calls + 2
    with pytest.raises(RuntimeError, match="cudaError"):
        ops.hybrid_census(a, xr, P, Xp, xal, threads=48)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("k", [33, 100, 600, 1500])
@pytest.mark.parametrize("w", [1, 2, 3, 4, 5])
def test_cuda_row_kernels_every_instance(cuda_device, w, k, aligned):
    """and_popcount_rows and and_popcount_argmax at W = 1-5 (the vector
    instances and the word-by-word one), K giving G = 1, 2 and 4 warps a
    root (one batch of rows a thread, and several), 9 roots (blocks of 8 /
    G roots and a ragged last one), rows one
    word off the vector loads' alignment, tied rows and an all-invalid
    root."""
    r = 9
    rng = np.random.default_rng(k * w)
    rows = _words((r, k, w), k + w, cuda_device)
    rows[1] = rows[1, :1]                              # every score tied
    mask = _words((r, w), 7, cuda_device)
    valid = torch.from_numpy(rng.random((r, k)) < 0.5).to(cuda_device)
    valid[0] = False                                   # all-invalid root
    if not aligned:
        rows = _unaligned(rows)
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.and_popcount_rows(rows, mask),
                       ref.and_popcount_rows(rows, mask))
    got = ops.and_popcount_argmax(rows, mask, valid)
    for g, w_ in zip(got, ref.and_popcount_argmax(rows, mask, valid)):
        assert torch.equal(g, w_)
    assert int(got[0][0]) == 0 and int(got[1][0]) == -1
    torch.cuda.synchronize()
    assert ops.LAUNCHES["and_popcount_rows"] == before["and_popcount_rows"] + 1
    assert (ops.LAUNCHES["and_popcount_argmax"]
            == before["and_popcount_argmax"] + 1)


def test_cuda_argmax_two_step_reduce(cuda_device):
    """K·(32·W + 2) past 2^32: the argmax cannot pack (score + 1, ~index)
    into 32 bits and reduces in two steps (131,072 rows of 1,024 words,
    512 MiB), with the best score tied across rows far apart."""
    r, k, w = 1, 131_072, 1_024
    assert k * (32 * w + 2) > 2**32
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rows = torch.randint(-2**31, 2**31, (r, k, w), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    mask = torch.full((r, w), -1, dtype=torch.int32, device=cuda_device)
    rows[0, [5, 70_000, k - 1]] = -1                  # three tied maxima
    valid = torch.rand((r, k), generator=gen, device=cuda_device) < 0.5
    valid[0, [5, 70_000, k - 1]] = torch.tensor([False, True, True],
                                                device=cuda_device)
    got = ops.and_popcount_argmax(rows, mask, valid)
    want = ref.and_popcount_argmax(rows, mask, valid)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert int(got[0][0]) == 70_000 and int(got[1][0]) == 32 * w


# (R, U, XC, W) of the engine's entry points: W = 1-5, U off 32 and
# U = 128, XC = 0, 1, 33 and 2,048, and the U = 64 bucket's 623 roots
FRAME_CASES = [(7, 32, 0, 1), (9, 32, 2048, 1), (8, 50, 33, 2),
               (623, 64, 512, 2), (7, 96, 1, 3), (9, 128, 33, 4),
               (7, 128, 128, 4), (8, 160, 70, 5), (7, 20, 2048, 1)]


@pytest.mark.parametrize("r,u,xc,w", FRAME_CASES)
def test_cuda_lemma8_and_pivot_select_match_plain_versions(cuda_device, r,
                                                           u, xc, w):
    """lemma8_reduce and pivot_select bit for bit against their plain
    versions (frame_inputs: empty P and empty pool, tied rows, a clique, P
    inside a neighbourhood so Lemma 8 fires, scores below −1, xal bits
    past XC), every scoring mode and backend, and with A and the X0 rows
    one word off the vector loads' alignment (the word-by-word
    instance)."""
    a, xr, P, Xp, xal, Rb, rsz, deg, n_full = (
        torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)
        .to(cuda_device)
        for x in frame_inputs(r, u, xc, w, seed=r + u + xc + w))
    before = dict(ops.LAUNCHES)
    calls = 0
    for rows_a, rows_x in ((a, xr), (_unaligned(a), _unaligned(xr))):
        got = ops.lemma8_reduce(rows_a, rows_x, P, Xp, xal, Rb, rsz)
        want = ref.lemma8_reduce(a, xr, P, Xp, xal, Rb, rsz)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)
        assert int(got[6][3]) > 0 and int(got[6][6]) > 0
        for given in ((deg, n_full), (deg, None), (None, None)):
            for backend in ("pivot", "revised", "hybrid"):
                kw = dict(revised=backend == "revised",
                          hybrid=backend == "hybrid")
                assert torch.equal(
                    ops.pivot_select(rows_a, rows_x, P, Xp, xal, *given,
                                     **kw),
                    ref.pivot_select(a, xr, P, Xp, xal, *given, **kw)), \
                    (backend, given[0] is None, given[1] is None)
                calls += 1
    torch.cuda.synchronize()
    assert ops.LAUNCHES["and_popcount_rows"] == before["and_popcount_rows"] + 2
    assert (ops.LAUNCHES["and_popcount_argmax"]
            == before["and_popcount_argmax"] + calls)


@pytest.mark.parametrize("total,dense", [(81, True), (80, False)])
def test_cuda_pivot_select_hybrid_density_at_the_threshold(cuda_device,
                                                           total, dense):
    """|P| = 10: scores summing to float32(0.9)·10·9 = 81 branch on all of
    P, 80 on the pivot set, as the plain version."""
    a, xr, P, Xp, xal, _, _, deg, _ = frame_inputs(7, 64, 40, 2, seed=3)
    P[:] = 0
    P[:, 0] = np.uint32(0x3FF)
    Xp &= ~P
    deg[:, :10] = 8
    deg[:, 0] = total - 8 * 9
    a, xr, P, Xp, xal, deg = (
        torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)
        .to(cuda_device) for x in (a, xr, P, Xp, xal, deg))
    got = ops.pivot_select(a, xr, P, Xp, xal, deg, hybrid=True)
    assert torch.equal(got, ref.pivot_select(a, xr, P, Xp, xal, deg,
                                             hybrid=True))
    assert all(torch.equal(got[i], P[i]) == dense for i in range(7))


@pytest.mark.parametrize("density", [0.5, 1.0])
@pytest.mark.parametrize("r,u,xc,w", FRAME_CASES[:6])
def test_cuda_pivot_select_density_and_own_sweep(cuda_device, r, u, xc, w,
                                                 density):
    """pivot_select at cfg.hybrid_density 0.5 and 1.0 (a runtime float32
    argument of the kernel) and with deg=None (the kernel's own sweep of
    A, what reuse_degrees=False takes), every backend, bit for bit
    against the plain version at the same density."""
    a, xr, P, Xp, xal, _, _, deg, n_full = (
        torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)
        .to(cuda_device)
        for x in frame_inputs(r, u, xc, w, seed=r + u + xc + w))
    before = ops.LAUNCHES["and_popcount_argmax"]
    calls = 0
    for given in ((deg, n_full), (deg, None), (None, None)):
        for backend in ("pivot", "revised", "hybrid"):
            kw = dict(revised=backend == "revised",
                      hybrid=backend == "hybrid", density=density)
            assert torch.equal(
                ops.pivot_select(a, xr, P, Xp, xal, *given, **kw),
                ref.pivot_select(a, xr, P, Xp, xal, *given, **kw)), \
                (backend, given[0] is None, given[1] is None)
            calls += 1
    torch.cuda.synchronize()
    assert ops.LAUNCHES["and_popcount_argmax"] == before + calls


@pytest.mark.parametrize("engine", ["perroot", "persistent"])
@pytest.mark.parametrize("cfg", [
    dict(), dict(reuse_degrees=False), dict(backend="hybrid",
                                            hybrid_density=0.5),
    dict(backend="revised", reuse_degrees=False, dynamic_red=False)],
    ids=["pivot", "pivot-reuse-off", "hybrid-density05",
         "revised-reuse-off-nodyn"])
def test_cuda_driver_matches_cpu_driver(cuda_device, cfg, engine):
    """DistributedMCE on the card (one rank) equals the same driver on the
    CPU: every counter and result field, the two EngineConfig fields
    included."""
    from repro_torch.core.driver import DistributedMCE
    from repro_torch.core.engine import EngineConfig
    g = gen.erdos_renyi(150, 0.3, seed=4)
    kw = dict(cfg=EngineConfig(**cfg), chunk=32, bucket_sizes=(32, 64),
              engine=engine, lanes=8)
    ops.LAUNCHES.reset()
    card = DistributedMCE(g, device=cuda_device, **kw)
    on_card = card.run()
    assert ops.LAUNCHES["frame_step"] > 0
    assert ops.LAUNCHES["and_popcount_argmax"] > 0
    host = DistributedMCE(g, device="cpu", **kw)
    assert on_card == host.run()
    assert card.last_counters == host.last_counters


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("k", [33, 100, 600])
@pytest.mark.parametrize("w", [1, 2, 3, 4, 5])
def test_cuda_frame_step_and_many_every_instance(cuda_device, w, k, aligned):
    """frame_step at W = 1-5 (the vector instances and the word-by-word
    one), K giving G = 1, 2 and 4 warps a root, 9 roots (a ragged last
    block), an empty child set, rows one word off the vector loads'
    alignment, and R = 0; and_popcount_many with K = 1, 2 and 3 rows
    (the register path at K·W <= 4, the general kernel past it) against
    K masks, the masks off the alignment too."""
    r = 9
    rows = _words((r, k, w), k + w, cuda_device)
    p, xp, wrow = (_words((r, w), s, cuda_device) for s in (1, 2, 3))
    p[0] = 0                                           # empty child set
    masks = _words((r, k, w), k, cuda_device)
    if not aligned:
        rows, masks = _unaligned(rows), _unaligned(masks)
    before = dict(ops.LAUNCHES)
    for g, w_ in zip(ops.frame_step(rows, p, xp, wrow),
                     ref.frame_step(rows, p, xp, wrow)):
        assert torch.equal(g, w_)
    for g, w_ in zip(ops.frame_step(rows[:0], p[:0], xp[:0], wrow[:0]),
                     ref.frame_step(rows[:0], p[:0], xp[:0], wrow[:0])):
        assert g.shape == w_.shape and g.dtype == w_.dtype
    for kk in (1, 2, 3):
        rr = _words((r, kk, w), kk, cuda_device)
        assert torch.equal(ops.and_popcount_many(rr, masks),
                           ref.and_popcount_many(rr, masks)), kk
    torch.cuda.synchronize()
    assert ops.LAUNCHES["frame_step"] == before["frame_step"] + 1
    assert ops.LAUNCHES["and_popcount_many"] == \
        before["and_popcount_many"] + 3


# (R, U, XC, W) of the DFS step's entry points: FRAME_CASES, R = 0 and the
# U = 64 bucket's lanes
BRANCH_CASES = FRAME_CASES + [(0, 64, 512, 2), (64, 64, 512, 2)]


def _on(dev, *arrays):
    return [torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                             else x).to(dev) for x in arrays]


@pytest.mark.parametrize("r,u,xc,w", BRANCH_CASES)
def test_cuda_branch_step_matches_plain_version(cuda_device, r, u, xc, w):
    """branch_step bit for bit against its plain version (branch_inputs:
    an empty B, a dead root, w at bits 31 and 32, a root not live, xal
    bits past XC and a dead xal word), for the pivot family and for 'rcd'
    (w given), with A and the X0 rows one word off the vector loads'
    alignment too: every output, and the stack's six buffers compared
    whole after the in-place slot write."""
    a, xr, *stack, depth, live, wv = (
        t[:r].contiguous() for t in _on(cuda_device, *branch_inputs(
            max(r, 5), u, xc, w, 6, seed=r + u + xc + w)))
    before = ops.LAUNCHES["frame_step"]
    for given in (None, wv):
        want_stack = [t.clone() for t in stack]
        want = ref.branch_step(a, xr, *want_stack, depth, live, given)
        for rows_a, rows_x in ((a, xr), (_unaligned(a), _unaligned(xr))):
            got_stack = [t.clone() for t in stack]
            got = ops.branch_step(rows_a, rows_x, *got_stack, depth, live,
                                  given)
            for i, (g, w_) in enumerate(zip(got, want)):
                assert g.dtype == w_.dtype and torch.equal(g, w_), i
            for i, (g, w_) in enumerate(zip(got_stack, want_stack)):
                assert torch.equal(g, w_), ("stack", i)
        if r > 5:
            assert bool(want[0].any()) and not bool(want[0][1])
            assert not all(torch.equal(g, t) for g, t in
                           zip(want_stack, stack))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["frame_step"] == before + (4 if r else 0)


@pytest.mark.parametrize("r,u,xc,w", BRANCH_CASES)
def test_cuda_rcd_dominated_matches_plain_version(cuda_device, r, u, xc, w):
    """rcd_dominated bit for bit against its plain version (hybrid_inputs:
    an empty P, which every selected row blocks, a P inside an alive X0
    row's neighbourhood, rows holding P, xal bits past XC), with A and the
    X0 rows one word off the vector loads' alignment too."""
    a, xr, P, Xp, xal = (
        t[:r].contiguous() for t in _on(cuda_device, *hybrid_inputs(
            max(r, 4), u, xc, w, seed=r + u + xc + w)))
    before = ops.LAUNCHES["and_popcount_many"]
    want = ref.rcd_dominated(a, xr, P, Xp, xal)
    for rows_a, rows_x in ((a, xr), (_unaligned(a), _unaligned(xr))):
        got = ops.rcd_dominated(rows_a, rows_x, P, Xp, xal)
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype and torch.equal(g, w_)
    if r > 2 and xc:
        assert bool(want[0][2])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["and_popcount_many"] == before + (2 if r else 0)


@pytest.mark.parametrize("graph", ["caveman", "er_u64"])
@pytest.mark.parametrize("backend", ["pivot", "hybrid", "rcd"])
@pytest.mark.parametrize("engine", ["perroot", "persistent"])
def test_cuda_backend_run_matches_cpu_run(cuda_device, backend, engine,
                                          graph):
    """Each backend's per-root and lane runs on the card equal the same
    runs on the CPU (counters, clique sets, the lanes' stats), through the
    DFS step's one `branch_step` launch a step and, on 'rcd', one
    `rcd_dominated` a step; er_u64 has a U = 64 (W = 2) bucket."""
    g = (gen.caveman(12, 7, 0.2, seed=3) if graph == "caveman"
         else gen.erdos_renyi(150, 0.3, seed=4))
    kw = dict(backend=backend, engine=engine, enumerate_cliques=True,
              bucket_sizes=(32, 64), lanes=8)
    ops.LAUNCHES.reset()
    on_card = run(g, device=cuda_device, **kw)
    launched = dict(ops.LAUNCHES)
    on_cpu = run(g, device="cpu", **kw)
    for k in ("cliques", "calls", "branches", "sum_px", "iters_exhausted"):
        assert getattr(on_card, k) == getattr(on_cpu, k)
    assert set(on_card.enumerated) == set(on_cpu.enumerated)
    if engine == "persistent":
        for k in ("iters", "live_iters", "steals", "entry_terms"):
            assert on_card.stats[k] == on_cpu.stats[k], k
    assert launched["frame_step"] > 0
    if backend != "pivot":
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
# deeper than the engine's, K = 1 and K = 64, XC = 2,048 on 64 lanes
# (G = 4); then W = 7 (the runtime-W instance), lane slices off 16 bytes
# (XC = 1 with W = 2, XC = 50 with W = 3), rows too large to stage, L off
# the lanes per block with lanes that stop at different steps in one block
# (301 lanes, 2 a block; 1,663 lanes at XC = 2,048, 4 a block, G = 2), and
# K = 0
WINDOW_SHAPES = [(1, 32, 1, 8, 1, 16), (6, 64, 40, 8, 2, 1),
                 (5, 96, 300, 8, 3, 64), (4, 128, 128, 12, 4, 16),
                 (64, 32, 2048, 8, 1, 16), (3, 200, 70, 8, 7, 16),
                 (4, 64, 1, 8, 2, 16), (4, 96, 50, 8, 3, 16),
                 (2, 256, 7000, 8, 8, 16), (301, 64, 40, 8, 2, 16),
                 (1663, 32, 2048, 8, 1, 16), (4, 64, 40, 8, 2, 0)]


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


@pytest.mark.parametrize("W", [1, 2, 3, 4, 6])
def test_cuda_window_kernel_every_geometry(cuda_device, W):
    """Every launch of the window walk on one input per W instance: G = 1,
    2 and 4, one lane a block or 3 (L = 7: the last block is short), rows
    staged or read from device memory, the packed pivot key or the two-step
    reduction (also with 31 index bits); and rows one word past a 16-byte
    boundary (no bulk copy). Unstaged rows take G = 1 only: a launch of
    G = 2 or 4 without staging is refused."""
    L, U, XC = 7, 32 * W - 5, 200
    args = _window_inputs(L, U, XC, 8, W, 40 + W, cuda_device)
    want = ref.dfs_step_window_lanes(*args, steps=16)
    ib = max(U, XC).bit_length()
    cases = [(args, ops.WindowGeometry(g, lpb, staged, bits, packed))
             for g, lpb, staged, (bits, packed) in itertools.product(
                 ops.WINDOW_GROUPS, (1, 3), (True, False),
                 ((ib, True), (ib, False), (31, False)))
             if 32 * g * lpb <= ops.WINDOW_BLOCK_THREADS
             and (staged or g == 1)]
    shifted = []
    for t in args[:2]:
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        flat[1:] = t.reshape(-1)
        shifted.append(flat[1:].view(t.shape))
    cases.append((shifted + args[2:], ops.window_geometry(L, U, XC, 8, W)))
    for a, geo in cases:
        got = ops._window_walk("dfs_step_window_lanes", *a, 16, geometry=geo)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_), geo
    for g in ops.WINDOW_GROUPS[1:]:
        with pytest.raises(RuntimeError, match="cudaError"):
            ops._window_walk("dfs_step_window_lanes", *args, 16,
                             geometry=ops.WindowGeometry(g, 1, False, ib,
                                                         False))


@pytest.mark.parametrize("U,XC,T,W", [
    (32, 2048, 8, 1), (64, 512, 8, 2), (128, 128, 8, 4), (187, 200, 8, 6),
    (64, 1, 8, 2), (96, 50, 8, 3), (256, 7000, 8, 8), (32, 1, 11570, 1)])
def test_cuda_window_lane_bytes_match_the_library(cuda_device, U, XC, T, W):
    """`ops.window_lane_bytes`, from which the launch geometry is chosen,
    is the CUDA source's WinLayout, at every G, staged or not."""
    lib = ops.LIBRARY.load()
    for g, staged in itertools.product(ops.WINDOW_GROUPS, (True, False)):
        assert (ops.window_lane_bytes(U, XC, T, W, g, staged)
                == lib.bitset_window_lane_bytes(U, XC, T, W, g,
                                                int(staged))), (g, staged)


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


# --------------------------------------------------------------------------
# substrate kernels
# --------------------------------------------------------------------------

# (E, D): the reference tests' shapes, then rows past one staged tile (a
# group stages 256 entries of adj_u, the queued edges' launch 2,048 a
# tile: up to three tiles, a hit in each or none) and scale 14's width,
# off the 16-byte loads (D % 4 = 2)
CN_SHAPES = [(1, 4), (10, 8), (130, 16), (257, 5), (40, 1500), (9, 3000),
             (6, 3582)]
INT32_MIN = -2**31
CN_HASH = 0x9E3779B1        # the kernels' multiplicative hash


def _cn_colliding(n, rng, bits=12):
    """`n` distinct int32 values >= 0 that the kernels' hash, slot =
    (x * CN_HASH mod 2**32) >> (32 - log2(slots)), sends to the last slot
    of every set of up to 2**bits slots (the largest the kernels use is
    4,096), so that each probe chain runs past the last slot and wraps to
    the first."""
    inv = pow(CN_HASH, -1, 1 << 32)
    top = ((1 << bits) - 1) << (32 - bits)
    t = top + rng.permutation(1 << (32 - bits)).astype(np.uint64)
    x = (t * np.uint64(inv)) % np.uint64(1 << 32)
    x = x[x < 2**31][:n]
    assert len(x) == n
    assert ((x * np.uint64(CN_HASH)) % np.uint64(1 << 32)
            >> np.uint64(32 - bits) == (1 << bits) - 1).all()
    return x.astype(np.int64)


@pytest.mark.parametrize("e,d", CN_SHAPES)
def test_cuda_common_neighbor_matches_plain_version(cuda_device, e, d):
    """Bit-exact, with -1 anywhere in a row, values drawn from a range the
    size of D (hits in some rows, none in others), all-padding rows and
    long rows with no common entry."""
    rng = np.random.default_rng(e * 31 + d)
    au = rng.integers(-1, 4 * d, (e, d)).astype(np.int32)
    av = rng.integers(-1, 4 * d, (e, d)).astype(np.int32)
    au[0] = -1                                   # no real entry
    if e > 2:
        au[1] = np.arange(d)                     # disjoint real rows
        av[1] = np.arange(d, 2 * d)
        av[2, rng.random(d) < 0.5] = -1
    au, av = (torch.from_numpy(x).to(cuda_device) for x in (au, av))
    before = cn_ops.LAUNCHES["has_common_neighbor"]
    got = cn_ops.has_common_neighbor(au, av)
    assert got.dtype == torch.bool
    assert torch.equal(got, cn_ref.has_common_neighbor(au, av))
    torch.cuda.synchronize()
    assert cn_ops.LAUNCHES["has_common_neighbor"] == before + 2


def _cn_risk_rows(case, d, rng):
    """(adj_u, adj_v) of 64 rows for a case the hash-set design puts at
    risk; about half the rows share one entry."""
    e = 64
    au = rng.permutation(np.arange(2 * e * d)).reshape(2, e, d)
    au, av = au[0].astype(np.int64), au[1].astype(np.int64)
    if case == "collide":                  # every value on one probe chain
        pool = _cn_colliding(2 * e * d, rng)
        au, av = pool[au], pool[av]
    share = rng.random(e) < 0.5
    cols = rng.integers(0, d, (e, 2))
    if case == "last_chunk":               # the only match at the rows' ends
        cols[:] = d - 1
    rows = np.arange(e)
    av[rows[share], cols[share, 1]] = au[rows[share], cols[share, 0]]
    if case == "duplicates":               # each row a few values, repeated
        au = au[:, :3][:, rng.integers(0, 3, d)]
        av = np.where(share[:, None], au[:, :1], av[:, :3][
            :, rng.integers(0, 3, d)])
    pad = {"pad_minus7": -7, "pad_int32_min": INT32_MIN}.get(case)
    if pad is not None:                    # negative padding, mid-row too
        for t in (au, av):
            t[rng.random((e, d)) < 0.4] = pad
    if case == "pad_int32_min":            # a padding value equal in both
        au[:, 0] = av[:, 0] = INT32_MIN
    return (np.ascontiguousarray(au, dtype=np.int32),
            np.ascontiguousarray(av, dtype=np.int32))


CN_RISKS = ["collide", "pad_minus7", "pad_int32_min", "duplicates",
            "last_chunk"]


@pytest.mark.parametrize("d", [5, 130, 1336, 3582])
@pytest.mark.parametrize("case", CN_RISKS)
def test_cuda_common_neighbor_risk_cases(cuda_device, case, d):
    """Values that collide in the set, negative padding other than -1,
    duplicates within a row and a match only in the last chunk, at widths
    of one set and past one staged tile; bit-exact against the plain
    version and against the truth of each row pair."""
    rng = np.random.default_rng(len(case) * 7 + d)
    au, av = _cn_risk_rows(case, d, rng)
    want = np.array([bool(set(u[u >= 0]) & set(v[v >= 0]))
                     for u, v in zip(au, av)])
    assert want.any() and not want.all()
    got = cn_ops.has_common_neighbor(*(torch.from_numpy(x).to(cuda_device)
                                       for x in (au, av)))
    assert np.array_equal(got.cpu().numpy(), want)
    assert torch.equal(got.cpu(), cn_ref.has_common_neighbor(
        torch.from_numpy(au), torch.from_numpy(av)))


@pytest.mark.parametrize("d", [40, 300, 1100, 2000, 5000])
@pytest.mark.parametrize("real_share", [0.1, 1.0])
def test_cuda_common_neighbor_set_sizes(cuda_device, d, real_share):
    """Rows from one group tile to several tiles of the queued edges'
    launch, on rows gathered beforehand and through the entry point: a
    match at the swept row's end (found in the first tile), at the staged
    row's end (found in the last) or none, side by side in a block, so
    that some groups decide their edge and others queue it."""
    rng = np.random.default_rng(int(real_share * 10) + d)
    e = 50
    au, av = (rng.integers(0, 2**31 - 1, (e, d)).astype(np.int32)
              for _ in range(2))
    for t in (au, av):
        t[rng.random((e, d)) > real_share] = -1
    av[::3, -1] = au[::3, 0]
    au[1::3, -1] = av[1::3, 0]
    au, av = (torch.from_numpy(x).to(cuda_device) for x in (au, av))
    want = cn_ref.has_common_neighbor(au, av)
    assert want.any() and not want.all()
    assert torch.equal(cn_ops.has_common_neighbor(au, av), want)
    table = torch.cat([au, av])
    edges = torch.stack([torch.arange(e), torch.arange(e, 2 * e)], 1)
    assert torch.equal(cn_ops.edge_common_neighbor(
        table, edges.to(cuda_device)), want)


@pytest.mark.parametrize("e", [0, 1])
def test_cuda_common_neighbor_few_edges(cuda_device, e):
    rows = torch.arange(e * 6, dtype=torch.int32).reshape(e, 6)
    before = cn_ops.LAUNCHES["has_common_neighbor"]
    got = cn_ops.has_common_neighbor(rows.to(cuda_device),
                                     rows.flip(1).to(cuda_device))
    assert got.shape == (e,) and got.dtype == torch.bool
    assert got.cpu().tolist() == [True] * e
    assert cn_ops.LAUNCHES["has_common_neighbor"] == before + 2 * e
    table = torch.arange(20, dtype=torch.int32).reshape(4, 5).to(cuda_device)
    edges = torch.tensor([[0, 1]] * e, dtype=torch.int32).reshape(e, 2)
    got = cn_ops.edge_common_neighbor(table, edges.to(cuda_device))
    assert got.shape == (e,) and got.cpu().tolist() == [False] * e


def _shuffled_table(g, rng, pad=-1):
    """The graph's padded table with each row's entries shuffled and its
    padding spread mid-row (any negative value `pad`)."""
    d = int(g.degrees().max()) + 5
    padded = cn_ops.pad_adjacency(g.indptr, g.indices, d)
    padded[padded < 0] = pad
    return np.stack([rng.permutation(r) for r in padded])


@pytest.mark.parametrize("graph", ["er", "ba", "caveman"])
def test_cuda_edge_common_neighbor_is_the_triangle_mask(cuda_device, graph):
    g = {"er": gen.erdos_renyi(300, 0.05, seed=2),
         "ba": gen.barabasi_albert(400, 4, seed=3),
         "caveman": gen.caveman(20, 6, 0.1, seed=4)}[graph]
    padded = cn_ops.pad_adjacency(g.indptr, g.indices,
                                  int(g.degrees().max()))
    got = cn_ops.edge_common_neighbor(
        torch.from_numpy(padded).to(cuda_device),
        torch.from_numpy(g.edges()).to(cuda_device))
    assert np.array_equal(got.cpu().numpy(), _triangle_edge_mask(g))


@pytest.mark.parametrize("ids", ["int32", "int64", "transposed"])
@pytest.mark.parametrize("pad", [-1, -7, INT32_MIN])
def test_cuda_edge_common_neighbor_in_place(cuda_device, pad, ids):
    """Bit-exact against the gather and the plain version on a table with
    padding mid-row and shuffled rows, edges in both directions and in a
    shuffled order, ids int32, int64 or a transposed (strided) view; three
    launches a call."""
    rng = np.random.default_rng(abs(pad) % 97)
    g = gen.barabasi_albert(600, 6, seed=5)
    table = torch.from_numpy(_shuffled_table(g, rng, pad))
    e = g.edges()
    e = np.concatenate([e, e[:, ::-1]])[rng.permutation(2 * len(e))]
    edges = torch.from_numpy(np.ascontiguousarray(e))
    want = cn_ref.has_common_neighbor(table[edges[:, 0].long()],
                                      table[edges[:, 1].long()])
    dev_edges = {"int32": edges, "int64": edges.long(),
                 "transposed": edges.t().contiguous().t()}[ids]
    before = cn_ops.LAUNCHES["has_common_neighbor"]
    got = cn_ops.edge_common_neighbor(table.to(cuda_device),
                                      dev_edges.to(cuda_device))
    assert cn_ops.LAUNCHES["has_common_neighbor"] == before + 3
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("bad", [-1, 40, 2**31 - 1, -2**40])
def test_cuda_edge_common_neighbor_refuses_ids_out_of_range(cuda_device,
                                                            bad):
    """An id outside [0, N) raises ValueError and reads nothing through
    it; the process's card stays usable, and the next call is right."""
    table = torch.arange(40 * 8, dtype=torch.int32).reshape(40, 8)
    edges = torch.tensor([[0, 1], [2, 3], [4, 5]], dtype=torch.int64)
    edges[1, 1] = bad
    dtype = torch.int64 if abs(bad) >= 2**31 else torch.int32
    with pytest.raises(ValueError, match=r"\[0, 40\)"):
        cn_ops.edge_common_neighbor(table.to(cuda_device),
                                    edges.to(dtype).to(cuda_device))
    with pytest.raises(ValueError, match=r"\[0, 40\)"):
        cn_ops.edge_common_neighbor(table, edges.to(dtype))
    torch.cuda.synchronize()
    edges[1, 1] = 3
    assert cn_ops.edge_common_neighbor(
        table.to(cuda_device), edges.to(cuda_device)).cpu().tolist() == [
            False] * 3


# (V, D, B, L): the reference tests' shapes, its vocab-tile case, D off the
# 16-byte load, D wider than one warp's loads, bags longer than 32
EB_SHAPES = [(64, 8, 16, 4), (512, 32, 100, 8), (1000, 16, 33, 12),
             (2048, 64, 256, 1), (500, 16, 64, 6), (300, 13, 40, 40),
             (100, 200, 7, 70)]


@pytest.mark.parametrize("v,d,b,l", EB_SHAPES)
def test_cuda_embedding_bag_matches_plain_version(cuda_device, v, d, b, l):
    """rtol = atol = 1e-5: sums of at most L float32 terms in another
    order. ids past the vocabulary read its last row, as the plain
    version does."""
    rng = np.random.default_rng(v + d + b + l)
    table = torch.from_numpy(
        rng.normal(size=(v, d)).astype(np.float32)).to(cuda_device)
    ids = np.where(rng.random((b, l)) < 0.8, rng.integers(0, v, (b, l)),
                   -1).astype(np.int32)
    ids[0, 0] = v                                # out of contract
    ids[-1, -1] = np.iinfo(np.int32).max
    ids[-1, 0] = -7                              # padding other than -1
    ids = torch.from_numpy(ids).to(cuda_device)
    before = eb_ops.LAUNCHES["embedding_bag_sum"]
    for combiner in ("sum", "mean"):
        got = eb_ops.embedding_bag(table, ids, combiner)
        want = eb_ref.embedding_bag(table, ids, combiner)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert eb_ops.LAUNCHES["embedding_bag_sum"] == before + 2


def test_cuda_embedding_bag_casts_its_inputs(cuda_device):
    """A bfloat16 or float64 table and int64 ids are cast to float32 and
    int32, as the reference's kernel does, and launch the kernel: equal to
    the plain version on the cast inputs within 1e-5."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(700, 24)).astype(np.float32))
    ids = torch.from_numpy(np.where(rng.random((50, 9)) < 0.8,
                                    rng.integers(0, 700, (50, 9)), -1))
    for t in (table.to(torch.bfloat16), table.double()):
        t, i = t.to(cuda_device), ids.to(cuda_device)
        before = eb_ops.LAUNCHES["embedding_bag_sum"]
        got = eb_ops.embedding_bag_sum(t, i)
        assert got.dtype == torch.float32
        torch.testing.assert_close(
            got, eb_ref.embedding_bag(t.float(), i.int(), "sum"),
            rtol=1e-5, atol=1e-5)
        assert eb_ops.LAUNCHES["embedding_bag_sum"] == before + 1


@pytest.fixture
def full_fp32_matmul():
    """The plain versions' einsum in full float32 (no TF32), as stated."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


# (B, N, F): the reference tests' shapes, then N past one 32-row tile
SPMM_SHAPES = [(1, 8, 4), (8, 30, 16), (17, 12, 32), (3, 70, 40),
               (2, 100, 130), (128, 30, 128)]


@pytest.mark.parametrize("b,n,f", SPMM_SHAPES)
def test_cuda_dense_spmm_matches_plain_version(cuda_device, full_fp32_matmul,
                                               b, n, f):
    """rtol = atol = 1e-5: sums of N float32 products in another order."""
    rng = np.random.default_rng(b * n + f)
    adj = torch.from_numpy(
        (rng.random((b, n, n)) < 0.3).astype(np.float32)).to(cuda_device)
    x = torch.from_numpy(
        rng.normal(size=(b, n, f)).astype(np.float32)).to(cuda_device)
    before = sp_ops.LAUNCHES["dense_spmm"]
    torch.testing.assert_close(sp_ops.dense_spmm(adj, x),
                               sp_ref.dense_spmm(adj, x),
                               rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert sp_ops.LAUNCHES["dense_spmm"] == before + 1


# (B, N, F) -> the path dense_spmm takes: the molecule cell (whole graphs
# by bulk copy, one stage), the two-stage ring with bulk copies (N = 400;
# with column chunks at F = 200), one stage with column chunks (F = 136,
# the last chunk 8 wide), the ring with plain loads (N = 333 odd),
# plain loads in one stage (N = 7 and F = 3; F = 130 past 128, not a
# multiple of 4), bulk copies at F off float4 (F = 6)
SPMM_PATHS = [((128, 30, 128), dict(bulk=True, ring=False, vec=True)),
              ((128, 30, 32), dict(bulk=True, ring=False, vec=True)),
              ((3, 400, 128), dict(bulk=True, ring=True, vec=True)),
              ((2, 300, 200), dict(bulk=True, ring=True, vec=True)),
              ((2, 40, 136), dict(bulk=True, ring=False, vec=True)),
              ((2, 333, 64), dict(bulk=False, ring=True, vec=True)),
              ((4, 7, 3), dict(bulk=False, ring=False, vec=False)),
              ((2, 100, 130), dict(bulk=False, ring=False, vec=False)),
              ((5, 10, 6), dict(bulk=True, ring=False, vec=False))]


@pytest.mark.parametrize("shape,path", SPMM_PATHS)
def test_cuda_dense_spmm_paths(cuda_device, full_fp32_matmul, shape, path):
    """Each staging path of the kernel (`kernel_path` says which one a
    shape takes) within rtol = atol = 1e-5 of the plain version."""
    b, n, f = shape
    rng = np.random.default_rng(b + n + f)
    adj = torch.from_numpy(
        (rng.random((b, n, n)) < 0.3).astype(np.float32)).to(cuda_device)
    x = torch.from_numpy(
        rng.normal(size=(b, n, f)).astype(np.float32)).to(cuda_device)
    taken = sp_ops.kernel_path(adj, x)
    assert {k: taken[k] for k in path} == path
    torch.testing.assert_close(sp_ops.dense_spmm(adj, x),
                               sp_ref.dense_spmm(adj, x),
                               rtol=1e-5, atol=1e-5)


def test_cuda_dense_spmm_casts_its_inputs(cuda_device, full_fp32_matmul):
    """bfloat16 and float64 inputs are cast to float32 by the wrapper, as
    the reference's kernel does, and launch the kernel: within 1e-5 of
    the plain version on the cast inputs."""
    rng = np.random.default_rng(6)
    adj = torch.from_numpy((rng.random((16, 30, 30)) < 0.3)
                           .astype(np.float32)).to(cuda_device)
    x = torch.from_numpy(rng.normal(size=(16, 30, 64))
                         .astype(np.float32)).to(cuda_device)
    for dtype in (torch.bfloat16, torch.float64):
        before = sp_ops.LAUNCHES["dense_spmm"]
        got = sp_ops.dense_spmm(adj.to(dtype), x.to(dtype))
        assert got.dtype == torch.float32
        torch.testing.assert_close(
            got, sp_ref.dense_spmm(adj.to(dtype).float(),
                                   x.to(dtype).float()),
            rtol=1e-5, atol=1e-5)
        assert sp_ops.LAUNCHES["dense_spmm"] == before + 1


def test_cuda_densify_edges_matches_cpu(cuda_device):
    rng = np.random.default_rng(5)
    n_graphs, npg, per = 6, 9, 20
    gid = np.repeat(np.arange(n_graphs), per)
    src = gid * npg + rng.integers(0, npg, gid.size)
    dst = gid * npg + rng.integers(0, npg, gid.size)
    w = rng.random(gid.size).astype(np.float32)
    args = [torch.from_numpy(a) for a in (src, dst)]
    cpu = sp_ops.densify_edges(*args, n_graphs * npg, torch.from_numpy(gid),
                               n_graphs, npg, torch.from_numpy(w))
    card = sp_ops.densify_edges(*(a.to(cuda_device) for a in args),
                                n_graphs * npg,
                                torch.from_numpy(gid).to(cuda_device),
                                n_graphs, npg,
                                torch.from_numpy(w).to(cuda_device))
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-6, atol=1e-6)


# (BH, Sq, Sk, D, causal): the reference tests' shapes, then causal with
# Sq != Sk both ways, D = 200 (the 256-column accumulator, D not a power of
# two) and D = 256
FA_SHAPES = [(2, 128, 128, 64, True), (3, 100, 100, 32, True),
             (1, 256, 256, 128, False), (4, 64, 192, 64, False),
             (2, 33, 70, 16, False), (2, 33, 70, 16, True),
             (2, 150, 40, 48, True), (1, 90, 90, 200, True),
             (1, 64, 100, 256, False)]


@pytest.mark.parametrize("bh,sq,sk,d,causal", FA_SHAPES)
def test_cuda_flash_attention_matches_plain_version(
        cuda_device, full_fp32_matmul, bh, sq, sk, d, causal):
    """float32: rtol = atol = 2e-5, as the reference's kernel test."""
    rng = np.random.default_rng(bh * sq + d)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, s, d)).astype(
        np.float32)).to(cuda_device) for s in (sq, sk, sk))
    before = fa_ops.LAUNCHES["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, fa_ref.flash_attention(q, k, v,
                                                           causal=causal),
                               rtol=2e-5, atol=2e-5)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1


@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_bf16(cuda_device, full_fp32_matmul, causal):
    """bfloat16 in and out, float32 inside on both sides: they differ by
    the output's rounding (one bf16 ulp) and summation order, so rtol
    1e-2 and atol 1e-3 (the typical late-row output is about 0.1 here),
    and a relative norm under 1e-2 over the whole output."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 300, 128))).to(
        cuda_device, torch.bfloat16) for _ in range(3))
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16
    want = fa_ref.flash_attention(q, k, v, causal=causal).float()
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-3)
    assert float((got.float() - want).norm() / want.norm()) < 1e-2


# (Sq, Sk) of the tensor-core kernel: one row, one consumer's 64 rows,
# either side of one 128-row tile, several tiles with a ragged end, then
# top-left causal masking with Sq != Sk both ways
WGMMA_SEQS = [(1, 1), (64, 64), (127, 127), (128, 128), (129, 129),
              (300, 300), (1000, 1000), (150, 40), (64, 192)]


@pytest.mark.parametrize("bh", [1, 40])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", WGMMA_SEQS)
def test_cuda_flash_attention_tensor_cores(cuda_device, full_fp32_matmul, sq,
                                           sk, d, causal, bh):
    """bfloat16 at D = 64 and 128 takes the wgmma kernel, held to the plain
    version as the bf16 case above: rtol 1e-2, atol 1e-3 elementwise and a
    relative norm under 1e-2."""
    rng = np.random.default_rng(sq * 7 + sk + d + bh)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, s, d))).to(
        cuda_device, torch.bfloat16) for s in (sq, sk, sk))
    before = dict(fa_ops.LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"] + 1
    assert fa_ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert got.dtype == torch.bfloat16 and got.shape == (bh, sq, d)
    want = fa_ref.flash_attention(q, k, v, causal=causal).float()
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-3)
    assert float((got.float() - want).norm() / want.norm()) < 1e-2


# every version of the CUDA-core kernel reached on the card: bfloat16 at
# D = 48, 96 and 200 (its 64-, 128- and 256-column accumulators; D off the
# tensor-core list) and float32 at D = 128
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 48),
                                     (torch.bfloat16, 96),
                                     (torch.bfloat16, 200),
                                     (torch.float32, 128)])
def test_cuda_flash_attention_cuda_cores(cuda_device, full_fp32_matmul,
                                         dtype, d):
    """bfloat16 at D = 48, 96, 200 and float32 at D = 128 take the CUDA-core
    kernel (the tensor-core count stays where it was), held to the plain
    version: float32 at 2e-5, bfloat16 at rtol 1e-2, atol 1e-3 and a
    relative norm under 1e-2."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 130, d))).to(
        cuda_device, dtype) for _ in range(3))
    before = dict(fa_ops.LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"]
    assert fa_ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert got.dtype == dtype and got.shape == (2, 130, d)
    want = fa_ref.flash_attention(q, k, v, causal=True).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-3)
        assert float((got.float() - want).norm() / want.norm()) < 1e-2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [48, 128, 200])
def test_cuda_flash_attention_float16(cuda_device, full_fp32_matmul, d,
                                      causal):
    """float16 takes the CUDA-core kernel's float16 instance (never the
    tensor-core one), held to the plain version at the bfloat16
    tolerances: rtol 1e-2, atol 1e-3 and a relative norm under 1e-2."""
    rng = np.random.default_rng(d + causal)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, s, d))).to(
        cuda_device, torch.float16) for s in (130, 150, 150))
    before = dict(fa_ops.LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"]
    assert fa_ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert got.dtype == torch.float16 and got.shape == (2, 130, d)
    want = fa_ref.flash_attention(q, k, v, causal=causal).float()
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-3)
    assert float((got.float() - want).norm() / want.norm()) < 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_flash_attention_refuses_wide_heads(cuda_device, dtype):
    """D above MAX_HEAD_DIM (256) is refused on the card, launching
    nothing: the CUDA-core kernel's accumulator is sized at compile time,
    and no configuration of the repo has D other than 64 or 128."""
    q = torch.zeros(1, 8, fa_ops.MAX_HEAD_DIM + 8, dtype=dtype,
                    device=cuda_device)
    before = dict(fa_ops.LAUNCHES)
    with pytest.raises(ValueError, match="head width"):
        fa_ops.flash_attention(q, q, q)
    assert fa_ops.LAUNCHES == before


@pytest.mark.parametrize("b", [1, 2])
def test_cuda_mha_layout(cuda_device, full_fp32_matmul, b):
    """(B, S, H, D) in and out; B = 1 included (a strided view to copy)."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, 64, 4, 32)).astype(
        np.float32)).to(cuda_device) for _ in range(3))
    out = fa_ops.mha(q, k, v, causal=True)
    assert out.shape == (b, 64, 4, 32)
    want = fa_ref.flash_attention(
        q.transpose(1, 2).reshape(4 * b, 64, 32),
        k.transpose(1, 2).reshape(4 * b, 64, 32),
        v.transpose(1, 2).reshape(4 * b, 64, 32)).reshape(b, 4, 64, 32)
    torch.testing.assert_close(out, want.transpose(1, 2), rtol=2e-5,
                               atol=2e-5)


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("d_head,wgmma", [(16, False), (128, True)])
def test_cuda_lm_prefill_launches_flash_per_layer(cuda_device, d_head, wgmma):
    """A smoke prefill (bfloat16) on the card launches flash_attention once
    per layer, the tensor-core kernel at D = 128 and the CUDA-core one at
    the smoke D = 16; decode launches none. Logits agree with the same
    model on the CPU under the bf16 check (relative norm <= 2e-2)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_steps import make_prefill_step
    cfg = dataclasses.replace(get_arch("qwen3-14b").build_smoke(),
                              d_head=d_head)
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 24), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    prefill = make_prefill_step(cfg)
    want, want_cache = prefill(model, toks)
    nxt = want.argmax(-1, keepdim=True)
    want_step, _ = T.decode_step(cfg, model, want_cache, nxt)
    model.to(cuda_device)
    fa_ops.LAUNCHES.reset()
    got, cache = prefill(model, toks.to(cuda_device))
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert fa_ops.LAUNCHES["flash_attention_wgmma"] == (
        cfg.n_layers if wgmma else 0)
    assert _rel(got.cpu(), want) <= 2e-2
    step, _ = T.decode_step(cfg, model, cache, nxt.to(cuda_device))
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert _rel(step.cpu(), want_step) <= 2e-2


def test_cuda_two_tower_bulk_launches_two_bags(cuda_device, full_fp32_matmul):
    """A two-tower bulk_step on the card launches embedding_bag_sum twice
    (the user's history bag, the item's tag bag) and agrees with the same
    model on the CPU at 1e-5."""
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys as R
    cfg = get_arch("two-tower-retrieval").build_smoke()
    model = R.init_params(cfg, torch.Generator().manual_seed(0))
    batch = R.synth_batch(cfg, 64, seed=0)
    bulk = R.make_bulk_score_step(cfg)
    want = bulk(model, R.to_device(batch, "cpu"))
    model.to(cuda_device)
    eb_ops.LAUNCHES.reset()
    got = bulk(model, R.to_device(batch, cuda_device))
    torch.cuda.synchronize()
    assert eb_ops.LAUNCHES["embedding_bag_sum"] == 2
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# the backward kernels: (Sq, Sk) with Sq == Sk across several tiles, and
# Sq != Sk both ways (top-left causal masking); then several whole 128-row
# tiles, and ragged tails both ways across several tiles
FA_BWD_SEQS = [(130, 130), (150, 70), (70, 150), (384, 384), (517, 261),
               (261, 517)]
FA_BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
              torch.bfloat16: dict(rtol=1e-2, atol=1e-3),
              torch.float16: dict(rtol=1e-2, atol=1e-3)}


def _close_bwd(got, want, dtype):
    """float32: rtol = atol = 1e-4 (gradients sum up to S products in
    another order, and the kernel's P is exp(S - lse) where the plain
    version's is exp(S - m) / l, its delta rowsum(dO * O) where the plain
    version's is rowsum(P * dP)); bfloat16 and float16: the forward's
    checks, rtol 1e-2, atol 1e-3 and a relative norm under 1e-2 (the
    CUDA-core passes compute in float32 and round once; the tensor-core
    passes multiply P and dS as bf16 pairs hi + lo, whose error is far
    below the output's own rounding)."""
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **FA_BWD_TOL[dtype])
    if dtype != torch.float32:
        assert _rel(got, want) < 1e-2


def _bwd_inputs(dtype, d, causal, sq, sk, dev):
    rng = np.random.default_rng(sq + 3 * sk + d + causal)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, s, d))).to(dev, dtype)
               for s in (sq, sk, sk))
    do = torch.from_numpy(rng.normal(size=(3, sq, d))).to(dev, dtype)
    return q, k, v, do


@pytest.mark.parametrize("sq,sk", FA_BWD_SEQS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_flash_attention_bwd_matches_plain_version(
        cuda_device, full_fp32_matmul, dtype, d, causal, sq, sk):
    """The three backward launches against `ref.flash_attention_bwd` on the
    same q, k, v and dO; bfloat16 at D = 64 and 128 takes the tensor-core
    passes, every other case the CUDA-core ones."""
    q, k, v, do = _bwd_inputs(dtype, d, causal, sq, sk, cuda_device)
    before = dict(fa_ops.LAUNCHES)
    got = fa_ops.flash_attention_bwd(q, k, v, do, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 3
    assert fa_ops.LAUNCHES["flash_attention_bwd_wgmma"] == \
        before["flash_attention_bwd_wgmma"] \
        + 3 * fa_ops.takes_tensor_cores(dtype, d)
    want = fa_ref.flash_attention_bwd(q, k, v, do, causal=causal)
    for g, w in zip(got, want):
        _close_bwd(g, w, dtype)


@pytest.mark.parametrize("sq,sk", FA_BWD_SEQS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_attention_bwd_cuda_cores_forced(
        cuda_device, full_fp32_matmul, d, causal, sq, sk):
    """The CUDA-core backward, forced on the bfloat16 inputs the
    tensor-core passes take, meets the same checks."""
    q, k, v, do = _bwd_inputs(torch.bfloat16, d, causal, sq, sk,
                              cuda_device)
    before = dict(fa_ops.LAUNCHES)
    got = fa_ops._backward(q, k, v, do, causal, cuda_cores=True)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 3
    assert fa_ops.LAUNCHES["flash_attention_bwd_wgmma"] == \
        before["flash_attention_bwd_wgmma"]
    want = fa_ref.flash_attention_bwd(q, k, v, do, causal=causal)
    for g, w in zip(got, want):
        _close_bwd(g, w, torch.bfloat16)


@pytest.mark.parametrize("sq,sk", [(517, 261), (261, 517)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_attention_bwd_rows_pass(cuda_device, full_fp32_matmul, d,
                                            causal, sq, sk):
    """The tensor-core first pass alone (through the library) against
    `ref.flash_attention_bwd_rows`: lse (which the kernel writes in the
    log2 domain) to 1e-5 relative (1e-4 absolute), delta to 1e-4 relative
    (1e-3 absolute: a float32 sum of p * dP with |dP| about sqrt(D)); the
    scratch rows past Sq hold zeros."""
    from repro_torch.kernels._build import stream
    q, k, v, do = _bwd_inputs(torch.bfloat16, d, causal, sq, sk,
                              cuda_device)
    rows = fa_ops.padded_rows(sq)
    lse = torch.full((3, rows), float("nan"), device=cuda_device)
    delta = torch.full_like(lse, float("nan"))
    err = fa_ops.LIBRARY.load().flash_attention_bwd_rows_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), 3, sq, sk, d, d ** -0.5,
        int(causal), 1, stream())
    assert err == 0
    torch.cuda.synchronize()
    want_lse, want_delta = fa_ref.flash_attention_bwd_rows(q, k, v, do,
                                                           causal=causal)
    torch.testing.assert_close(lse[:, :sq] * math.log(2), want_lse,
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(delta[:, :sq], want_delta, rtol=1e-4,
                               atol=1e-3)
    assert bool((lse[:, sq:] == 0).all() and (delta[:, sq:] == 0).all())


@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_attention_bwd_is_deterministic(cuda_device, d):
    """Two calls of the tensor-core backward on the same inputs give
    bit-identical gradients (no atomics)."""
    q, k, v, do = _bwd_inputs(torch.bfloat16, d, True, 517, 517, cuda_device)
    first = fa_ops.flash_attention_bwd(q, k, v, do, causal=True)
    second = fa_ops.flash_attention_bwd(q, k, v, do, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.float32, 64)])
def test_cuda_mha_backward_reaches_q_k_v(cuda_device, full_fp32_matmul, dtype,
                                         d):
    """The fault the backward kernels close: a backward through `mha` on
    CUDA tensors gives q, k and v gradients (the forward kernel's output
    has a grad_fn), equal to autograd through the plain forward on the
    same tensors, GQA's repeated heads summed; bfloat16 at D = 128 through
    the tensor-core backward."""
    from repro_torch.models.layers import repeat_kv
    rng = np.random.default_rng(d)
    b, s, h, kv = 2, 96, 4, 2
    leaves = [torch.from_numpy(rng.normal(size=(b, s, n, d))).to(
        cuda_device, dtype).requires_grad_() for n in (h, kv, kv)]
    do = torch.from_numpy(rng.normal(size=(b, s, h, d))).to(cuda_device,
                                                            dtype)
    def qkv():
        return leaves[0], repeat_kv(leaves[1], 2), repeat_kv(leaves[2], 2)
    before = dict(fa_ops.LAUNCHES)
    fa_ops.mha(*qkv(), causal=True).backward(do)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa_ops.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 3
    assert fa_ops.LAUNCHES["flash_attention_bwd_wgmma"] == \
        before["flash_attention_bwd_wgmma"] + 3 * (dtype == torch.bfloat16)
    assert all(t.grad is not None for t in leaves)
    got = [t.grad for t in leaves]
    for t in leaves:
        t.grad = None
    flat = [t.transpose(1, 2).reshape(b * h, s, d) for t in qkv()]
    want = fa_ref.flash_attention(*flat, causal=True)
    want.reshape(b, h, s, d).transpose(1, 2).backward(do)
    for g, t in zip(got, leaves):
        _close_bwd(g, t.grad, dtype)


@pytest.mark.parametrize("v,d,b,l", EB_SHAPES)
def test_cuda_embedding_bag_bwd_matches_plain_version(cuda_device, v, d, b,
                                                      l):
    """rtol = atol = 1e-5: each row sums the bags' gradients in another
    order (atomics); pads and ids past the vocabulary (into the last
    row) as in the forward's test."""
    rng = np.random.default_rng(v + d + b + l + 1)
    ids = np.where(rng.random((b, l)) < 0.8, rng.integers(0, v, (b, l)),
                   -1).astype(np.int32)
    ids[0, 0] = v
    ids[-1, -1] = np.iinfo(np.int32).max
    ids[-1, 0] = -7
    ids = torch.from_numpy(ids).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(
        cuda_device)
    before = eb_ops.LAUNCHES["embedding_bag_sum_bwd"]
    got = eb_ops.embedding_bag_sum_bwd(g, ids, v)
    torch.cuda.synchronize()
    assert eb_ops.LAUNCHES["embedding_bag_sum_bwd"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (v, d)
    torch.testing.assert_close(got, eb_ref.embedding_bag_sum_bwd(g, ids, v),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_embedding_bag_backward_reaches_the_table(cuda_device, dtype,
                                                       combiner):
    """The fault the backward kernel closes: a loss through
    `embedding_bag` on CUDA tensors gives the table a gradient (in the
    table's type), equal to autograd through the plain version on the
    same tensors: float32 at 1e-5, a bfloat16 table at one bf16 rounding
    (rtol 1e-2, atol 1e-3)."""
    rng = np.random.default_rng(11)
    v, d, b, l = 300, 32, 64, 9
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(
        cuda_device, dtype).requires_grad_()
    ids = torch.from_numpy(np.where(rng.random((b, l)) < 0.7,
                                    rng.integers(0, v, (b, l)), -1)).to(
        cuda_device)
    w = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(
        cuda_device)
    before = eb_ops.LAUNCHES["embedding_bag_sum_bwd"]
    (eb_ops.embedding_bag(table, ids, combiner) * w).sum().backward()
    torch.cuda.synchronize()
    assert eb_ops.LAUNCHES["embedding_bag_sum_bwd"] == before + 1
    got, table.grad = table.grad, None
    assert got is not None and got.dtype == dtype
    (eb_ref.embedding_bag(table.float(), ids, combiner) * w).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=1e-3)
    torch.testing.assert_close(got.float(), table.grad.float(), **tol)


@pytest.mark.parametrize("arch", ["meshgraphnet", "schnet", "dimenet",
                                  "mace"])
def test_cuda_gnn_matches_the_cpu(cuda_device, full_fp32_matmul, arch):
    """A smoke GNN (`build_smoke()`, `batch_molecules(4, 10, 8)`) on the
    card against the same weights on the CPU: the forward and the loss at
    rtol = atol = 1e-4, every gradient at rtol 1e-4 with an atol of 1e-3
    of each tensor's largest entry (float32 sums in another order: cuBLAS
    against the CPU's, the segment sums' atomics). The GNN path launches
    none of the substrate kernels."""
    import copy
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn_steps as G
    cfg = get_arch(arch).build_smoke()
    batch_np = G.batch_molecules(4, 10, 8, seed=0,
                                 with_triplets=(arch == "dimenet"))
    host = G.FORWARD[arch][1](cfg, torch.Generator().manual_seed(0), 8)
    card = copy.deepcopy(host).to(cuda_device)
    before = [dict(m.LAUNCHES) for m in (eb_ops, fa_ops, sp_ops, cn_ops,
                                         ops)]
    got = []
    for model, dev in ((host, "cpu"), (card, cuda_device)):
        batch = G.to_device(batch_np, dev)
        out = G.FORWARD[arch][2](cfg, model, batch)
        loss = G.gnn_loss(arch, cfg, model, batch, 4)
        loss.backward()
        got.append((out.detach().cpu(), loss.detach().cpu(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()}))
    torch.cuda.synchronize()
    assert [dict(m.LAUNCHES) for m in (eb_ops, fa_ops, sp_ops, cn_ops,
                                       ops)] == before
    (out0, loss0, grads0), (out1, loss1, grads1) = got
    torch.testing.assert_close(out1, out0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(loss1, loss0, rtol=1e-4, atol=1e-4)
    for name, want in grads0.items():
        torch.testing.assert_close(grads1[name], want, rtol=1e-4,
                                   atol=1e-3 * float(want.abs().max()),
                                   msg=name)
