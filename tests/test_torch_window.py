"""PyTorch port, stack windows: the window walk's plain version and the
per-root windowed engine, against the JAX reference.

The plain PyTorch `dfs_step_window(_lanes)` (the CPU path of `ops` and
the oracle the CUDA kernel is held against on the card) must give the
reference's `repro.kernels.bitset_ops.ref` windows and `ctl` bit for bit,
edge cases included. The per-root windowed `run_bucket` must give the
counters and `iters` of the reference's vmapped `run_root_windowed`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import frames as jfr
from repro.core.engine import loop as jloop
from repro.core.engine import prepare as jprepare
from repro.graph import generators as jgen
from repro.kernels.bitset_ops import ref as jref
from repro_torch import interop
from repro_torch.core.engine import frames as fr
from repro_torch.core.engine import loop
from repro_torch.kernels.bitset_ops import ops

pytest_plugins = ["torch_jax_executables"]


CPU = "cpu"


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(
        x.view(np.int32) if x.dtype == np.uint32 else x))


def _window_case(L, U, XC, T, W, seed, edge):
    """Seeded windows whose frames look like a real walk's: B ⊆ P,
    Xp and Rb disjoint from P, plus the named edge case on lane 0."""
    rng = np.random.default_rng(seed)

    def bits(shape, density):
        b = rng.random(shape + (32,)) < density
        return np.packbits(b, axis=-1, bitorder="little").view(
            np.uint32).reshape(shape)

    valid = np.zeros(W * 32, bool)
    valid[:U] = True
    vmask = np.packbits(valid, bitorder="little").view(np.uint32)
    a = bits((L, U, W), 0.45) & vmask
    x_rows = bits((L, XC, W), 0.5) & vmask
    alive0 = (rng.random((L, XC)) < 0.8).astype(np.int32)
    P = bits((L, T, W), 0.5) & vmask
    B = P & bits((L, T, W), 0.6)
    Xp = bits((L, T, W), 0.15) & ~P & vmask
    Rb = bits((L, T, W), 0.03) & ~P & ~Xp & vmask
    rsz = rng.integers(1, 6, (L, T)).astype(np.int32)
    dloc = rng.integers(0, T // 2 + 1, L).astype(np.int32)
    if edge == "dead":
        dloc[0] = -1
    elif edge == "blocked":
        dloc[0] = T - 1
        B[0, T - 1] |= P[0, T - 1] | np.uint32(1)
    elif edge == "empty_b":
        B[0] = 0                       # pops: the branch vertex clamps
        dloc[0] = T - 1
    return [a, x_rows, alive0, P, B, Xp, Rb, rsz, dloc]


# (L, U, XC, T, W, steps, edge): the edge cases, then the slice's shapes
WINDOW_CASES = [
    (3, 64, 40, 8, 2, 16, "dead"),
    (3, 64, 40, 8, 2, 16, "blocked"),
    (3, 32, 64, 8, 1, 16, "empty_b"),
    (4, 96, 50, 8, 3, 16, "none"),          # W = 3
    (4, 64, 1, 8, 2, 16, "none"),           # XC = 1
    (4, 64, 40, 8, 2, 1, "none"),           # K = 1
    (4, 64, 40, 8, 2, 64, "none"),          # K = 64
    (5, 32, 256, 8, 1, 16, "none"),
    (3, 128, 128, 8, 4, 16, "none"),
]


@pytest.mark.parametrize("L,U,XC,T,W,steps,edge", WINDOW_CASES)
def test_window_lanes_plain_version_matches_reference(L, U, XC, T, W, steps,
                                                      edge):
    arrays = _window_case(L, U, XC, T, W, L * U + XC + steps, edge)
    want = jax.tree.map(np.asarray, jref.dfs_step_window_lanes(
        *(jnp.asarray(x) for x in arrays[:2]), jfr.eye_bits(U, W),
        *(jnp.asarray(x) for x in arrays[2:]), steps))
    args = [_t(x) for x in arrays]
    before = dict(ops.LAUNCHES)
    got = ops.dfs_step_window_lanes(*args, steps=steps)
    assert ops.LAUNCHES == before          # the CPU path launches nothing
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy().view(w.dtype), w)
    ctl = got[-1]
    if edge == "dead":
        assert ctl[0].tolist() == [-1, 0, 0, 0, 0, 0, 0, 0]
    if edge == "blocked":
        assert ctl[0].tolist() == [T - 1, 0, 0, 0, 0, 0, 0, 0]
    if edge == "empty_b":                  # pops the whole window
        assert ctl[0].tolist() == [-1, 0, 0, 0, 0, T, 0, 0]
    assert int(ctl[:, 5].max()) <= steps
    # the inputs are not touched
    assert all(np.array_equal(t.numpy(), _t(x).numpy())
               for t, x in zip(args, arrays))


@pytest.mark.parametrize("steps", [1, 16])
def test_window_single_root_form_matches_reference(steps):
    arrays = _window_case(1, 64, 40, 8, 2, 7, "none")
    one = [x[0] for x in arrays]
    want = jax.tree.map(np.asarray, jref.dfs_step_window(
        *(jnp.asarray(x) for x in one[:2]), jfr.eye_bits(64, 2),
        *(jnp.asarray(x) for x in one[2:]), steps))
    got = ops.dfs_step_window(*(_t(x) for x in one), steps=steps)
    assert got[-1].shape == (8,)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(w.dtype), w)


def test_window_ops_validate_shapes():
    args = [_t(x) for x in _window_case(2, 32, 8, 8, 1, 0, "none")]
    with pytest.raises(ValueError):
        ops.dfs_step_window_lanes(*(a[0] for a in args), steps=4)
    assert ops.WINDOW_FRAMES == 8


# (L, U, XC, T, W): the scale-12 buckets per root (every root a lane) and
# on 64 lanes, the card tests' edge shapes, rows too large to stage, and
# the largest windows the walk takes (W = 1 and W = 850 at the shared-memory
# limit), on one lane and on many
GEOMETRY_SHAPES = [
    (1663, 32, 2048, 8, 1), (623, 64, 512, 8, 2), (21, 128, 128, 8, 4),
    (64, 32, 2048, 8, 1), (64, 64, 512, 8, 2), (64, 128, 128, 8, 4),
    (1, 32, 1, 8, 1), (7, 187, 200, 8, 6), (2, 256, 7000, 8, 8),
    (301, 64, 40, 8, 2), (1, 32, 1, 11570, 1), (100_000, 32, 1, 11570, 1),
    (2, 27_000, 5, 16, 850), (1 << 20, 64, 40, 8, 2)]


@pytest.mark.parametrize("L,U,XC,T,W", GEOMETRY_SHAPES)
def test_window_geometry_fits_and_refuses_nothing(L, U, XC, T, W):
    """Every shape the window walk takes gets a launch that fits a block:
    its threads, its shared memory (the lanes' regions as the CUDA source
    lays them out), a pivot key that holds every score and row index; the
    rows are staged exactly when they fit, and unstaged rows take one warp
    a lane."""
    assert 4 * (4 * T * W + 3 * W + T) <= ops.WINDOW_SMEM_MAX
    geo = ops.window_geometry(L, U, XC, T, W)
    assert geo.group in ops.WINDOW_GROUPS
    assert geo.lanes_per_block >= 1
    assert 32 * geo.group * geo.lanes_per_block <= ops.WINDOW_BLOCK_THREADS
    assert (geo.lanes_per_block * ops.window_lane_bytes(
        U, XC, T, W, geo.group, geo.staged) <= ops.WINDOW_BLOCK_SMEM)
    assert geo.staged == (ops.window_lane_bytes(U, XC, T, W, geo.group, True)
                          <= ops.WINDOW_BLOCK_SMEM)
    assert max(U, XC) < 2 ** geo.index_bits <= 2 ** 31
    # (score + 1) << index_bits | (2**index_bits - 1 - index) in 32 bits
    assert geo.packed == (((32 * W + 1) << geo.index_bits) < 2 ** 32)
    if not geo.staged:                 # the one unstaged instance: G = 1
        assert geo.group == 1
    for g in ops.WINDOW_GROUPS:                   # a forced G fits too
        forced = ops.window_geometry(L, U, XC, T, W, group=g)
        assert forced.group == (g if forced.staged else 1)
        assert (forced.lanes_per_block * ops.window_lane_bytes(
            U, XC, T, W, g, forced.staged) <= ops.WINDOW_BLOCK_SMEM)


@pytest.mark.parametrize("L,U,XC,W,group", [
    (1663, 32, 2048, 1, 2), (623, 64, 512, 2, 4), (21, 128, 128, 4, 4),
    (64, 32, 2048, 1, 4), (64, 64, 512, 2, 4), (64, 128, 128, 4, 4)])
def test_window_geometry_at_the_engine_buckets(L, U, XC, W, group):
    """The launches the scale-12 buckets get, per root (every root a lane)
    and on 64 lanes: the rows staged, the packed pivot key, one wave on
    132 SMs (32 warps an SM), one lane a block when L is small."""
    geo = ops.window_geometry(L, U, XC, 8, W)
    assert geo.group == group
    assert geo.staged and geo.packed
    assert L * geo.group <= 32 * ops.H100_SMS
    if L <= ops.H100_SMS:
        assert geo.lanes_per_block == 1


# --------------------------------------------------------------------------
# the per-root windowed walk against the reference's vmapped
# run_root_windowed
# --------------------------------------------------------------------------

PER_ROOT = ("cliques", "calls", "branches", "sum_px", "iters", "truncated")


@pytest.mark.parametrize("graph,steps,max_iters", [
    ("er", 4, 1 << 30), ("er", 16, 1 << 30), ("ba", 16, 1 << 30),
    ("er", 4, 9)])
def test_run_root_windowed_matches_reference(graph, steps, max_iters):
    g = (jgen.erdos_renyi(150, 0.2, seed=5) if graph == "er"
         else jgen.barabasi_albert(300, 6, seed=2))
    prep = jprepare(g, bucket_sizes=(32, 64))
    jcfg = jfr.EngineConfig(dynamic_red=False, window_steps=steps,
                            max_iters=max_iters)
    tcfg = fr.EngineConfig(dynamic_red=False, window_steps=steps,
                           max_iters=max_iters)
    assert loop._window_eligible(tcfg) and jloop._window_eligible(jcfg)
    for b in prep.buckets:
        arrays = {k: getattr(b, k) for k in interop.BUCKET_KEYS}
        want = jax.tree.map(np.asarray, jloop.run_bucket(
            *(jnp.asarray(arrays[k]) for k in interop.BUCKET_KEYS), jcfg))
        got = loop.run_bucket(*interop.bucket_from_reference(
            arrays, CPU).values(), tcfg)
        for k in PER_ROOT:
            assert np.array_equal(got[k].numpy(), want[k]), k
        assert got["steps"] >= 1
        if max_iters == 9:
            assert got["truncated"].any()


@pytest.mark.parametrize("kw", [dict(window_frames=4), dict(out_cap=64),
                                dict(dynamic_red=True)])
def test_window_gate_refuses_what_the_kernel_does_not_cover(kw):
    base = dict(dynamic_red=False, window_steps=8)
    assert loop._window_eligible(fr.EngineConfig(**base))
    assert not loop._window_eligible(fr.EngineConfig(**dict(base, **kw)))
    assert not jloop._window_eligible(jfr.EngineConfig(**dict(base, **kw)))
