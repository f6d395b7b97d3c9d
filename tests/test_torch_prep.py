"""PyTorch port, host inputs: the copied host modules against the reference.

Graph generation, ordering, global reduction (host cascade and the
degree-0/1 device peel, here on the CPU torch device), X-reduction, the
oracle and bucket packing must give the same bytes as the reference
package on the same graphs, so a counter mismatch further down can be
pinned on the engine rather than on its inputs. Exact equality
throughout: everything here is integers, bit patterns and sets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import global_reduction as jgr
from repro.core import oracle as joracle
from repro.core.engine import PrepStream as JPrepStream
from repro.core.engine import prepare as jprepare
from repro.graph import generators as jgen
from repro.graph import order as jorder
from repro_torch import interop
from repro_torch.core import global_reduction as tgr
from repro_torch.core import oracle as toracle
from repro_torch.core.engine import PrepStream, prepare
from repro_torch.graph import generators as tgen
from repro_torch.graph import order as torder

pytest_plugins = ["torch_jax_executables"]


GRAPHS = [
    ("er", "erdos_renyi", (120, 0.12), dict(seed=1)),
    ("ba", "barabasi_albert", (300, 6), dict(seed=2)),
    ("caveman", "caveman", (20, 6, 0.15), dict(seed=3)),
    ("grid_road", "grid_road", (12,), dict(seed=4)),
    ("moon_moser", "moon_moser", (5,), {}),
]
IDS = [g[0] for g in GRAPHS]
BUCKET_FIELDS = ("a", "p0", "x_rows", "x_alive0", "rsz0", "roots")


def _pair(fn, args, kw):
    return getattr(jgen, fn)(*args, **kw), getattr(tgen, fn)(*args, **kw)


def _same_buckets(jb, tb):
    assert len(jb) == len(tb)
    for x, y in zip(jb, tb):
        assert (x.u_pad, x.x_pad, x.n_pad) == (y.u_pad, y.x_pad, y.n_pad)
        for f in BUCKET_FIELDS:
            a, b = getattr(x, f), getattr(y, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        assert [tuple(b) for b in x.bases] == [tuple(b) for b in y.bases]
        assert all(np.array_equal(u, v)
                   for u, v in zip(x.universes, y.universes))


@pytest.mark.parametrize("name,fn,args,kw", GRAPHS, ids=IDS)
def test_generators_and_order_match(name, fn, args, kw):
    gj, gt = _pair(fn, args, kw)
    assert np.array_equal(gj.indptr, gt.indptr)
    assert np.array_equal(gj.indices, gt.indices)
    for a, b in zip(jorder.degeneracy_order(gj), torder.degeneracy_order(gt)):
        assert np.array_equal(a, b)
    assert np.array_equal(jorder.core_numbers(gj), torder.core_numbers(gt))


def test_kronecker_matches():
    gj, gt = jgen.kronecker(9, 8, seed=0), tgen.kronecker(9, 8, seed=0)
    assert np.array_equal(gj.indptr, gt.indptr)
    assert np.array_equal(gj.indices, gt.indices)


@pytest.mark.parametrize("name,fn,args,kw", GRAPHS, ids=IDS)
def test_prepare_buckets_byte_equal(name, fn, args, kw):
    gj, gt = _pair(fn, args, kw)
    pj = jprepare(gj, bucket_sizes=(32, 64))
    pt = prepare(gt, bucket_sizes=(32, 64), device="cpu")
    _same_buckets(pj.buckets, pt.buckets)
    assert set(pj.pre_reported) == set(pt.pre_reported)
    assert len(pj.pre_reported) == len(pt.pre_reported)
    assert (pj.n, pj.degeneracy) == (pt.n, pt.degeneracy)
    assert np.array_equal(pj.order, pt.order)


@pytest.mark.parametrize("name,fn,args,kw", GRAPHS, ids=IDS)
def test_prep_stream_byte_equal(name, fn, args, kw):
    """Streamed flushes (with pow2 pad roots) match bucket for bucket."""
    gj, gt = _pair(fn, args, kw)
    sj = JPrepStream(gj, bucket_sizes=(32, 64), stream_roots=16)
    st = PrepStream(gt, bucket_sizes=(32, 64), stream_roots=16,
                    device="cpu")
    _same_buckets(list(sj), list(st))
    assert set(sj.pre_reported) == set(st.pre_reported)
    assert set(sj.late_reported) == set(st.late_reported)


def test_prep_auto_split_matches():
    """Roots larger than the biggest bucket split one BK level on the host,
    identically (late reports included)."""
    gj, gt = _pair("erdos_renyi", (90, 0.5), dict(seed=6))
    pj = jprepare(gj, bucket_sizes=(32,), max_x_rows=16)
    pt = prepare(gt, bucket_sizes=(32,), max_x_rows=16, device="cpu")
    _same_buckets(pj.buckets, pt.buckets)
    assert set(pj.pre_reported) == set(pt.pre_reported)


@pytest.mark.parametrize("seed", range(4))
def test_device_peel_matches_reference_and_host_mirror(seed):
    """global_reduce_torch (here on the CPU torch device) against the
    reference's global_reduce_jnp and the host mirror."""
    gj, gt = _pair("erdos_renyi", (80, 0.035), dict(seed=seed))
    ei = gj.edge_index()
    av_j, ae_j = jgr.global_reduce_jnp(jnp.asarray(ei[0]),
                                       jnp.asarray(ei[1]), gj.n)
    av_t, ae_t = tgr.global_reduce_torch(torch.from_numpy(ei[0]),
                                         torch.from_numpy(ei[1]), gt.n)
    assert np.array_equal(np.asarray(av_j), av_t.numpy())
    assert np.array_equal(np.asarray(ae_j), ae_t.numpy())
    assert np.array_equal(tgr._peel_rounds_np(gt), av_t.numpy())


@pytest.mark.parametrize("seed", range(3))
def test_peel_low_degree_device_path_on_cpu(seed):
    gj, gt = _pair("erdos_renyi", (90, 0.03), dict(seed=seed))
    rj, rep_j = jgr.peel_low_degree(gj, use_device=True)
    rt, rep_t = tgr.peel_low_degree(gt, use_device=True, device="cpu")
    rh, rep_h = tgr.peel_low_degree(gt, use_device=False)
    assert np.array_equal(rj.indices, rt.indices)
    assert np.array_equal(rh.indices, rt.indices)
    assert list(rep_j) == list(rep_t) == list(rep_h)


def test_peel_device_path_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = tgen.barabasi_albert(200, 1, seed=0)    # a tree: degree-1 leaves
    with pytest.raises((RuntimeError, AssertionError)):
        tgr.peel_low_degree(g, use_device=True)


@pytest.mark.parametrize("name,fn,args,kw", GRAPHS, ids=IDS)
def test_global_reduction_and_oracle_match(name, fn, args, kw):
    gj, gt = _pair(fn, args, kw)
    rj, rt = jgr.global_reduce_host(gj), tgr.global_reduce_host(gt)
    assert np.array_equal(rj.graph.indices, rt.graph.indices)
    assert rj.reported == rt.reported
    pj, pt = jgr.reduce_prepass(gj), tgr.reduce_prepass(gt, device="cpu")
    assert np.array_equal(pj[0].indices, pt[0].indices)
    assert list(pj[1]) == list(pt[1])
    assert set(joracle.rmce(gj)) == set(toracle.rmce(gt))
    assert set(joracle.bk_pivot(gj)) == set(toracle.bk_pivot(gt))


def test_bucket_interop_round_trip():
    gj = jgen.barabasi_albert(200, 5, seed=3)
    for b in jprepare(gj, bucket_sizes=(32, 64)).buckets:
        arrays = {k: getattr(b, k) for k in interop.BUCKET_KEYS}
        tensors = interop.bucket_from_reference(arrays, "cpu")
        assert tensors["a"].dtype == torch.int32
        assert tensors["x_alive0"].dtype == torch.bool
        for k, v in arrays.items():
            back = (interop.bitset_rows_to_reference(tensors[k])
                    if tensors[k].dtype == torch.int32 and k != "rsz0"
                    else tensors[k].numpy())
            assert back.dtype == v.dtype and back.tobytes() == v.tobytes()
    top = np.array([[0x80000000, 0xFFFFFFFF, 1, 0]], np.uint32)
    assert interop.bitset_rows_to_reference(
        torch.from_numpy(top.view(np.int32))).tobytes() == top.tobytes()
