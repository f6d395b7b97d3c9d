"""PyTorch port, flash_attention: the plain version against the reference.

On the same numpy inputs made from a seed, the port's `ops` (on CPU
tensors, the plain version) and `ref` are held against the reference's
Pallas flash kernel in interpret mode and its jnp `ref`: float32 at
rtol = atol = 2e-5 (the reference kernel test's tolerance: online against
full softmax), bfloat16 at 5e-2, causal top-left also when Sq != Sk, and
`mha`'s (B, S, H, D) layout against the reference's `mha` and the
models' blockwise attention. The plain backward `ref.flash_attention_bwd`
is held against `jax.vjp` of the reference's jnp `ref`: float32 at rtol =
atol = 1e-5 (causal and not, Sq != Sk), bfloat16 at the card's bf16
checks (rtol 1e-2, atol 1e-3, relative norm 1e-2); on CPU tensors the
autograd Function behind `flash_attention` and `mha` routes its backward
to it. `ref.flash_attention_bwd_rows`, the plain version of the backward's
first pass (online over key tiles), is held against JAX: lse against
`jax.nn.logsumexp` of the reference's masked, scaled scores, delta against
rowsum(dO * O) with O from the reference's jnp version, at rtol = atol =
1e-5. The backward's routing (tensor cores for bfloat16 at D = 64 or 128,
else the CUDA cores, or the CUDA cores when forced) is checked with the
library stubbed. The CUDA kernels themselves run in
tests/test_torch_cuda_kernels.py (skipped without a card) and in
chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jkernel
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import ops, ref

pytest_plugins = ["torch_jax_executables"]

TOL = dict(rtol=2e-5, atol=2e-5)
# (BH, Sq, Sk, D, causal): the reference's kernel test shapes, then causal
# with Sq != Sk both ways
SHAPES = [(2, 128, 128, 64, True), (3, 100, 100, 32, True),
          (1, 256, 256, 128, False), (4, 64, 192, 64, False),
          (2, 33, 70, 16, False), (2, 33, 70, 16, True),
          (2, 90, 40, 24, True)]


def _qkv(bh, sq, sk, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(bh, s, d)).astype(dtype)
                 for s in (sq, sk, sk))


@pytest.mark.parametrize("bh,sq,sk,d,causal", SHAPES)
def test_flash_attention_matches_reference(bh, sq, sk, d, causal):
    q, k, v = _qkv(bh, sq, sk, d, bh * sq + d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jref.flash_attention(jq, jk, jv, causal=causal))
    pallas = np.asarray(jkernel.flash_attention(
        jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True))
    np.testing.assert_allclose(pallas, want, **TOL)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for fn in (ops.flash_attention, ref.flash_attention):
        got = fn(tq, tk, tv, causal=causal)
        assert got.dtype == torch.float32 and got.shape == (bh, sq, d)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_attention_bf16():
    """bfloat16 in and out, float32 inside: 5e-2, as the reference's
    bfloat16 test."""
    q, k, v = _qkv(2, 128, 128, 64, 8)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jref.flash_attention(jq, jk, jv, causal=True),
                      np.float32)
    pallas = np.asarray(jkernel.flash_attention(jq, jk, jv, causal=True,
                                                interpret=True), np.float32)
    np.testing.assert_allclose(pallas, want, rtol=5e-2, atol=5e-2)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_float16(causal):
    """float16 in and out, float32 inside (the CUDA-core kernel's third
    type): against the reference's jnp version on the same float16 inputs
    at the card's bfloat16 tolerances, rtol 1e-2 and atol 1e-3 (both round
    a float32 result once to float16, 2^-11 of the value)."""
    q, k, v = _qkv(2, 70, 90, 32, 9)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.float16) for a in (q, k, v))
    want = np.asarray(jref.flash_attention(jq, jk, jv, causal=causal),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.float16) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-3)


def test_mha_layout():
    from repro.models.layers import blockwise_attention
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(2, 64, 4, 32)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = ops.mha(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert got.shape == (2, 64, 4, 32)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.mha(jq, jk, jv, causal=True)), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(blockwise_attention(jq, jk, jv, causal=True,
                                                    kv_block=32)),
        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b", [1, 2])
def test_mha_hands_the_kernel_contiguous_rows(monkeypatch, b):
    """The kernel takes contiguous (B*H, S, D) rows; at B = 1 the layout
    change is a strided view that `mha` must copy."""
    seen = []
    real = ops.flash_attention

    def record(q, k, v, **kw):
        seen.extend(t.is_contiguous() for t in (q, k, v))
        return real(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_attention", record)
    q = torch.randn(b, 16, 3, 8)
    out = ops.mha(q, q, q, causal=True)
    assert seen == [True] * 3 and out.shape == (b, 16, 3, 8)


def test_cpu_dispatch_takes_the_plain_version_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 10, 12, 8, 1))
    ops.LAUNCHES.reset()
    for causal in (True, False):
        assert torch.equal(ops.flash_attention(q, k, v, causal=causal),
                           ref.flash_attention(q, k, v, causal=causal))
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_wgmma": 0,
                            "flash_attention_bwd": 0,
                            "flash_attention_bwd_wgmma": 0}


@pytest.mark.parametrize("dtype,d,tensor_cores", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 16, False), (torch.bfloat16, 32, False),
    (torch.bfloat16, 48, False), (torch.bfloat16, 96, False),
    (torch.bfloat16, 200, False), (torch.bfloat16, 256, False),
    (torch.float32, 16, False), (torch.float32, 48, False),
    (torch.float32, 64, False), (torch.float32, 128, False),
    (torch.float32, 200, False), (torch.float32, 256, False),
    (torch.float16, 128, False)])
def test_routing_between_the_two_kernels(dtype, d, tensor_cores):
    """bfloat16 at D = 64 or 128 takes the tensor-core kernel; float32
    (held to 2e-5, beyond TF32) and every other D the CUDA-core kernel."""
    assert ops.takes_tensor_cores(dtype, d) is tensor_cores


def test_dispatch_refuses_other_devices():
    q = torch.zeros(2, 8, 16, device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(2, 8, 16), q)


def _jax_vjp(q, k, v, do, causal, dtype=jnp.float32):
    """(dq, dk, dv) of the reference's jnp flash attention on inputs cast to
    `dtype`."""
    jq, jk, jv, jdo = (jnp.asarray(a).astype(dtype) for a in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention(a, b, c,
                                                          causal=causal),
                     jq, jk, jv)
    return vjp(jdo)


@pytest.mark.parametrize("bh,sq,sk,d,causal", SHAPES)
def test_flash_attention_bwd_matches_jax_grad(bh, sq, sk, d, causal):
    q, k, v = _qkv(bh, sq, sk, d, bh + sq + d)
    do = np.random.default_rng(d).normal(size=(bh, sq, d)).astype(np.float32)
    want = _jax_vjp(q, k, v, do, causal)
    got = ref.flash_attention_bwd(*map(torch.from_numpy, (q, k, v, do)),
                                  causal=causal)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_bf16(causal):
    """bfloat16 inputs: the reference's jnp version differentiated by JAX
    in float32 and rounded once, as the plain backward. The card's bf16
    checks: rtol 1e-2, atol 1e-3 and a relative norm under 1e-2."""
    q, k, v = _qkv(2, 96, 80, 64, 4)
    do = np.random.default_rng(5).normal(size=(2, 96, 64)).astype(np.float32)
    want = _jax_vjp(q, k, v, do, causal, jnp.bfloat16)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    got = ref.flash_attention_bwd(*args, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=1e-2,
                                   atol=1e-3)
        assert np.linalg.norm(g.float().numpy() - w) / np.linalg.norm(w) \
            < 1e-2


# (Sq, Sk, q_offset): rows in the middle of the keys, the last rows (the
# offset plus Sq is Sk), and a small offset with keys no row sees
OFFSETS = [(40, 100, 60), (33, 70, 37), (64, 192, 5)]


@pytest.mark.parametrize("sq,sk,off", OFFSETS)
def test_mha_at_query_offset_matches_blockwise(sq, sk, off):
    """`mha` whose query rows start at q_offset among the keys (a rank of
    a sequence split) against the reference's `blockwise_attention` at the
    same offset, forward and the gradients of q, k and v (autograd through
    the plain backward against `jax.vjp`): float32, rtol = atol = 2e-5.
    `ref.flash_attention_bwd_rows` at the offset gives the lse of the
    reference's masked scores."""
    from repro.models import layers as JL
    rng = np.random.default_rng(sq + off)
    b, h, d = 2, 3, 16
    q, do = (rng.normal(size=(b, sq, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, sk, h, d)).astype(np.float32)
            for _ in range(2))

    def blockwise(a, b_, c):
        return JL.blockwise_attention(a, b_, c, causal=True, q_offset=off,
                                      kv_block=32)
    want, vjp = jax.vjp(blockwise, *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = ops.mha(*leaves, causal=True, q_offset=off)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(torch.from_numpy(do))
    for t, w, name in zip(leaves, vjp(jnp.asarray(do)), "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **TOL)
    flat = [torch.from_numpy(a).transpose(1, 2).reshape(b * h, -1, d)
            for a in (q, k, v, do)]
    lse, _ = ref.flash_attention_bwd_rows(*flat, q_offset=off)
    scores = np.einsum("bqd,bkd->bqk", *(t.numpy() for t in flat[:2])) \
        / np.sqrt(d)
    seen = off + np.arange(sq)[:, None] >= np.arange(sk)[None, :]
    want_lse = jax.nn.logsumexp(np.where(seen, scores, -np.inf), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    with pytest.raises(ValueError):
        ops._check(*flat[:3], -1)


def test_autograd_takes_the_plain_backward_on_cpu(monkeypatch):
    """On CPU tensors a backward through `mha` calls
    `ref.flash_attention_bwd` once, launches nothing, and gives q, k and v
    the reference's gradients."""
    calls = []
    real = ref.flash_attention_bwd

    def record(*a, **kw):
        calls.append(kw["causal"])
        return real(*a, **kw)
    monkeypatch.setattr(ref, "flash_attention_bwd", record)
    rng = np.random.default_rng(6)
    q, k, v, do = (rng.normal(size=(2, 20, 3, 8)).astype(np.float32)
                   for _ in range(4))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ops.LAUNCHES.reset()
    ops.mha(*leaves, causal=True).backward(torch.from_numpy(do))
    assert calls == [True]
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_wgmma": 0,
                            "flash_attention_bwd": 0,
                            "flash_attention_bwd_wgmma": 0}
    flat = [a.transpose(0, 2, 1, 3).reshape(6, 20, 8) for a in (q, k, v, do)]
    want = _jax_vjp(*flat, True)
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(
            t.grad.numpy(),
            np.asarray(w).reshape(2, 3, 20, 8).transpose(0, 2, 1, 3),
            rtol=1e-5, atol=1e-5)


@functools.partial(jax.jit, static_argnames="causal")
def _jax_rows(q, k, v, do, causal):
    """(logsumexp of the reference's scaled scores masked to -1e30,
    rowsum(dO * O) of its float32 output)."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    s = jnp.einsum("bqd,bkd->bqk", q, k) / np.sqrt(d)
    if causal:
        s = jnp.where((jnp.arange(sq)[:, None] >= jnp.arange(sk)[None, :])
                      [None], s, -1e30)
    return (jax.nn.logsumexp(s, axis=-1),
            jnp.sum(do * jref.flash_attention(q, k, v, causal=causal),
                    axis=-1))


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("bh,sq,sk,d,causal", SHAPES)
def test_flash_attention_bwd_rows_matches_jax(bh, sq, sk, d, causal, block):
    """The rows pass's plain version, online over key tiles of `block` (32:
    several tiles and a ragged one at these shapes; 128: the kernel's):
    lse against jax.nn.logsumexp of the reference's scaled scores masked
    to -1e30, delta against rowsum(dO * O) of the reference's float32
    output."""
    q, k, v = _qkv(bh, sq, sk, d, 7 * sq + sk + d)
    do = np.random.default_rng(d + 1).normal(size=(bh, sq, d)).astype(
        np.float32)
    want_lse, want_delta = map(np.asarray, _jax_rows(q, k, v, do, causal))
    lse, delta = ref.flash_attention_bwd_rows(
        *map(torch.from_numpy, (q, k, v, do)), causal=causal, block=block)
    assert lse.dtype == delta.dtype == torch.float32
    assert lse.shape == delta.shape == (bh, sq)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(delta.numpy(), want_delta, rtol=1e-5,
                               atol=1e-5)


class _StubLibrary:
    """Records each C entry point called (name, arguments); every launch
    reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            return 0
        return launch


@pytest.mark.parametrize("dtype,d,cuda_cores,tensor_cores", [
    (torch.bfloat16, 64, False, True), (torch.bfloat16, 128, False, True),
    (torch.bfloat16, 128, True, False), (torch.bfloat16, 64, True, False),
    (torch.bfloat16, 96, False, False), (torch.bfloat16, 256, False, False),
    (torch.float32, 128, False, False), (torch.float16, 64, False, False)])
def test_backward_routing(monkeypatch, dtype, d, cuda_cores, tensor_cores):
    """A backward call that reaches the card (the device check and the
    library stubbed) launches the tensor-core passes for bfloat16 at D = 64
    or 128 unless the CUDA cores are forced, else the CUDA-core passes:
    three launches either way, counted in flash_attention_bwd, and in
    flash_attention_bwd_wgmma on the tensor cores."""
    lib = _StubLibrary()
    monkeypatch.setattr(ops, "on_cpu", lambda *t: False)
    monkeypatch.setattr(ops.LIBRARY, "load", lambda: lib)
    monkeypatch.setattr(ops, "stream", lambda: 0)
    q = torch.zeros(2, 130, d, dtype=dtype)
    ops.LAUNCHES.reset()
    got = ops._backward(q, q, q, q, True, cuda_cores=cuda_cores)
    suffix = "_sm90" if tensor_cores else ""
    assert lib.calls == [f"flash_attention_bwd_{n}{suffix}"
                         for n in ("rows", "dkdv", "dq")]
    assert ops.LAUNCHES["flash_attention_bwd"] == 3
    assert ops.LAUNCHES["flash_attention_bwd_wgmma"] == 3 * tensor_cores
    assert [g.shape for g in got] == [q.shape] * 3
    assert ops.takes_tensor_cores(dtype, d) is (tensor_cores or cuda_cores)
    if not cuda_cores:
        lib.calls.clear()
        ops.flash_attention_bwd(q, q, q, q, causal=False)
        assert lib.calls == [f"flash_attention_bwd_{n}{suffix}"
                             for n in ("rows", "dkdv", "dq")]


@pytest.mark.parametrize("sq,rows", [(1, 128), (127, 128), (128, 128),
                                     (129, 256), (4096, 4096)])
def test_backward_scratch_rows(sq, rows):
    """The tensor-core passes' lse and delta rows: Sq up to a whole
    128-row query tile."""
    assert ops.padded_rows(sq) == rows
