"""PyTorch port, flash_attention: the plain version against the reference.

On the same numpy inputs made from a seed, the port's `ops` (on CPU
tensors, the plain version) and `ref` are held against the reference's
Pallas flash kernel in interpret mode and its jnp `ref`: float32 at
rtol = atol = 2e-5 (the reference kernel test's tolerance: online against
full softmax), bfloat16 at 5e-2, causal top-left also when Sq != Sk, and
`mha`'s (B, S, H, D) layout against the reference's `mha` and the
models' blockwise attention. The CUDA kernel itself runs in
tests/test_torch_cuda_kernels.py (skipped without a card) and in
chip_smoke.py.
"""
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

    def record(q, k, v, *, causal):
        seen.extend(t.is_contiguous() for t in (q, k, v))
        return real(q, k, v, causal=causal)
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
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_wgmma": 0}


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
