"""PyTorch port, optim: AdamW, the cosine schedule and the int8
error-feedback all-reduce against the reference's `repro.optim`.

The same numpy parameters, gradients and moments (made from a seed) go
through both packages. AdamW is held at rtol 1e-6 (atol 1e-9 for the
elements near zero): each element is the reference's sequence of float32
operations, and the global norm sums the tensors in another order. The
schedule is held at rtol 1e-6 (torch's and XLA's float32 cosine may
differ in the last bit), the all-reduce exactly on a one-rank gloo group
against a one-device `shard_map` of the reference.
"""
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.optim import ef_int8_allreduce as j_ef_int8_allreduce
from repro.sharding.compat import shard_map
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               apply_gradients, cosine_warmup,
                               ef_int8_allreduce, ef_state_init)

pytest_plugins = ["torch_jax_executables"]

SHAPES = dict(w=(7, 5), b=(5,), table=(13, 4, 3), s=())


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (rng.normal(size=s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _t(tree):
    return {n: torch.from_numpy(np.array(a)) for n, a in tree.items()}


@pytest.mark.parametrize("clip", ["idle", "engaged"])
def test_adamw_update_matches_reference(clip):
    """Two steps from zero moments (the second with the moments and step
    the first left), clip idle (global norm under clip_norm) and engaged
    (gradients 100x): parameters, moments and step equal the reference's."""
    cfg = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)
    params = _arrays(0)
    scale = 0.05 if clip == "idle" else 100.0
    grads = [_arrays(1 + i, scale) for i in range(2)]
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jo = j_adamw_init(jp)
    tp = _t(params)
    to = adamw_init(tp)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads[0].values()))
    assert (norm < 1.0) == (clip == "idle")
    for g in grads:
        jp, jo = j_adamw_update(jp, {n: jnp.asarray(a) for n, a in g.items()},
                                jo, jnp.float32(3e-4), JAdamWConfig(**cfg))
        tp, to = adamw_update(tp, _t(g), to, 3e-4, AdamWConfig(**cfg))
    for n in SHAPES:
        for got, want in ((tp[n], jp[n]), (to["mu"][n], jo["mu"][n]),
                          (to["nu"][n], jo["nu"][n])):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)
    assert int(to["step"]) == int(jo["step"]) == 2
    assert to["step"].dtype == torch.int32


def test_adamw_keeps_a_bfloat16_parameter_in_its_type():
    """Moments float32 whatever the parameter's type; the parameter is
    updated in float32 and stored back in its own type, as the reference's
    `p2.astype(p.dtype)`."""
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw_init(p)
    assert st["mu"]["w"].dtype == torch.float32
    w = p["w"]
    adamw_update(p, {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}, st,
                 0.1, AdamWConfig(weight_decay=0.0))
    assert p["w"] is w and w.dtype == torch.bfloat16
    # 1 - 0.1 * (m / sqrt(v)) = 0.9, rounded to bfloat16
    assert torch.equal(w, torch.full((4,), 0.9).to(torch.bfloat16))


def test_adamw_converges_quadratic():
    """The reference's test on the port: 300 steps of apply_gradients on
    sum((x - 1)^2) reach x = 1."""
    x = torch.nn.Parameter(torch.tensor([5.0, -3.0]))
    model = torch.nn.Module()
    model.x = x
    st = adamw_init(dict(model.named_parameters()))
    cfg = AdamWConfig(weight_decay=0.0, clip_norm=100.0)
    for _ in range(300):
        st = apply_gradients(model, ((x - 1.0) ** 2).sum(), st, 0.1, cfg)
    np.testing.assert_allclose(x.detach().numpy(), [1.0, 1.0], atol=1e-2)
    assert x.grad is None and int(st["step"]) == 300


@pytest.mark.parametrize("warmup,total,floor", [(10, 100, 0.1), (0, 50, 0.0),
                                                 (25, 30, 0.2)])
def test_cosine_warmup_matches_reference(warmup, total, floor):
    steps = np.arange(0, total + 10)
    want = np.array([float(j_cosine_warmup(int(s), peak_lr=3e-4,
                                           warmup=warmup, total=total,
                                           floor=floor)) for s in steps])
    got = np.array([float(cosine_warmup(int(s), peak_lr=3e-4, warmup=warmup,
                                        total=total, floor=floor))
                    for s in steps])
    assert cosine_warmup(3, peak_lr=1.0, warmup=10, total=100).dtype \
        == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.fixture
def one_rank_group(tmp_path):
    """The default process group: gloo, one rank, on a file store."""
    if dist.is_initialized():
        pytest.skip("a default process group is already initialised")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_ef_int8_allreduce_matches_reference(one_rank_group):
    """Two steps of the same gradients, the residual carried: the port on a
    one-rank gloo group equals the reference's one-device shard_map
    bit for bit, and the two steps average close to the true value (the
    reference's own test)."""
    from jax.sharding import PartitionSpec as P
    g = {"w": np.linspace(-1, 1, 256).astype(np.float32) * 0.01,
         "m": np.random.default_rng(3).normal(size=(6, 9)).astype(
             np.float32)}
    mesh = jax.make_mesh((1,), ("data",))

    @partial(shard_map, mesh=mesh, in_specs=(P(), P()),
             out_specs=(P(), P()), check_vma=False)
    def run(gg, ee):
        return j_ef_int8_allreduce(gg, ee, axis_name="data")

    jg = {n: jnp.asarray(a) for n, a in g.items()}
    je = {n: jnp.zeros(a.shape, jnp.float32) for n, a in g.items()}
    tg = _t(g)
    te = ef_state_init(tg)
    outs = []
    for _ in range(2):
        jout, je = run(jg, je)
        tout, te = ef_int8_allreduce(tg, te)
        for n in g:
            np.testing.assert_array_equal(tout[n].numpy(),
                                          np.asarray(jout[n]))
            np.testing.assert_array_equal(te[n].numpy(), np.asarray(je[n]))
        outs.append(tout["w"].numpy())
    np.testing.assert_allclose((outs[0] + outs[1]) / 2, g["w"], atol=2e-4)
