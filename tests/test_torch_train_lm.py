"""PyTorch port, LM training: `lm_loss`, its gradients, the remat policies
and one AdamW train step against the reference's
`repro.models.transformer.lm_loss` and `repro.models.lm_steps`.

The reference's weights (`init_params` at PRNGKey(0)) are carried across
as float32 master weights (`interop.transformer_params_from_reference(...,
dtype=torch.float32)`), the tokens come from the port's `TokenStream`
(the reference's arrays), every config at `dtype="float32"`. The
attention runs on the flash path (the plain forward and backward here)
except Mixtral's past its 32-token window (blockwise). Tolerances:

* the loss at rtol 1e-5;
* each parameter's gradient elementwise within rtol 1e-4 of the
  reference's plus an atol of 1e-3 of that tensor's largest |gradient|,
  and at relative norm <= 5e-4: gradients of two float32 layers summed in
  another order (blockwise online softmax against the explicit one,
  another reduction order in every product) differ by up to 1.3e-4 of the
  tensor's scale on the elements whose sums cancel, and by relative norm
  up to 1.7e-4 (command-r's tied head, logits near 40);
* with and without `loss_chunk` (16, which pads the 40-token sequence to
  48 as the reference does);
* the remat policies `none`, `dots`, `nothing_saveable` (and Mixtral's
  `remat_blocks`) give the same loss and gradients bit for bit (the
  recompute repeats the same float32 operations);
* one `make_train_step` from the reference's state after one step (AdamW
  moments and step carried over with `interop.adamw_state_from_reference`)
  gives its moments at the gradients' tolerance, its parameters at rtol
  1e-5 and atol 3e-6 (1e-2 of the step's lr, 3e-4), and each tensor's
  update (new minus old parameters) at relative norm <= 1e-3: the update
  is lr times Adam's normalised m / sqrt(v), which carries the gradients'
  differences divided by each element's own scale (measured: up to 4.4e-3
  of lr on single elements, relative norm up to 1.4e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import lm_steps as JS
from repro.models import transformer as JT
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_arch
from repro_torch.data import TokenStream
from repro_torch.interop import (adamw_state_from_reference,
                                 transformer_named,
                                 transformer_params_from_reference)
from repro_torch.models import lm_steps as S
from repro_torch.models import transformer as T

pytest_plugins = ["torch_jax_executables"]

LM_ARCHS = ["qwen3-14b", "chatglm3-6b", "command-r-plus-104b",
            "mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
BATCH, SEQ, CHUNK = 2, 40, 16


def _cfgs(arch, **kw):
    """(reference config, port config) of an arch's smoke build, float32."""
    return (dataclasses.replace(ref_arch(arch).build_smoke(),
                                dtype="float32", **kw),
            dataclasses.replace(get_arch(arch).build_smoke(),
                                dtype="float32", **kw))


def _tokens(cfg, step=0):
    return TokenStream(cfg.vocab, SEQ, BATCH, seed=1).batch(step)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _model(params_np, cfg):
    return transformer_params_from_reference(params_np, cfg, "cpu",
                                             dtype=torch.float32)


def _close_grad(got, want, name):
    got = got.detach().numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3 * scale,
                               err_msg=name)
    if scale:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 5e-4, (name, rel)


def _port_grads(cfg, model, toks, tgts):
    for p in model.parameters():
        p.grad = None
    loss = T.lm_loss(cfg, model, torch.from_numpy(toks),
                     torch.from_numpy(tgts))
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in
                         model.named_parameters()}


@pytest.fixture(scope="module")
def reference():
    """(arch, loss_chunk) -> (params, loss, grads) of the reference, as
    numpy, computed once per module."""
    cache = {}

    def get(arch, chunk):
        if (arch, chunk) not in cache:
            jcfg, cfg = _cfgs(arch, loss_chunk=chunk)
            params = JT.init_params(jcfg, jax.random.PRNGKey(0))
            toks, tgts = (jnp.asarray(a) for a in _tokens(cfg))
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: JT.lm_loss(jcfg, p, toks, tgts)))(params)
            cache[arch, chunk] = (_np(params), float(loss),
                                  transformer_named(_np(grads), cfg))
        return cache[arch, chunk]
    return get


@pytest.mark.parametrize("chunk", [0, CHUNK])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_grads_match_reference(reference, arch, chunk):
    params, want_loss, want = reference(arch, chunk)
    _, cfg = _cfgs(arch, loss_chunk=chunk)
    model = _model(params, cfg)
    loss, grads = _port_grads(cfg, model, *_tokens(cfg))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        _close_grad(g, want[name], name)


@pytest.mark.parametrize("arch", ["qwen3-14b", "mixtral-8x7b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_remat_policies_give_the_same_gradients(reference, arch):
    params = reference(arch, 0)[0]
    runs = []
    for kw in (dict(remat="none"), dict(remat="dots"),
               dict(remat="nothing_saveable"),
               dict(remat="nothing_saveable", remat_blocks=True)):
        _, cfg = _cfgs(arch, **kw)
        runs.append(_port_grads(cfg, _model(params, cfg), *_tokens(cfg)))
    for loss, grads in runs[1:]:
        assert loss == runs[0][0]
        for name, g in grads.items():
            assert torch.equal(g, runs[0][1][name]), name


@pytest.mark.parametrize("arch", ["qwen3-14b", "mixtral-8x7b"])
def test_train_step_matches_reference(arch):
    """The reference's first step makes the state (non-zero moments,
    step 1); from it, one step of each package on the next batch."""
    jcfg, cfg = _cfgs(arch)
    step = jax.jit(JS.make_train_step(jcfg))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params, opt, _ = step(params, j_adamw_init(params),
                          *map(jnp.asarray, _tokens(cfg, 0)))
    toks, tgts = _tokens(cfg, 1)
    model = _model(_np(params), cfg)
    state = adamw_state_from_reference(
        jax.tree.map(np.asarray, opt),
        lambda tree: transformer_named(tree, cfg), "cpu")
    want_p, want_o, want_loss = step(params, opt, jnp.asarray(toks),
                                     jnp.asarray(tgts))
    model, state, loss = S.make_train_step(cfg)(
        model, state, torch.from_numpy(toks), torch.from_numpy(tgts))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert int(state["step"]) == int(want_o["step"]) == 2
    before = transformer_named(_np(params), cfg)
    want_p = transformer_named(_np(want_p), cfg)
    for name, p in model.named_parameters():
        assert p.grad is None
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want_p[name], rtol=1e-5, atol=3e-6,
                                   err_msg=name)
        step_got, step_want = got - before[name], want_p[name] - before[name]
        rel = np.linalg.norm(step_got - step_want) / np.linalg.norm(step_want)
        assert rel <= 1e-3, (name, rel)
    for key in ("mu", "nu"):
        want = transformer_named(_np(want_o[key]), cfg)
        for name, m in state[key].items():
            _close_grad(m, want[name], f"{key} {name}")
