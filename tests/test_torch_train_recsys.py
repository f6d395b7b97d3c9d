"""PyTorch port, two-tower training: `retrieval_loss`, its gradients and
one AdamW train step against the reference's `repro.models.recsys`.

The reference's smoke weights (`init_params` at PRNGKey(0)) are carried
across with `interop.two_tower_params_from_reference`; the batches are
`synth_batch`'s numpy arrays (equal in both packages). The bags' backward
is the plain `embedding_bag_sum_bwd` here. Tolerance rtol = atol = 1e-5
for the loss, every gradient and the AdamW moments (float32 sums of at
most a batch of terms in another order); the step's parameters at rtol
1e-5 and atol 1e-5 (1e-2 of its lr, 1e-3: the update is lr times Adam's
normalised m / sqrt(v), which carries the gradients' differences divided
by each element's own scale) and each tensor's update at relative norm
<= 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import recsys as JR
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_arch
from repro_torch.interop import (adamw_state_from_reference, two_tower_named,
                                 two_tower_params_from_reference)
from repro_torch.models import recsys as R

pytest_plugins = ["torch_jax_executables"]

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def setup():
    jcfg = ref_arch("two-tower-retrieval").build_smoke()
    cfg = get_arch("two-tower-retrieval").build_smoke()
    return jcfg, cfg, JR.init_params(jcfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_loss_and_grads_match_reference(setup, seed):
    jcfg, cfg, params = setup
    batch = R.synth_batch(cfg, BATCH, seed=seed)
    want_loss, want = jax.value_and_grad(
        lambda p: JR.retrieval_loss(jcfg, p, _jbatch(batch)))(params)
    model = two_tower_params_from_reference(_np(params), cfg, "cpu")
    loss = R.retrieval_loss(cfg, model, R.to_device(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **TOL)
    want = two_tower_named(_np(want))
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], err_msg=name,
                                   **TOL)
    # the bags reached their tables: the history bag the item table's rows
    # no item id names, the tag bag the tag table
    hist = np.unique(batch["user_hist"][batch["user_hist"] >= 0])
    rows = np.setdiff1d(hist, batch["item_id"])
    assert np.abs(got["item_id_table"].grad.numpy()[rows]).sum(1).min() > 0
    assert got["tag_table"].grad.abs().sum() > 0


def test_train_step_matches_reference(setup):
    """The reference's first step makes the state (non-zero moments, step
    1); from it, one step of each package on the next batch."""
    jcfg, cfg, params = setup
    step = jax.jit(JR.make_train_step(jcfg))
    params, opt, _ = step(params, j_adamw_init(params),
                          _jbatch(R.synth_batch(cfg, BATCH, seed=0)))
    batch = R.synth_batch(cfg, BATCH, seed=1)
    model = two_tower_params_from_reference(_np(params), cfg, "cpu")
    state = adamw_state_from_reference(_np(opt), two_tower_named, "cpu")
    want_p, want_o, want_loss = step(params, opt, _jbatch(batch))
    model, state, loss = R.make_train_step(cfg)(model, state,
                                                R.to_device(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert int(state["step"]) == int(want_o["step"]) == 2
    before, want_p = two_tower_named(_np(params)), two_tower_named(_np(want_p))
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want_p[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        moved, want_moved = got - before[name], want_p[name] - before[name]
        assert np.linalg.norm(moved - want_moved) \
            <= 1e-4 * np.linalg.norm(want_moved), name
    for key in ("mu", "nu"):
        want = two_tower_named(_np(want_o[key]))
        for name, m in state[key].items():
            np.testing.assert_allclose(m.numpy(), want[name],
                                       err_msg=f"{key} {name}", **TOL)
