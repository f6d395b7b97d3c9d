"""PyTorch port, the GNN family: MeshGraphNet, SchNet, DimeNet and MACE
against the reference's `repro.models.gnn` / `gnn_steps`, and the E(3)
basis against `repro.models.equivariant`.

Each arch at `build_smoke()` on `batch_molecules(4, 10, 8)` (triplets for
DimeNet), the reference's weights (`*_init` at PRNGKey(0)) carried across
by `interop.gnn_params_from_reference`. Tolerances:

* forward at rtol = atol = 1e-5; DimeNet and MACE at 1e-4, because their
  contractions run in another order than the reference's einsums (DimeNet's
  bilinear step as mk @ w_bilin then a sum over b; MACE's Gaunt product as
  an outer product then one matrix product) and each block feeds the next;
* `gnn_loss` at rtol 1e-5, every gradient at rtol 1e-4 with an atol of
  1e-3 of each tensor's largest entry (as the LM gradients);
* one AdamW step (from the state the reference's first step leaves) at
  1e-5 for the loss and the moments, the parameters at rtol = atol = 1e-5
  and each tensor's update at relative norm 1e-3 (lr 1e-3 times Adam's
  normalised m / sqrt(v), which divides the gradients' differences by each
  element's own scale).

The invariances the reference's tests hold (MeshGraphNet under a node
relabelling, SchNet, DimeNet and MACE under a rotation) are held on the
port, and every forward is the same with `opt_einsum` switched off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import get_arch as ref_arch
from repro.models import equivariant as JE3
from repro.models import gnn_steps as JS
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_arch
from repro_torch.interop import (adamw_state_from_reference, gnn_named,
                                 gnn_params_from_reference)
from repro_torch.models import equivariant as E3
from repro_torch.models import gnn_steps as S

pytest_plugins = ["torch_jax_executables"]

ARCHS = ["meshgraphnet", "schnet", "dimenet", "mace"]
N_GRAPHS = 4
FWD_TOL = {"meshgraphnet": 1e-5, "schnet": 1e-5, "dimenet": 1e-4,
           "mace": 1e-4}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _batch(arch, seed=0):
    return S.batch_molecules(N_GRAPHS, 10, 8, seed=seed,
                             with_triplets=(arch == "dimenet"))


def _fwd(arch, cfg, model, batch):
    return S.FORWARD[arch][2](cfg, model, S.to_device(batch, "cpu"))


@pytest.fixture(scope="module")
def reference():
    """arch -> the reference's config, weights and results on the smoke
    batch: the forward, the loss and its gradients, and two train steps
    (the second from the first's state on the batch of seed 1)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = ref_arch(arch).build_smoke()
            _, init, fwd, _ = JS.FORWARD[arch]
            params = init(jcfg, jax.random.PRNGKey(0), 8)
            jb = _jbatch(_batch(arch))
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: JS.gnn_loss(arch, jcfg, p, jb, N_GRAPHS)))(params)
            step = jax.jit(JS.make_gnn_train_step(arch, jcfg, N_GRAPHS))
            p1, o1, _ = step(params, j_adamw_init(params), jb)
            p2, o2, loss2 = step(p1, o1, _jbatch(_batch(arch, seed=1)))
            cache[arch] = dict(
                params=_np(params), out=np.asarray(fwd(jcfg, params, jb)),
                loss=float(loss), grads=_np(grads), p1=_np(p1), o1=_np(o1),
                p2=_np(p2), o2=_np(o2), loss2=float(loss2))
        return cache[arch]
    return get


def _model(arch, ref):
    cfg = get_arch(arch).build_smoke()
    return cfg, gnn_params_from_reference(arch, ref["params"], cfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(reference, arch):
    ref = reference(arch)
    cfg, model = _model(arch, ref)
    assert sorted(n for n, _ in model.named_parameters()) == \
        sorted(gnn_named(ref["params"]))
    got = S.make_gnn_infer_step(arch, cfg)(
        model, S.to_device(_batch(arch), "cpu"))
    assert not got.requires_grad
    got = got.numpy()
    assert got.shape == (40,) and np.isfinite(got).all()
    tol = FWD_TOL[arch]
    np.testing.assert_allclose(got, ref["out"], rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(reference, arch):
    ref = reference(arch)
    cfg, model = _model(arch, ref)
    loss = S.gnn_loss(arch, cfg, model, S.to_device(_batch(arch), "cpu"),
                      N_GRAPHS)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    want = gnn_named(ref["grads"])
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4,
                                   atol=1e-3 * scale, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(reference, arch):
    """From the state the reference's first step leaves (non-zero moments,
    step 1), one step of each package on the batch of seed 1."""
    ref = reference(arch)
    cfg = get_arch(arch).build_smoke()
    model = gnn_params_from_reference(arch, ref["p1"], cfg, "cpu")
    state = adamw_state_from_reference(ref["o1"], gnn_named, "cpu")
    step = S.make_gnn_train_step(arch, cfg, N_GRAPHS)
    model, state, loss = step(model, state,
                              S.to_device(_batch(arch, seed=1), "cpu"))
    np.testing.assert_allclose(float(loss), ref["loss2"], rtol=1e-5)
    assert int(state["step"]) == int(ref["o2"]["step"]) == 2
    before, want_p = gnn_named(ref["p1"]), gnn_named(ref["p2"])
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want_p[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        moved, want_moved = got - before[name], want_p[name] - before[name]
        assert np.linalg.norm(moved - want_moved) \
            <= 1e-3 * np.linalg.norm(want_moved), name
    for key in ("mu", "nu"):
        want = gnn_named(ref["o2"][key])
        for name, m in state[key].items():
            np.testing.assert_allclose(m.numpy(), want[name], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{key} {name}")


def _rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


@pytest.mark.parametrize("arch,seed", [("schnet", 1), ("mace", 1),
                                       ("dimenet", 2)])
def test_rotation_invariance(reference, arch, seed):
    """E(3) invariance: rotating all positions leaves energies unchanged
    (the reference's rtol = atol = 1e-3)."""
    cfg, model = _model(arch, reference(arch))
    b = _batch(arch)
    b2 = dict(b, positions=(b["positions"] @ _rotation(seed).T)
              .astype(np.float32))
    with torch.no_grad():
        e1 = _fwd(arch, cfg, model, b).numpy()
        e2 = _fwd(arch, cfg, model, b2).numpy()
    np.testing.assert_allclose(e2, e1, rtol=1e-3, atol=1e-3)


def test_mgn_permutation_equivariance(reference):
    """Relabeling nodes permutes MeshGraphNet outputs identically."""
    cfg, model = _model("meshgraphnet", reference("meshgraphnet"))
    b = _batch("meshgraphnet")
    perm = np.random.default_rng(0).permutation(40)
    inv = np.argsort(perm)
    b2 = dict(b)
    for k in ("node_feat", "positions", "node_mask", "graph_id", "targets"):
        b2[k] = b[k][perm]
    b2["src"] = inv[b["src"]].astype(np.int32)
    b2["dst"] = inv[b["dst"]].astype(np.int32)
    with torch.no_grad():
        out = _fwd("meshgraphnet", cfg, model, b).numpy()
        out2 = _fwd("meshgraphnet", cfg, model, b2).numpy()
    np.testing.assert_allclose(out2, out[perm], rtol=1e-4, atol=1e-4)


class _LargestOutput(TorchDispatchMode):
    """The largest tensor (in elements) any operation returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_without_opt_einsum(reference, arch):
    """No contraction depends on opt_einsum's path: the forward is the same
    bit for bit with it switched off, and (DimeNet) no operation builds a
    tensor larger than (T, nb, H), as a left-to-right einsum's (T, H, H)
    would be."""
    cfg, model = _model(arch, reference(arch))
    b = _batch(arch)
    before = torch.backends.opt_einsum.enabled
    try:
        outs = []
        for enabled in (True, False):
            torch.backends.opt_einsum.enabled = enabled
            with torch.no_grad(), _LargestOutput() as seen:
                outs.append(_fwd(arch, cfg, model, b))
    finally:
        torch.backends.opt_einsum.enabled = before
    assert torch.equal(outs[0], outs[1])
    if arch == "dimenet":
        t = len(b["trip_kj"])
        assert seen.numel <= t * cfg.n_bilinear * cfg.d_hidden < \
            t * cfg.d_hidden * cfg.d_hidden


def test_gaunt_tensor_and_harmonics_equal_the_reference():
    np.testing.assert_array_equal(E3.gaunt_tensor(), JE3.gaunt_tensor())
    xyz = np.random.default_rng(4).normal(size=(64, 3))
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    np.testing.assert_array_equal(E3.real_sph_harm_l2(xyz, np_mod=np),
                                  JE3.real_sph_harm_l2(xyz, np_mod=np))
    x32 = xyz.astype(np.float32)
    np.testing.assert_allclose(
        E3.real_sph_harm_l2(torch.from_numpy(x32)).numpy(),
        np.asarray(JE3.real_sph_harm_l2(jnp.asarray(x32))),
        rtol=1e-6, atol=1e-7)
    assert E3.irrep_slices() == JE3.irrep_slices()
    assert (E3.SH_DIM, E3.IRREP_DIMS) == (JE3.SH_DIM, JE3.IRREP_DIMS)


def test_tensor_product_matches_reference():
    """The Gaunt product in the port's fixed order against the reference's
    einsum, (E, 9, C) float32, and the l = 0 channel invariant under a
    rotation of the harmonics it couples."""
    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(16, 9, 5)).astype(np.float32) for _ in range(2))
    g = E3.gaunt_tensor()
    got = E3.tensor_product(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(g).float()).numpy()
    want = np.asarray(JE3.tensor_product(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    v = rng.normal(size=(16, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    ys = [torch.from_numpy(E3.real_sph_harm_l2(x, np_mod=np)[..., None])
          for x in (v, v @ _rotation(3).T)]
    gt = torch.from_numpy(g)
    np.testing.assert_allclose(E3.tensor_product(ys[1], ys[1], gt)[:, 0],
                               E3.tensor_product(ys[0], ys[0], gt)[:, 0],
                               rtol=1e-6, atol=1e-9)
