"""PyTorch port, the sharding rules (`repro_torch.sharding`), the meshes
(`launch/mesh.py`) and `TransformerConfig.shard_hints`, against the
reference.

* Every spec of `lm_sharding` (the five LM configs, with their token and
  cache specs at each LM cell's batch), `recsys_sharding` (four kinds)
  and `gnn_sharding` (each GNN cell) equals the reference's
  `PartitionSpec`, the layer specs without the reference's stacked-layer
  axis, on the mesh shapes (16, 16), (2, 16, 16), (1, 1), (2, 2) and
  (4, 1). The reference's rules read only `mesh.shape`, so both take the
  same `MeshShape` stand-in: no 512-device process.
* On a world of one, every LM's sharded forward with each hint variant
  is bit-equal to the unsharded one; under both remat policies a train
  step's `mm` are those of plain tensors ("dots" saves the pinned
  products' local `mm`: 6·T·N exactly).
* On 4 gloo ranks ((2, 2) mesh): each rank holds the slice each spec
  names; the sharded forward with each hint variant, and a MoE config
  with the ffn hint (smoke configs cut to one layer), matches the reference's float32 forward at relative
  norm 1e-5 and the unsharded port's within 1e-5 of the logits' largest
  magnitude, elementwise (partial sums over the ranks add in another
  order; 1e-5 absolute against the reference is beyond even the
  unsharded port, 1.7e-5 on chatglm3's logits and 3.0e-4 on
  command-r's, which reach 31.8); the row-sharded two-tower bags match
  the reference's within 1e-6 of their scale, the lookups exactly.
* On 4 gloo ranks, training from the reference's state after one step:
  each hint variant's sharded LM (heads, ctx, seq_res, a MoE with the ffn
  hint), the cells' own hint-less layout (a dense LM, a MoE with its
  experts over "model" and one whose experts do not divide it) and the
  two-tower with row-sharded tables give the reference's gradients
  (reduced to each parameter's layout) at rtol 1e-4 with atol 1e-3 of
  each tensor's scale, and one step its parameters at rtol 1e-5, atol
  3e-6 and its moments; `layers.pinned_matmul` alone gives the plain
  product's gradients, each laid out as its operand.
* The production meshes on a fake 256- and 512-rank group.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.configs.gnn_shapes import gnn_shapes as ref_gnn_shapes
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro.sharding import gnn as jgnn
from repro.sharding import lm as jlm
from repro.sharding import recsys as jrec
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import data_axes
from repro_torch.models import transformer as T
from repro_torch.sharding import (MeshShape, gnn_sharding, lm_sharding,
                                  opt_state_specs, placements,
                                  recsys_sharding)
from repro_torch.sharding.lm import shard_transformer
from repro_torch.sharding.spec import axes_of, distribute
from test_torch_driver_ranks import run_ranks
from torch_ranks import GLOO, save_trees, world_of_one  # noqa: F401

pytest_plugins = ["torch_jax_executables"]

ROOT = os.path.join(os.path.dirname(__file__), "..")
LM_ARCHS = ("chatglm3-6b", "command-r-plus-104b", "mixtral-8x7b",
            "phi3.5-moe-42b-a6.6b", "qwen3-14b")
GNN_ARCHS = ("dimenet", "mace", "meshgraphnet", "schnet")
MESHES = {
    "16x16": MeshShape(("data", "model"), (16, 16)),
    "2x16x16": MeshShape(("pod", "data", "model"), (2, 16, 16)),
    "1x1": MeshShape(("data", "model"), (1, 1)),
    "2x2": MeshShape(("data", "model"), (2, 2)),
    "4x1": MeshShape(("data", "model"), (4, 1)),
}
# (arch, shard_hints) of the 4-rank forward: every hint kind and field
HINTED = [
    ("chatglm3-6b", (("data",), "model", True)),                   # heads
    ("qwen3-14b", (("data",), "model", False, True)),              # ctx
    ("qwen3-14b", (("data",), "model", False)),                    # batch
    ("chatglm3-6b", (("data",), "model", False, False, False)),    # ZeRO
    ("command-r-plus-104b",
     (("data",), "model", True, False, True, True)),               # seq_res
    ("phi3.5-moe-42b-a6.6b", (("data",), "model", False, False, True)),
]


def norm(spec):
    """A spec of either package as a tuple of axis-name tuples."""
    return tuple(axes_of(e) for e in spec)


def assert_tree(got, want, layers=False):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            assert_tree(got[k], w, layers=k == "layers")
        else:
            # the port's layers are a ModuleList: no stacked-layer axis
            want_k = norm(w)[1:] if layers else norm(w)
            assert norm(got[k]) == want_k, k


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_lm_specs_match_reference(mesh):
    m = MESHES[mesh]
    dp = data_axes(m)
    for arch in LM_ARCHS:
        cfg, rcfg = get_arch(arch).build(), ref_arch(arch).build()
        got = lm_sharding(cfg, m, dp_axes=dp)
        want = jlm.lm_sharding(rcfg, m, dp_axes=dp)
        assert_tree(got.param_specs, want.param_specs)
        assert_tree(opt_state_specs(got), jlm.opt_state_specs(want))
        for cell in get_arch(arch).shapes(cfg):
            b, s = cell.meta["global_batch"], cell.meta["seq_len"]
            assert norm(got.token_spec(b)) == norm(want.token_spec(b))
            c = T.cache_len(cfg, s)
            g, w = got.cache_spec(cfg, b, c), want.cache_spec(rcfg, b, c)
            assert {k: norm(v) for k, v in g.items()} == \
                {k: norm(v) for k, v in w.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_recsys_and_gnn_specs_match_reference(mesh):
    m = MESHES[mesh]
    dp = data_axes(m)
    spec, rspec = get_arch("two-tower-retrieval"), ref_arch(
        "two-tower-retrieval")
    for cell in spec.shapes(spec.build()):
        got = recsys_sharding(spec.build(), m, cell.kind, cell.meta,
                              dp_axes=dp)
        want = jrec.recsys_sharding(rspec.build(), m, cell.kind, cell.meta,
                                    dp_axes=dp)
        assert_tree(got.param_specs, want.param_specs)
        assert_tree(got.batch_specs, want.batch_specs)
    for arch in GNN_ARCHS:
        for cell in ref_gnn_shapes(ref_arch(arch).build()):
            meta = dict(cell.meta)
            if arch != "dimenet":
                meta["n_triplets"] = 0
            got = gnn_sharding(m, meta, dp_axes=dp)
            want = jgnn.gnn_sharding(m, meta, dp_axes=dp)
            assert_tree(got.batch_specs, want.batch_specs)
            assert norm(got.param_spec) == norm(want.param_spec)


def test_placements_refuse_a_minor_to_major_entry(world_of_one):
    """On a (1, 1) mesh every axis splits nothing: each spec is replicated
    (the same layout as a split over one rank); a spec that names its
    axes minor to major, or an axis the mesh lacks, raises."""
    from torch.distributed.tensor import Replicate
    for spec in ((("data", "model"), None), (None, "model"), ()):
        assert placements(spec, world_of_one) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        placements((("model", "data"),), world_of_one)
    with pytest.raises(ValueError, match="not in the mesh"):
        placements(("pod",), world_of_one)


HINT_VARIANTS = [(("data",), "model", True),
                 (("data",), "model", False, True),
                 (("data",), "model", False, False, False, True)]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_hints_on_a_world_of_one_change_nothing(world_of_one, arch):
    """bf16 smoke weights: the forward of the model laid out by the rules
    (DTensors on a (1, 1) mesh) under each hint variant is bit-equal to
    the plain forward, and so are a hint config's plain tensors."""
    cfg = get_arch(arch).build_smoke()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, want_aux = T.forward(cfg, model, toks)
        for hints in HINT_VARIANTS:
            hcfg = dataclasses.replace(cfg, shard_hints=hints)
            got, _ = T.forward(hcfg, model, toks)
            assert torch.equal(got, want)
        sh = lm_sharding(hcfg, world_of_one)
        shard_transformer(model, sh)
        for hints in HINT_VARIANTS:
            hcfg = dataclasses.replace(cfg, shard_hints=hints)
            got, aux = T.forward(hcfg, model, distribute(
                toks, world_of_one, sh.token_spec(2)))
            assert torch.equal(got.full_tensor(), want), hints
            assert torch.equal(torch.as_tensor(aux).float(),
                               torch.as_tensor(want_aux).float())


@pytest.mark.parametrize("remat", ["dots", "nothing_saveable"])
def test_remat_sees_the_pinned_products(world_of_one, remat):
    """A train step's products under each remat policy, counted by the
    dry run's cost model, on the rules' layout (a world of one) and on
    plain tensors alike: the pinned products' local `mm` (`layers.
    pinned_matmul`) are the ops the "dots" policy saves, so its backward
    recomputes none and the step's weight products are 6·T·N exactly;
    "nothing_saveable" recomputes them, as on plain tensors."""
    from repro_torch.launch.cost import StepCost
    cfg = dataclasses.replace(get_arch("chatglm3-6b").build_smoke(),
                              remat=remat)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))

    def mm(model, t):
        with StepCost() as cost:
            T.lm_loss(cfg, model, t, t).backward()
        return cost.by_op["mm"][:2]
    plain = mm(T.init_params(cfg, torch.Generator().manual_seed(0),
                             dtype=torch.float32), toks)
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          dtype=torch.float32)
    sh = lm_sharding(cfg, world_of_one)
    shard_transformer(model, sh)
    assert mm(model, distribute(toks, world_of_one, sh.token_spec(2))) \
        == plain
    d, hd, f = cfg.d_model, cfg.d_head, cfg.d_ff
    n = cfg.n_layers * (2 * d * (cfg.n_heads + cfg.n_kv_heads) * hd
                        + 3 * d * f) + d * cfg.vocab
    if remat == "dots":
        assert plain[1] == 6 * toks.numel() * n
    else:
        assert plain[1] > 6 * toks.numel() * n


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One run of 4 gloo ranks on a (2, 2) mesh; its RESULT lines by
    rank."""
    tmp = tmp_path_factory.mktemp("sharding4")
    rng = np.random.default_rng(1)
    trees = {}
    for i, (arch, _) in enumerate(HINTED):
        rcfg = dataclasses.replace(ref_arch(arch).build_smoke(),
                                   dtype="float32", n_layers=1)
        params = jax.tree.map(np.asarray, JT.init_params(
            rcfg, jax.random.PRNGKey(i)))
        toks = rng.integers(0, rcfg.vocab, (2, 16)).astype(np.int32)
        logits, _ = jax.jit(JT.forward, static_argnums=0)(rcfg, params,
                                                          toks)
        trees[f"params{i}"] = params
        trees[f"toks{i}"] = toks
        trees[f"want{i}"] = np.asarray(logits)
    rcfg = ref_arch("two-tower-retrieval").build_smoke()
    rparams = jax.tree.map(np.asarray, JR.init_params(
        rcfg, jax.random.PRNGKey(0)))
    batch = JR.synth_batch(rcfg, 8, seed=2)
    trees["tt"] = {k: rparams[k] for k in ("item_id_table", "tag_table",
                                           "user_id_table")}
    trees["batch"] = batch
    trees["bags"] = {
        "hist": np.asarray(JR.embedding_bag(rparams["item_id_table"],
                                            batch["user_hist"])),
        "tags_sum": np.asarray(JR.embedding_bag(
            rparams["tag_table"], batch["item_tags"], mode="sum")),
        "uid": np.asarray(JR.embedding_lookup(rparams["user_id_table"],
                                              batch["user_id"]))}
    save_trees(tmp / "in.npz", **trees)
    ranks = run_ranks(tmp, 4, f"""
        import dataclasses
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_arch
        from repro_torch.interop import (sharded_transformer_from_reference,
                                         transformer_params_from_reference)
        from repro_torch.launch.mesh import data_axes, make_host_mesh
        from repro_torch.models import recsys as R
        from repro_torch.models import transformer as T
        from repro_torch.sharding import lm_sharding
        from repro_torch.sharding.spec import distribute
        path = {str(tmp / "in.npz")!r}
        host = make_host_mesh("cpu")
        report(host=[list(host.mesh_dim_names), host.size(),
                     list(data_axes(host))])
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        d, m = mesh.get_coordinate()
        full = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
        sizes = dict(data=2, model=2)
        coord = dict(data=d, model=m)
        for spec in [("data", "model", None), (("data", "model"),),
                     (None, None, "model"), ("model", "data"),
                     (None, ("data", "model"), None)]:
            want = full
            for dim, entry in enumerate(spec):
                axes = (entry,) if isinstance(entry, str) else entry or ()
                idx, n = 0, 1
                for a in axes:
                    idx, n = idx * sizes[a] + coord[a], n * sizes[a]
                size = full.shape[dim] // n
                want = want.narrow(dim, idx * size, size)
            got = distribute(full, mesh, spec).to_local()
            report(spec=repr(spec), ok=bool(torch.equal(got, want)))
        z = np.load(path)
        for i, (arch, hints) in enumerate({HINTED!r}):
            cfg = dataclasses.replace(get_arch(arch).build_smoke(),
                                      dtype="float32", n_layers=1,
                                      shard_hints=hints)
            sh = lm_sharding(cfg, mesh)
            model = sharded_transformer_from_reference(
                load_tree(path, f"params{{i}}"), cfg, sh)
            plain = transformer_params_from_reference(
                load_tree(path, f"params{{i}}"), cfg, "cpu")
            toks = torch.from_numpy(z[f"toks{{i}}"])
            with torch.no_grad():
                got, _ = T.forward(cfg, model, distribute(
                    toks, mesh, sh.token_spec(2)))
                one, _ = T.forward(cfg, plain, toks)
            got, one = got.full_tensor().numpy(), one.numpy()
            want = z[f"want{{i}}"]
            report(arch=arch, hints=repr(hints),
                   err=float(np.abs(got - one).max() / np.abs(one).max()),
                   rel=float(np.linalg.norm(got - want)
                             / np.linalg.norm(want)))
        from repro_torch.sharding.recsys import recsys_sharding
        cfg = get_arch("two-tower-retrieval").build_smoke()
        sh = recsys_sharding(cfg, mesh, "train", dict(batch=8))
        tt = load_tree(path, "tt")
        tables = {{k: distribute(torch.from_numpy(v), mesh,
                                sh.param_specs[k]) for k, v in tt.items()}}
        batch = {{k: distribute(torch.from_numpy(v), mesh,
                               sh.batch_specs[k])
                 for k, v in load_tree(path, "batch").items()}}
        bags = load_tree(path, "bags")
        got = dict(
            hist=R.embedding_bag(tables["item_id_table"],
                                 batch["user_hist"]),
            tags_sum=R.embedding_bag(tables["tag_table"],
                                     batch["item_tags"], "sum"),
            uid=R.embedding_lookup(tables["user_id_table"],
                                   batch["user_id"]))
        for k, t in got.items():
            g, w = t.full_tensor().numpy(), bags[k]
            report(bag=k, placements=repr(t.placements),
                   err=float(np.abs(g - w).max() / np.abs(w).max()),
                   exact=bool(np.array_equal(g, w)))
    """, prelude=GLOO)
    return ranks


def test_host_mesh_on_four_ranks(four_ranks):
    for res in four_ranks:
        assert res[0]["host"] == [["data"], 4, ["data"]]


def test_placements_give_each_rank_its_slice(four_ranks):
    for res in four_ranks:
        slices = [r for r in res if "spec" in r]
        assert len(slices) == 5 and all(r["ok"] for r in slices), slices


@pytest.mark.parametrize("i", range(len(HINTED)),
                         ids=[f"{a}-{len(h)}-{h[2]}" for a, h in HINTED])
def test_hinted_forward_on_four_ranks_matches_reference(four_ranks, i):
    for res in four_ranks:
        line = [r for r in res if "hints" in r][i]
        assert line["arch"] == HINTED[i][0]
        assert line["rel"] <= 1e-5 and line["err"] <= 1e-5, line


def test_row_sharded_bags_match_reference(four_ranks):
    """Each rank bags its table rows' ids; the partial bags summed over
    "model" match the reference's bags within 1e-6 of their scale (the
    float32 sum in another order), the one-id lookups exactly; the result
    laid out as the batch."""
    for res in four_ranks:
        bags = {r["bag"]: r for r in res if "bag" in r}
        assert sorted(bags) == ["hist", "tags_sum", "uid"]
        assert bags["hist"]["err"] <= 1e-6 and bags["tags_sum"]["err"] <= 1e-6
        assert bags["uid"]["exact"]
        assert bags["hist"]["placements"] == "(Shard(dim=0), Replicate())"


# (arch, shard_hints, config changes) of the 4-rank train steps: heads
# over "model", the query rows over "model" (context parallelism), Megatron
# sequence parallelism with heads, and the MoE FFN's F over "model"; then
# no hints, the cells' own layout (every weight product pinned by
# `layers.pinned_matmul` and `moe_ffn`'s experts): a dense model, a MoE
# whose 8 experts split over "model" (expert parallelism), and one whose 3
# experts do not divide it, so d_ff splits (as mixtral's 8 on 16). The
# MoE groups of 16 tokens split over "data".
STEPS = [
    ("chatglm3-6b", (("data",), "model", True), {}),               # heads
    ("qwen3-14b", (("data",), "model", False, True), {}),          # ctx
    ("command-r-plus-104b",
     (("data",), "model", True, False, True, True), {}),           # seq_res
    ("phi3.5-moe-42b-a6.6b", (("data",), "model", False, False, True), {}),
    ("chatglm3-6b", None, {}),
    ("phi3.5-moe-42b-a6.6b", None, dict(moe_group_size=16)),
    ("mixtral-8x7b", None, dict(n_experts=3, moe_group_size=16)),
]


def _step_id(arch, hints, changes):
    if hints is not None:
        return f"{arch}-{len(hints)}-{hints[2]}"
    return "-".join([arch, "rules"] + [f"{k}={v}" for k, v in changes.items()])


@pytest.fixture(scope="module")
def four_rank_steps(tmp_path_factory):
    """Training on 4 gloo ranks ((2, 2) mesh) from the reference's state
    after one step (non-zero moments): for each of STEPS, the gradients of
    `lm_loss` on the sharded model and one `make_train_step` (parameters
    and AdamW state laid out by `lm_sharding`, `shard_opt_state`); then
    the two-tower's, its tables row-sharded (`shard_two_tower`). Returns
    each rank's RESULT lines."""
    from repro.models import lm_steps as JS
    from repro.optim import adamw_init as j_adamw_init
    tmp = tmp_path_factory.mktemp("sharding4steps")
    rng = np.random.default_rng(3)
    trees = {}

    def keep(prefix, params, opt, grads, new, new_opt):
        trees.update({f"{prefix}p": params, f"{prefix}o": opt,
                      f"{prefix}g": grads, f"{prefix}w": new,
                      f"{prefix}m": dict(mu=new_opt["mu"],
                                         nu=new_opt["nu"])})
    for i, (arch, _, changes) in enumerate(STEPS):
        rcfg = dataclasses.replace(ref_arch(arch).build_smoke(),
                                   dtype="float32", n_layers=1, **changes)
        step = jax.jit(JS.make_train_step(rcfg))
        toks = rng.integers(0, rcfg.vocab, (2, 2, 16)).astype(np.int32)
        tgts = rng.integers(0, rcfg.vocab, (2, 2, 16)).astype(np.int32)
        params = JT.init_params(rcfg, jax.random.PRNGKey(10 + i))
        params, opt, _ = step(params, j_adamw_init(params), toks[0],
                              tgts[0])
        grads = jax.jit(jax.grad(lambda p: JT.lm_loss(
            rcfg, p, toks[1], tgts[1])))(params)
        new, new_opt, loss = step(params, opt, toks[1], tgts[1])
        keep(f"lm{i}", params, opt, grads, new, new_opt)
        trees[f"lm{i}toks"], trees[f"lm{i}tgts"] = toks[1], tgts[1]
        trees[f"lm{i}loss"] = np.float32(loss)
    rcfg = ref_arch("two-tower-retrieval").build_smoke()
    step = jax.jit(JR.make_train_step(rcfg))
    params = JR.init_params(rcfg, jax.random.PRNGKey(1))
    params, opt, _ = step(params, j_adamw_init(params),
                          JR.synth_batch(rcfg, 8, seed=4))
    batch = JR.synth_batch(rcfg, 8, seed=5)
    grads = jax.jit(jax.grad(lambda p: JR.retrieval_loss(
        rcfg, p, batch)))(params)
    new, new_opt, loss = step(params, opt, batch)
    keep("tt", params, opt, grads, new, new_opt)
    trees["ttbatch"], trees["ttloss"] = batch, np.float32(loss)
    save_trees(tmp / "in.npz", **jax.tree.map(np.asarray, trees))
    return run_ranks(tmp, 4, f"""
        import dataclasses
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor
        from repro_torch.configs import get_arch
        from repro_torch.interop import (
            adamw_state_from_reference, sharded_transformer_from_reference,
            transformer_named, two_tower_named,
            two_tower_params_from_reference)
        from repro_torch.models import recsys as R
        from repro_torch.models import transformer as T
        from repro_torch.models.lm_steps import make_train_step
        from repro_torch.optim.adamw import laid_out_as
        from repro_torch.sharding import lm_sharding, recsys_sharding
        from repro_torch.sharding.lm import shard_opt_state
        from repro_torch.sharding.recsys import named_specs, shard_two_tower
        from repro_torch.sharding.spec import distribute
        path = {str(tmp / "in.npz")!r}
        z = np.load(path)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))

        def full(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        def off(got, want):
            # (largest |got - want| over the largest |want|, relative
            # norm, ok): tests/test_torch_train_lm.py's gradient check,
            # rtol 1e-4 with atol 1e-3 of the scale, relative norm 5e-4
            got = full(got).detach().numpy()
            scale = float(np.abs(want).max())
            err = float(np.abs(got - want).max()) / (scale or 1.0)
            rel = (float(np.linalg.norm(got - want) / np.linalg.norm(want))
                   if scale else 0.0)
            ok = bool((np.abs(got - want)
                       <= 1e-4 * np.abs(want) + 1e-3 * scale).all()
                      and rel <= 5e-4)
            return err, rel, ok

        def compare(tag, model, loss_fn, state, step_fn, named, batch):
            loss = loss_fn(model, batch)
            loss.backward()
            want = named(load_tree(path, tag + "g"))
            placements, grad_bad, worst = set(), [], 0.0
            for n, p in model.named_parameters():
                g = laid_out_as(p.grad, p)
                placements.add(repr(p.placements))
                err, rel, ok = off(g, want[n])
                worst = max(worst, err)
                if not ok:
                    grad_bad.append([n, err, rel])
                p.grad = None
            model, state, loss2 = step_fn(model, state, batch)
            before = named(load_tree(path, tag + "p"))
            want = named(load_tree(path, tag + "w"))
            param_bad = []
            for n, p in model.named_parameters():
                got = full(p).detach().numpy()
                moved, should = got - before[n], want[n] - before[n]
                rel = float(np.linalg.norm(moved - should)
                            / np.linalg.norm(should))
                if not (np.allclose(got, want[n], rtol=1e-5, atol=3e-6)
                        and rel <= 1e-3):
                    param_bad.append([n, rel])
            moment_bad = []
            for key in ("mu", "nu"):
                want = named(load_tree(path, tag + "m")[key])
                for n, m in state[key].items():
                    if not off(m, want[n])[2]:
                        moment_bad.append([key, n])
            report(tag=tag, loss=float(full(loss)), loss2=float(full(loss2)),
                   want_loss=float(z[tag + "loss"]), grad_bad=grad_bad,
                   worst_grad=worst, param_bad=param_bad,
                   moment_bad=moment_bad, step=int(full(state["step"])),
                   placements=sorted(placements))

        for i, (arch, hints, changes) in enumerate({STEPS!r}):
            cfg = dataclasses.replace(get_arch(arch).build_smoke(),
                                      dtype="float32", n_layers=1,
                                      shard_hints=hints, **changes)
            sh = lm_sharding(cfg, mesh)
            model = sharded_transformer_from_reference(
                load_tree(path, f"lm{{i}}p"), cfg, sh, torch.float32)

            def named(tree):
                return transformer_named(tree, cfg)
            state = shard_opt_state(adamw_state_from_reference(
                load_tree(path, f"lm{{i}}o"), named, "cpu"), sh,
                cfg.n_layers)
            batch = [distribute(torch.from_numpy(z[f"lm{{i}}{{k}}"]), mesh,
                                sh.token_spec(2)) for k in ("toks", "tgts")]
            step = make_train_step(cfg)
            compare(f"lm{{i}}", model,
                    lambda m, b: T.lm_loss(cfg, m, *b), state,
                    lambda m, s, b: step(m, s, *b), named, batch)
        cfg = get_arch("two-tower-retrieval").build_smoke()
        sh = recsys_sharding(cfg, mesh, "train", dict(batch=8))
        model = shard_two_tower(two_tower_params_from_reference(
            load_tree(path, "ttp"), cfg, "cpu"), sh)
        specs = named_specs(sh)
        state = adamw_state_from_reference(load_tree(path, "tto"),
                                           two_tower_named, "cpu")
        state = dict(state, **{{k: {{n: distribute(t, mesh, specs[n])
                                   for n, t in state[k].items()}}
                               for k in ("mu", "nu")}})
        batch = {{k: distribute(torch.from_numpy(v), mesh, sh.batch_specs[k])
                 for k, v in load_tree(path, "ttbatch").items()}}
        compare("tt", model, lambda m, b: R.retrieval_loss(cfg, m, b), state,
                R.make_train_step(cfg), two_tower_named, batch)

        from repro_torch.models.layers import pinned_matmul
        from repro_torch.sharding.spec import P
        gen = torch.Generator().manual_seed(7)
        x, w1, w2, dy = (torch.randn(*shape, generator=gen) for shape in (
            (8, 6, 12), (12, 10), (10, 4), (8, 6, 4)))
        plain = [t.clone().requires_grad_() for t in (x, w1, w2)]
        ((plain[0] @ plain[1]) @ plain[2]).backward(dy)
        specs = (P("data", None, None), P("data", "model"), P("model", "data"))
        leaves = [distribute(t, mesh, sp).requires_grad_()
                  for t, sp in zip((x, w1, w2), specs)]
        mid = pinned_matmul(leaves[0], leaves[1])
        y = pinned_matmul(mid, leaves[2])
        (y.full_tensor() * dy).sum().backward()
        report(tag="pinned", mid=repr(mid.placements), y=repr(y.placements),
               out=off(y, ((x @ w1) @ w2).numpy())[0],
               grads=[[repr(t.placements), repr(t.grad.placements),
                       off(t.grad, p.grad.numpy())[0]]
                      for t, p in zip(leaves, plain)])
    """, prelude=GLOO)


@pytest.mark.parametrize("i", range(len(STEPS)),
                         ids=[_step_id(*s) for s in STEPS])
def test_sharded_train_step_on_four_ranks_matches_reference(
        four_rank_steps, i):
    """Each hint variant's sharded LM step, and the cells' own layout of a
    dense and two MoE models, on the (2, 2) mesh, from the reference's
    state after one step: every gradient (partial sums over the ranks
    that split the batch or the query rows, reduced to the parameter's
    layout) at tests/test_torch_train_lm.py's tolerance
    (rtol 1e-4 with atol 1e-3 of each tensor's scale, relative norm
    5e-4); the loss at 1e-5; then one `make_train_step`: the parameters
    at rtol 1e-5 and atol 3e-6 with each update at relative norm 1e-3,
    the moments at the gradients' tolerance, on every rank."""
    for res in four_rank_steps:
        line = [r for r in res if r["tag"] == f"lm{i}"][0]
        assert line["grad_bad"] == [], line
        assert line["param_bad"] == [] and line["moment_bad"] == [], line
        assert line["step"] == 2
        for k in ("loss", "loss2"):
            assert abs(line[k] - line["want_loss"]) <= 1e-5 * abs(
                line["want_loss"]), line
        # the layer weights are split over "model" (not all replicated)
        assert any("Shard" in p for p in line["placements"]), line


def test_row_sharded_two_tower_train_step_on_four_ranks(four_rank_steps):
    """The two-tower's train step with its tables row-sharded over "model"
    and the batch over "data": the tables' gradients (each rank's masked
    local bags' backward) and every other gradient, the step's
    parameters and moments, at the LM step's tolerances."""
    for res in four_rank_steps:
        line = [r for r in res if r["tag"] == "tt"][0]
        assert line["grad_bad"] == [] and line["param_bad"] == [], line
        assert line["moment_bad"] == [] and line["step"] == 2, line
        assert abs(line["loss"] - line["want_loss"]) <= 1e-5 * abs(
            line["want_loss"]), line
        assert "(Replicate(), Shard(dim=0))" in line["placements"], line


def test_pinned_matmul_gradients_on_four_ranks(four_rank_steps):
    """`layers.pinned_matmul` alone on the (2, 2) mesh: x (8, 6, 12) with
    its rows over "data", w1 (12, 10) laid out P("data", "model") (K over
    "data" as FSDP stores it, N over "model") and w2 (10, 4) P("model",
    "data") (K over "model": the output a partial sum). x @ w1 @ w2 and
    the gradients of x, w1 and w2 equal the plain products' within 1e-5
    of each one's largest magnitude, each gradient laid out as its
    operand: w1's reduced over the batch's ranks and scattered onto its
    "data" shards, where the local chunk of an unreduced sum would
    differ."""
    for res in four_rank_steps:
        line = [r for r in res if r["tag"] == "pinned"][0]
        assert line["mid"] == "(Shard(dim=0), Shard(dim=2))", line
        assert line["y"] == "(Shard(dim=0), Partial(sum))", line
        assert line["out"] <= 1e-5, line
        for place, grad_place, err in line["grads"]:
            assert grad_place == place and err <= 1e-5, line


FAKE = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import data_axes, make_production_mesh
out = {}
for multi, n in ((False, 256), (True, 512)):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    m = make_production_mesh(multi_pod=multi, device="cpu")
    out[str(multi)] = [list(m.mesh_dim_names), list(m.shape),
                       list(data_axes(m))]
    try:
        make_production_mesh(multi_pod=not multi, device="cpu")
    except ValueError as e:
        out[str(multi) + "_other"] = str(e)
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_production_meshes_on_a_fake_group():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", FAKE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["False"] == [["data", "model"], [16, 16], ["data"]]
    assert out["True"] == [["pod", "data", "model"], [2, 16, 16],
                           ["pod", "data"]]
    assert "needs 512 ranks" in out["False_other"]
    assert "needs 256 ranks" in out["True_other"]
