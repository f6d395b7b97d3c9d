"""The port's dry run (`launch/dryrun.py`), its cost model (`launch/cost.py`)
and the repairs the dry run needed, against the reference.

* `collective_link_bytes` is the reference's ring model, kind for kind.
* On a fake world (`FakeStore`, backend "fake", in a subprocess each with
  a 120 s timeout): a 4-rank matmul laid out as the reference's
  `test_sharded_collectives_counted` records its all-gather at the
  expected bytes; the kernel wrappers take meta tensors only inside
  `kernels.shapes_only()`; `dryrun.main()` runs `schnet` `full_graph_sm`
  on 2×16×16 (the twin of the reference's multi-pod entry point test);
  on 16×16, `qwen3-14b` `decode_32k`, `two-tower-retrieval` `serve_p99`
  and `rmce` `web_sparse` come out `ok` with argument bytes equal to the
  sum of their local shards, and the counted matrix-product flops agree
  with MODEL_FLOPS (`launch/flops.py`) within the stated ratios.
* The repairs, on 4 gloo ranks ((2, 2) mesh) from the reference's
  float32 weights: a MoE layer of 8 experts at 4 × 64 tokens (where
  DTensor's einsum views failed), the sharded prefill and one decode step
  (plain positions, frequencies and a validity mask beside DTensors), and
  SchNet's sharded loss and gradients (its radial basis centres), each
  against the reference at the sharding tests' tolerances.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as ref_arch
from repro.launch.hlo_cost import collective_link_bytes as ref_link_bytes
from repro.models import gnn_steps as JS
from repro.models import lm_steps as JL
from repro.models import transformer as JT
from repro_torch.interop import gnn_named
from repro_torch.launch.cost import collective_link_bytes
from repro_torch.models import gnn_steps as S
from test_torch_driver_ranks import run_ranks
from torch_ranks import GLOO, save_trees

pytest_plugins = ["torch_jax_executables"]

ROOT = os.path.join(os.path.dirname(__file__), "..")
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")


@pytest.mark.parametrize("kind", KINDS)
def test_collective_link_bytes_match_reference(kind):
    for g in (1, 2, 4, 16):
        for size in (100, 12_345, 1 << 30):
            assert collective_link_bytes(kind, size, g) == \
                pytest.approx(ref_link_bytes(kind, size, g)), (kind, g, size)


def _fake(code: str):
    """Run `code` in a fresh interpreter (the fake world is per process);
    its last stdout line, parsed as JSON."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


MATMUL = """
import json, types, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.kernels import _build, shapes_only
from repro_torch.kernels.embedding_bag import ops as bag
from repro_torch.launch.cost import StepCost
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
x = distribute_tensor(torch.empty(1024, 512, device="meta"), mesh, [Shard(0)])
w = distribute_tensor(torch.empty(512, 512, device="meta"), mesh, [Shard(1)])
with StepCost() as cost:
    y = (x @ w).redistribute(mesh, [Shard(0)])
out = dict(cost.totals(), placements=repr(y.placements),
           local=list(y.to_local().shape))
table = torch.empty(10, 4, device="meta")
ids = torch.zeros(3, 2, dtype=torch.int32, device="meta")
refused = []
try:
    bag.embedding_bag(table, ids)
except ValueError:
    refused.append("outside")
with shapes_only():
    got = bag.embedding_bag(table, ids)
    mixed = _build.on_cpu(table, torch.zeros(1))
    card = _build.on_cpu(types.SimpleNamespace(
        device=torch.device("cuda", 0)))
    try:
        _build.on_cpu(table, types.SimpleNamespace(
            device=torch.device("cuda", 0)))
    except ValueError:
        refused.append("cuda+meta")
out.update(refused=refused, meta=[list(got.shape), got.device.type],
           mixed=mixed, card=card)
print(json.dumps(out))
"""


def test_matmul_collectives_and_the_meta_scope():
    """x (1024, 512) split by rows and w (512, 512) by columns on 4 ranks,
    the output split by rows (the reference's test's layout): each rank
    gathers w, 512 * 512 float32 bytes at the ring's 3/4 on the link, and
    multiplies its (256, 512) rows. The wrappers take meta tensors only
    inside the scope; a CUDA tensor never takes the plain version."""
    out = _fake(MATMUL)
    coll = out["collectives"]
    assert set(coll) == {"all-gather"}, coll
    assert coll["all-gather"]["count"] == 1
    assert coll["all-gather"]["bytes"] == 512 * 512 * 4
    assert coll["all-gather"]["link_bytes"] == pytest.approx(
        0.75 * 512 * 512 * 4)
    assert out["matmul_flops"] == 2 * 256 * 512 * 512
    assert out["local"] == [256, 512]
    assert out["refused"] == ["outside", "cuda+meta"]
    assert out["meta"] == [[3, 4], "meta"]
    assert out["mixed"] is True and out["card"] is False


def test_dryrun_main_multipod():
    """`dryrun.main()` on `schnet` `full_graph_sm` over 2x16x16 (512 fake
    ranks) returns 0: the twin of the reference's entry point test."""
    out = _fake("""
import json, sys, tempfile
from repro_torch.launch import dryrun
d = tempfile.mkdtemp()
rc = dryrun.main(["--arch", "schnet", "--shape", "full_graph_sm",
                  "--multi-pod", "on", "--out", d])
rec = json.load(open(d + "/schnet__full_graph_sm__2x16x16.json"))
print(json.dumps(dict(rc=rc, rec=rec)))
""")
    rec = out["rec"]
    assert out["rc"] == 0
    assert rec["ok"] and rec["n_devices"] == 512 and rec["mesh"] == "2x16x16"
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collectives"] and rec["bottleneck"] in (
        "compute", "memory", "collective")


CELLS = """
import json
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten
from repro_torch.launch import dryrun
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_production_mesh

def shard_bytes(args):
    total = 0
    for a in args:
        leaves = ([*a.parameters(), *a.buffers()] if isinstance(a, nn.Module)
                  else tree_flatten(a)[0])
        for t in leaves:
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total

out = {}
for arch, cell in (("qwen3-14b", "decode_32k"),
                   ("two-tower-retrieval", "serve_p99"),
                   ("rmce", "web_sparse")):
    rec = dryrun.run_cell(arch, cell, False)
    prog = build_cell(arch, cell, make_production_mesh(device="cpu"))
    pos = prog.args[1].get("pos") if prog.kind == "decode" else None
    out[arch] = dict(ok=rec.ok, error=(rec.error or "")[-1500:],
                     kind=rec.kind, args=rec.argument_bytes,
                     shards=shard_bytes(prog.args), products=rec.flops_ca,
                     flops=rec.flops_per_device, model=rec.model_flops,
                     link=rec.link_bytes_per_device, pos=pos,
                     bottleneck=rec.bottleneck)
# the weight products (mm, addmm) of one LM train step, by op
mesh = make_production_mesh(device="cpu")
prog = build_cell("chatglm3-6b", "train_4k", mesh)
by_op = dryrun._measure(prog, mesh)["by_op"]
out["chatglm3-6b"] = dict(model=prog.model_flops, mm=sum(
    by_op.get(k, [0, 0])[1] for k in ("mm", "addmm")))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells_16x16():
    return _fake(CELLS)


@pytest.mark.parametrize("arch", ["qwen3-14b", "two-tower-retrieval",
                                  "rmce"])
def test_cells_ok_with_their_argument_bytes(cells_16x16, arch):
    rec = cells_16x16[arch]
    assert rec["ok"], rec["error"]
    assert rec["args"] == rec["shards"] > 0
    assert rec["flops"] > 0 and rec["bottleneck"]


def test_decode_cell_position_is_an_int(cells_16x16):
    """The decode cell gives `decode_step` the int it documents: the
    reference's cell decodes at its `init_cache`'s position, 0."""
    assert cells_16x16["qwen3-14b"]["pos"] == 0


def test_rmce_cell_costs_one_step_and_the_counter_reduce(cells_16x16):
    rec = cells_16x16["rmce"]
    assert rec["kind"] == "mce" and rec["link"] > 0


def test_counted_flops_reconcile_with_model_flops(cells_16x16):
    """Per-rank matrix-product flops (torch's formulas on local shards)
    against MODEL_FLOPS. LM training, `chatglm3-6b` `train_4k`: the
    weight products summed over the 256 ranks are 1.18x 6·N·D (the K/V
    projections of its 2 KV heads are replicated over the 16-wide model
    axis; attention's own products, `bmm`, lie outside 6·N·D). Serving,
    the two-tower's `serve_p99`: the batch is split over the 16 data ranks
    and replicated over the model axis, so the data ranks' products sum
    to the model's figure."""
    lm = cells_16x16["chatglm3-6b"]
    assert 1.0 <= lm["mm"] * 256 / lm["model"] <= 1.25
    serve = cells_16x16["two-tower-retrieval"]
    assert 0.95 <= serve["products"] * 16 / serve["model"] <= 1.05


# ---------------------------------------------------------------------------
# the repairs, on 4 gloo ranks against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def four_rank_repairs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("repairs4")
    trees = {}
    rcfg = dataclasses.replace(ref_arch("mixtral-8x7b").build_smoke(),
                               dtype="float32", n_layers=1, n_experts=8,
                               moe_group_size=64)
    params = jax.tree.map(np.asarray, JT.init_params(rcfg,
                                                     jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(
        0, rcfg.vocab, (4, 64)).astype(np.int32)
    logits, _ = JT.forward(rcfg, params, toks)
    loss = JT.lm_loss(rcfg, params, toks, toks)
    trees.update(moe_params=params, moe_toks=toks,
                 moe_want=np.asarray(logits), moe_loss=np.asarray(loss))

    rcfg = dataclasses.replace(ref_arch("qwen3-14b").build_smoke(),
                               dtype="float32", n_layers=1)
    params = jax.tree.map(np.asarray, JT.init_params(rcfg,
                                                     jax.random.PRNGKey(1)))
    toks = np.random.default_rng(1).integers(
        0, rcfg.vocab, (2, 16)).astype(np.int32)
    nxt = np.random.default_rng(2).integers(
        0, rcfg.vocab, (2, 1)).astype(np.int32)
    last, cache = JL.make_prefill_step(rcfg)(params, toks)
    dec, _ = JL.make_decode_step(rcfg)(params, cache, nxt)
    trees.update(lm_params=params, lm_toks=toks, lm_next=nxt,
                 lm_prefill=np.asarray(last), lm_decode=np.asarray(dec))

    jcfg = ref_arch("schnet").build_smoke()
    _, init, _, _ = JS.FORWARD["schnet"]
    params = init(jcfg, jax.random.PRNGKey(0), 8)
    batch = S.batch_molecules(4, 10, 8, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: JS.gnn_loss("schnet", jcfg, p, jb, 4))(params)
    trees.update(schnet_params=gnn_named(jax.tree.map(np.asarray, params)),
                 schnet_batch=batch,
                 schnet_grads=gnn_named(jax.tree.map(np.asarray, grads)),
                 schnet_loss=np.asarray(loss))
    save_trees(tmp / "in.npz", **trees)
    return run_ranks(tmp, 4, f"""
        import dataclasses
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_arch
        from repro_torch.interop import sharded_transformer_from_reference
        from repro_torch.models import gnn_steps as S
        from repro_torch.models import lm_steps
        from repro_torch.models import transformer as T
        from repro_torch.sharding import gnn_sharding, lm_sharding
        from repro_torch.sharding.spec import P, distribute, shard_parameters
        path = {str(tmp / "in.npz")!r}
        z = np.load(path)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))

        def full(t):
            if hasattr(t, "full_tensor"):
                t = t.full_tensor()
            return t.detach().numpy()

        def rel(got, want):
            return float(np.linalg.norm(got - want) / np.linalg.norm(want))

        def lm(tag, arch, **kw):
            cfg = dataclasses.replace(get_arch(arch).build_smoke(),
                                      dtype="float32", n_layers=1, **kw)
            sh = lm_sharding(cfg, mesh)
            model = sharded_transformer_from_reference(
                load_tree(path, tag + "_params"), cfg, sh)
            toks = torch.from_numpy(z[tag + "_toks"])
            return cfg, sh, model, distribute(toks, mesh,
                                              sh.token_spec(toks.shape[0]))

        cfg, sh, model, td = lm("moe", "mixtral-8x7b", n_experts=8,
                                moe_group_size=64)
        with torch.no_grad():
            logits, _ = T.forward(cfg, model, td)
        loss = T.lm_loss(cfg, model, td, td)
        loss.backward()
        finite = all(bool(np.isfinite(full(p.grad)).all())
                     for p in model.parameters() if p.grad is not None)
        report(tag="moe", rel=rel(full(logits), z["moe_want"]),
               loss=float(full(loss)), want_loss=float(z["moe_loss"]),
               finite=finite)

        cfg, sh, model, td = lm("lm", "qwen3-14b")
        with torch.no_grad():
            last, cache = lm_steps.make_prefill_step(cfg)(model, td)
            nxt = distribute(torch.from_numpy(z["lm_next"]), mesh,
                             sh.token_spec(2))
            dec, cache = T.decode_step(cfg, model, cache, nxt)
        report(tag="lm", prefill=rel(full(last), z["lm_prefill"]),
               decode=rel(full(dec), z["lm_decode"]), pos=cache["pos"])

        cfg = get_arch("schnet").build_smoke()
        model = S.FORWARD["schnet"][1](cfg, torch.Generator(), 8)
        model.load_state_dict({{n: torch.from_numpy(v) for n, v in
                               load_tree(path, "schnet_params").items()}})
        shard_parameters(model, mesh,
                         {{n: P() for n, _ in model.named_parameters()}})
        batch = load_tree(path, "schnet_batch")
        sh = gnn_sharding(mesh, dict(n_nodes=batch["node_feat"].shape[0],
                                     n_edges=batch["src"].shape[0]))
        bd = {{k: distribute(torch.from_numpy(v), mesh, sh.batch_specs[k])
              for k, v in batch.items()}}
        loss = S.gnn_loss("schnet", cfg, model, bd, 4)
        loss.backward()
        want = load_tree(path, "schnet_grads")
        bad = []
        for n, p in model.named_parameters():
            g, w = full(p.grad), want[n]
            scale = float(np.abs(w).max())
            if not np.allclose(g, w, rtol=1e-4, atol=1e-3 * scale):
                bad.append(n)
        report(tag="schnet", loss=float(full(loss)),
               want_loss=float(z["schnet_loss"]), bad=bad,
               placements=repr(bd["src"].placements))
    """, prelude=GLOO)


def _line(ranks, tag):
    return [[r for r in res if r["tag"] == tag][0] for res in ranks]


def test_moe_experts_on_four_ranks_match_reference(four_rank_repairs):
    """8 experts at 4 x 64 tokens on a (2, 2) mesh: the einsums whose
    DTensor views failed (a permuted product's global strides against its
    local shard; an expert or capacity dim split unevenly) give the
    reference's float32 logits at relative norm 1e-5 and its loss, and
    the backward runs to finite gradients."""
    for line in _line(four_rank_repairs, "moe"):
        assert line["rel"] <= 1e-5, line
        assert abs(line["loss"] - line["want_loss"]) <= \
            1e-5 * abs(line["want_loss"]), line
        assert line["finite"], line


def test_sharded_prefill_and_decode_match_reference(four_rank_repairs):
    for line in _line(four_rank_repairs, "lm"):
        assert line["prefill"] <= 1e-5 and line["decode"] <= 1e-5, line
        assert line["pos"] == 17, line


def test_schnet_sharded_loss_and_grads_match_reference(four_rank_repairs):
    """The edges split over "data", the radial basis' centres replicated
    beside them: the reference's loss at rtol 1e-5 and its gradients at
    rtol 1e-4 with atol 1e-3 of each tensor's scale."""
    for line in _line(four_rank_repairs, "schnet"):
        assert abs(line["loss"] - line["want_loss"]) <= \
            1e-5 * abs(line["want_loss"]), line
        assert line["bad"] == [], line
        assert "Shard(dim=0)" in line["placements"], line
