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
  sum of their local shards, the counted matrix-product flops agree
  with MODEL_FLOPS (`launch/flops.py`) within the stated ratios, and the
  weight products and attention of the decode cell, of `chatglm3-6b`'s
  `train_4k` and `prefill_32k` and the expert products of
  `mixtral-8x7b`'s `train_4k` equal the shape count of the reference's
  layout within 1 %. `tools/dryrun_sweep.py --compare` on two summaries.
* The repairs, on 4 gloo ranks ((2, 2) mesh) from the reference's
  float32 weights: a MoE layer of 8 experts at 4 × 64 tokens (where
  DTensor's einsum views failed), the sharded prefill and one decode step
  (plain positions, frequencies and a validity mask beside DTensors), 20
  decode steps into a cache whose slots are split over "model", and the
  sharded loss and gradients of SchNet (its radial basis centres),
  DimeNet, MACE and MeshGraphNet (edges and triplets split over "data"),
  each against the reference at the sharding tests' tolerances.
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
GNN_ARCHS = ("schnet", "dimenet", "mace", "meshgraphnet")
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
# the decode cell's products by op: weights (mm) and attention (bmm)
mesh = make_production_mesh(device="cpu")
by_op = dryrun._measure(build_cell("qwen3-14b", "decode_32k", mesh),
                        mesh)["by_op"]
out["qwen3-14b"]["by_op"] = {k: by_op.get(k, [0, 0])[1]
                             for k in ("mm", "addmm", "bmm")}
print(json.dumps(out))
"""
# a fake 16×16 world of its own
WORLD = """
import json
from repro_torch.launch import dryrun
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_production_mesh
dryrun.join_fake_world(256)
mesh = make_production_mesh(device="cpu")
out = {}
"""


def _lm_by_op(code: str, cells) -> str:
    """`code` (which ends by printing `out`) first adding `out[arch/cell]`,
    the model flops and the matrix products by op of each LM cell."""
    head, tail = code.rsplit("print(", 1)
    return head + f"""
for arch, cell in {tuple(cells)!r}:
    prog = build_cell(arch, cell, mesh)
    by_op = dryrun._measure(prog, mesh)["by_op"]
    out[arch + "/" + cell] = dict(model=prog.model_flops, **{{
        k: by_op.get(k, [0, 0])[1] for k in ("mm", "addmm", "bmm")}})
""" + "print(" + tail


@pytest.fixture(scope="module")
def cells_16x16():
    """CELLS with chatglm3-6b `train_4k`'s products, then an LM prefill
    and a MoE train cell in a second fake world (each process well inside
    its time limit)."""
    out = _fake(_lm_by_op(CELLS, [("chatglm3-6b", "train_4k")]))
    return out | _fake(_lm_by_op(WORLD + "print(json.dumps(out))\n", [
        ("chatglm3-6b", "prefill_32k"), ("mixtral-8x7b", "train_4k")]))


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


def _chatglm3_rank_weights(tp=16):
    """chatglm3-6b's weights a rank multiplies under the rules' layout on
    a tp-wide "model" axis, each gathered over "data": (one layer's, its
    GLU output projection's, the head's). Its 32 heads divide 16, so q and
    the output projection split; its 2 KV heads stay whole."""
    from repro_torch.configs import get_arch
    cfg = get_arch("chatglm3-6b").build()
    assert cfg.n_heads % tp == 0 and not cfg.is_moe
    d, hd, f = cfg.d_model, cfg.d_head, cfg.d_ff
    layer = (2 * d * cfg.n_heads * hd // tp + 2 * d * cfg.n_kv_heads * hd
             + 3 * d * f // tp)
    return cfg, layer, d * f // tp, d * cfg.vocab // tp


def test_counted_flops_reconcile_with_model_flops(cells_16x16):
    """Per-rank matrix-product flops (torch's formulas on local shards)
    against MODEL_FLOPS. LM training, `chatglm3-6b` `train_4k`: the
    weight products of the forward and the backward summed over the 256
    ranks (the measured ones less the remat's recompute, whose shape
    count `test_lm_train_products_follow_the_reference_layout` holds)
    are 1.10x 6·N·D (the K/V projections of its 2 KV heads are replicated
    over the 16-wide model axis; attention's own products, `bmm`, lie
    outside 6·N·D). Serving, the two-tower's `serve_p99`: the batch is
    split over the 16 data ranks and replicated over the model axis, so
    the data ranks' products sum to the model's figure."""
    lm = cells_16x16["chatglm3-6b/train_4k"]
    cfg, layer, w_out, _ = _chatglm3_rank_weights()
    recompute = 2 * 16 * 4096 * cfg.n_layers * (layer - w_out)
    assert 1.0 <= (lm["mm"] - recompute) * 256 / lm["model"] <= 1.25
    serve = cells_16x16["two-tower-retrieval"]
    assert 0.95 <= serve["products"] * 16 / serve["model"] <= 1.05


def test_decode_products_follow_the_reference_layout(cells_16x16):
    """qwen3-14b `decode_32k` on 16×16 (batch 128, a 32,768-slot cache;
    `cache_spec`: batch over the 16 "data" ranks, slots over the 16
    "model" ranks): a rank's weight products take its 8 batch rows by
    every weight gathered over "data" and split over "model" where the
    rules split it (the GLU's d_ff and the head's vocab; qwen3's 40 heads
    do not divide 16, so its attention projections stay whole), 2 · 8 ·
    N_rank flops; its attention takes those rows over its own 2,048
    slots, 4 · 8 · 2,048 · H · d_head a layer. Both within 1 %: a layout
    that replicates the batch (16x), gathers the slots (16x) or leaves
    the GLU whole (4.1x) fails on any torch version."""
    from repro_torch.configs import get_arch
    cfg = get_arch("qwen3-14b").build()
    assert cfg.n_heads % 16 and not cfg.is_moe and not cfg.tie_embeddings
    b, c, tp = 128 // 16, 32768 // 16, 16
    d, hd = cfg.d_model, cfg.d_head
    per_layer = (d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
                 + 3 * d * cfg.d_ff // tp)
    n_rank = cfg.n_layers * per_layer + d * cfg.vocab // tp
    got = cells_16x16["qwen3-14b"]["by_op"]
    weights = got["mm"] + got["addmm"]
    attention = 4 * b * c * cfg.n_heads * hd * cfg.n_layers
    assert weights == pytest.approx(2 * b * n_rank, rel=0.01), got
    assert got["bmm"] == pytest.approx(attention, rel=0.01), got


def test_lm_train_products_follow_the_reference_layout(cells_16x16):
    """chatglm3-6b `train_4k` on 16×16 (batch 256 of 4,096 tokens: 16
    sequences, T = 65,536 tokens a rank): the weight products (`mm`) take
    a rank's rows by every weight gathered over "data" and split over
    "model" where the rules split it (q and the output projection by
    heads, the GLU by d_ff, the head by vocab; K and V whole), N_rank
    weights. Counted: the forward and the backward, 6·T·N_rank, and the
    remat's recompute of each layer ("nothing_saveable"; the checkpoint
    stops once the tensors the backward needs exist, before the GLU's
    output product), 2·T·(N_layers − L·d·d_ff/16): 2.097e14 a rank.
    Attention (`bmm`, the flash kernel's plain version on meta: every
    (query, key) pair, no causal skip) takes the rank's rows over its 2
    heads: two products of 2·B·H_rank·S²·d_head each forward, two again
    in the recompute and five in the backward (scores, dV, dP, dQ, dK),
    9 · 2·16·2·4,096²·128 a layer. Both within 1 %: a layout that splits
    K or V over "model", or leaves the GLU whole, fails on any torch
    version."""
    cfg, layer, w_out, head = _chatglm3_rank_weights()
    got = cells_16x16["chatglm3-6b/train_4k"]
    b, s, tp, n = 256 // 16, 4096, 16, cfg.n_layers
    t = b * s
    weights = 6 * t * (n * layer + head) + 2 * t * n * (layer - w_out)
    attention = 9 * 2 * b * (cfg.n_heads // tp) * s * s * cfg.d_head * n
    assert got["mm"] + got["addmm"] == pytest.approx(weights, rel=0.01), got
    assert got["bmm"] == pytest.approx(attention, rel=0.01), got


def test_lm_prefill_products_follow_the_reference_layout(cells_16x16):
    """chatglm3-6b `prefill_32k` on 16×16 (batch 32 of 32,768 tokens: 2
    sequences a rank, T = 65,536 tokens): the layers' weight products
    2·T·N_layers (the rules' layout, as in the train step) and the head
    on each sequence's last token, 2·2·d·V/16: 5.400e13 a rank.
    Attention, forward only: 2 · 2·B·H_rank·S²·d_head a layer (2 heads
    of 32 a rank). Both within 1 %."""
    cfg, layer, _, head = _chatglm3_rank_weights()
    got = cells_16x16["chatglm3-6b/prefill_32k"]
    b, s, n = 32 // 16, 32768, cfg.n_layers
    weights = 2 * b * s * n * layer + 2 * b * head
    attention = 2 * 2 * b * (cfg.n_heads // 16) * s * s * cfg.d_head * n
    assert got["mm"] + got["addmm"] == pytest.approx(weights, rel=0.01), got
    assert got["bmm"] == pytest.approx(attention, rel=0.01), got


def test_moe_expert_products_follow_the_reference_layout(cells_16x16):
    """mixtral-8x7b `train_4k` on 16×16: its 8 experts do not divide the
    16-wide "model" axis, so each expert's d_ff splits over it (`P(None,
    fsdp, tp)`), and a rank's 64 token groups of 1,024 (over "data") go
    through every expert on its 896 of 14,336 columns; the dispatch and
    combine products of its groups are whole (C = 320 slots an expert).
    `bmm`, counted: a group's dispatch and combine, X = 2·1,024·8·320·d
    each, and its three expert GLU products, H = 2·8·320·d·896 each, in
    the forward (2X + 3H), the remat's recompute (X + 3H: it stops before
    the combine) and the backward (X for the dispatch, whose routing has
    no gradient, 2X for the combine, 6H): 6X + 12H a group; plus the
    attention as chatglm3-6b's (9 products a layer over the rank's 2 of
    32 heads; the window of 4,096 holds the whole sequence). The
    routing's own einsums (under 0.1 %) are not counted. The weight
    products (`mm`: q, k, v, o, the router, the head; the K/V of 8 heads
    whole) as the dense count, all recomputed. Both within 1 %."""
    from repro_torch.configs import get_arch
    cfg = get_arch("mixtral-8x7b").build()
    tp, b, s, n = 16, 256 // 16, 4096, cfg.n_layers
    e, d, hd = cfg.n_experts, cfg.d_model, cfg.d_head
    assert e % tp and cfg.n_heads % tp == 0 and s <= cfg.sliding_window
    t, gs = b * s, cfg.moe_group_size
    c = -(-gs * cfg.top_k * cfg.capacity_factor // e)
    x = 2 * gs * e * c * d
    h = 2 * e * c * d * cfg.d_ff // tp
    attention = 9 * 2 * b * (cfg.n_heads // tp) * s * s * hd * n
    experts = n * (t // gs) * (6 * x + 12 * h)
    layer = (2 * d * cfg.n_heads * hd // tp + 2 * d * cfg.n_kv_heads * hd
             + d * e)
    weights = 6 * t * (n * layer + d * cfg.vocab // tp) + 2 * t * n * layer
    got = cells_16x16["mixtral-8x7b/train_4k"]
    assert got["bmm"] == pytest.approx(attention + experts, rel=0.01), got
    assert got["mm"] + got["addmm"] == pytest.approx(weights, rel=0.01), got


def test_sweep_compare_prints_the_cells_that_differ(tmp_path, capsys):
    """`tools/dryrun_sweep.py --compare A B` on two summaries: one line a
    cell whose matrix or all flops a rank differ (with B over A) or that
    one sweep lacks, none for equal cells; exit code 1 when any differ."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "dryrun_sweep", os.path.join(ROOT, "tools", "dryrun_sweep.py"))
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)

    def line(arch, ca, flops):
        return dict(arch=arch, cell="train_4k", mesh="16x16", ok=True,
                    flops_ca=ca, flops_per_device=flops)
    for name, lines in (("a", [line("x", 2.0, 3.0), line("y", 1.0, 1.0)]),
                        ("b", [line("x", 5.0, 6.0), line("y", 1.0, 1.0),
                               line("z", 1.0, 1.0)])):
        (tmp_path / name).mkdir()
        (tmp_path / name / "summary.jsonl").write_text("".join(
            json.dumps(ln) + "\n" for ln in lines + [dict(cells=3)]))
    assert sweep.main(["--compare", str(tmp_path / "a"),
                       str(tmp_path / "b" / "summary.jsonl")]) == 1
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [o["arch"] for o in out[:-1]] == ["x"]
    assert out[0]["flops_ca_ratio"] == 2.5
    assert out[0]["flops_per_device_ratio"] == 2.0
    assert out[-1] == dict(cells=2, equal=1, differ=1, only_in_a=[],
                           only_in_b=["z/train_4k/16x16"])
    assert sweep.main(["--compare", str(tmp_path / "a"),
                       str(tmp_path / "a")]) == 0


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

    # 20 decode steps from an empty 32-slot cache: the tokens cross from
    # one "model" rank's slots into the other's when the slots are split
    dec = jax.jit(JL.make_decode_step(rcfg))
    cache = JT.init_cache(rcfg, 2, 32)
    steps = np.random.default_rng(3).integers(
        0, rcfg.vocab, (20, 2, 1)).astype(np.int32)
    want = []
    for t in steps:
        logits, cache = dec(params, cache, jnp.asarray(t))
        want.append(np.asarray(logits))
    trees.update(lm_steps=steps, lm_steps_want=np.stack(want))

    for arch in GNN_ARCHS:
        jcfg = ref_arch(arch).build_smoke()
        _, init, _, _ = JS.FORWARD[arch]
        params = init(jcfg, jax.random.PRNGKey(0), 8)
        batch = S.batch_molecules(4, 10, 8, seed=0,
                                  with_triplets=arch == "dimenet")
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: JS.gnn_loss(arch, jcfg, p, jb, 4)))(params)
        trees.update({
            f"{arch}_params": gnn_named(jax.tree.map(np.asarray, params)),
            f"{arch}_batch": batch,
            f"{arch}_grads": gnn_named(jax.tree.map(np.asarray, grads)),
            f"{arch}_loss": np.asarray(loss)})
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

        spec = sh.cache_spec(cfg, 2, 32)
        cache = {{n: distribute(torch.zeros(
            (cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.d_head)), mesh, spec[n])
            for n in ("k", "v")}}
        cache["pos"] = 0
        worst = 0.0
        with torch.no_grad():
            for t, want in zip(z["lm_steps"], z["lm_steps_want"]):
                td = distribute(torch.from_numpy(t), mesh, sh.token_spec(2))
                dec, cache = T.decode_step(cfg, model, cache, td)
                worst = max(worst, rel(full(dec), want))
        report(tag="lm_steps", decode=worst, pos=cache["pos"],
               placements=repr(cache["k"].placements))

        for arch in {GNN_ARCHS!r}:
            cfg = get_arch(arch).build_smoke()
            model = S.FORWARD[arch][1](cfg, torch.Generator(), 8)
            model.load_state_dict({{n: torch.from_numpy(v) for n, v in
                                   load_tree(path, arch + "_params").items()}})
            shard_parameters(model, mesh,
                             {{n: P() for n, _ in model.named_parameters()}})
            batch = load_tree(path, arch + "_batch")
            sh = gnn_sharding(mesh, dict(
                n_nodes=batch["node_feat"].shape[0],
                n_edges=batch["src"].shape[0],
                n_triplets=batch["trip_kj"].shape[0] if "trip_kj" in batch
                else 0))
            bd = {{k: distribute(torch.from_numpy(v), mesh, sh.batch_specs[k])
                  for k, v in batch.items()}}
            loss = S.gnn_loss(arch, cfg, model, bd, 4)
            loss.backward()
            want = load_tree(path, arch + "_grads")
            bad = []
            for n, p in model.named_parameters():
                g, w = full(p.grad), want[n]
                scale = float(np.abs(w).max())
                if not np.allclose(g, w, rtol=1e-4, atol=1e-3 * scale):
                    bad.append(n)
            report(tag=arch, loss=float(full(loss)),
                   want_loss=float(z[arch + "_loss"]), bad=bad,
                   placements={{k: repr(bd[k].placements) for k in (
                       "src", "dst", "edge_mask", "trip_kj", "trip_ji",
                       "trip_mask") if k in bd}})
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


def test_sharded_decode_on_split_slots_matches_reference(four_rank_repairs):
    """20 decode steps from an empty 32-slot cache laid out by
    `cache_spec` (batch over "data", slots over "model"), each rank
    attending over its own slots and the new tokens written into the
    slots' owner: every step's logits at relative norm 1e-5 from the
    reference's."""
    for line in _line(four_rank_repairs, "lm_steps"):
        assert line["decode"] <= 1e-5 and line["pos"] == 20, line
        assert line["placements"] == "(Shard(dim=1), Shard(dim=2))", line


def _gnn_matches_reference(ranks, arch):
    """The reference's loss at rtol 1e-5 and its gradients at rtol 1e-4
    with atol 1e-3 of each tensor's scale, the edges (and DimeNet's
    triplets) split over "data"."""
    for line in _line(ranks, arch):
        assert abs(line["loss"] - line["want_loss"]) <= \
            1e-5 * abs(line["want_loss"]), line
        assert line["bad"] == [], line
        want = {"src", "dst", "edge_mask"} | (
            {"trip_kj", "trip_ji", "trip_mask"} if arch == "dimenet" else set())
        assert set(line["placements"]) == want, line
        for k, p in line["placements"].items():
            assert p.startswith("(Shard(dim=0)"), (k, line)


def test_schnet_sharded_loss_and_grads_match_reference(four_rank_repairs):
    """The edges split over "data", the radial basis' centres replicated
    beside them."""
    _gnn_matches_reference(four_rank_repairs, "schnet")


@pytest.mark.parametrize("arch", ["dimenet", "mace", "meshgraphnet"])
def test_gnn_sharded_loss_and_grads_match_reference(four_rank_repairs,
                                                    arch):
    """DimeNet (triplets split as the edges: its angular basis and
    bilinear step on each rank's triplets), MACE (its harmonics,
    messages and product basis on each rank's edges and atoms) and
    MeshGraphNet, as SchNet."""
    _gnn_matches_reference(four_rank_repairs, arch)
