"""Dry-run cell builders: (architecture × input shape × mesh) → a step
function and its arguments, the port of the reference's
`repro.launch.cells`.

For every cell this module produces a `CellProgram`: a step function plus
arguments on the meta device carrying the sharding rules' placements
(DTensors whose local shards are meta tensors), so building a cell never
allocates the (multi-TB) full-size arrays: `command-r-plus-104b`
`train_4k` with its AdamW state is 1.2 TB. The weights' shapes come from
each family's own `init_params` run under `FakeTensorMode` (its draws make
no data), then moved to meta. One builder per arch family.

The LM rules read a "model" axis, so LM cells need a mesh that has one
(the reference's too: its host mesh has only "data").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchSpec, ShapeCell, get_arch
from repro_torch.launch.mesh import data_axes
from repro_torch.sharding.spec import (P, distribute, shard_parameters,
                                       size_of, spec_of)


@dataclasses.dataclass
class CellProgram:
    arch: str
    cell: str
    kind: str
    fn: Callable                     # the step function
    args: Tuple[Any, ...]            # meta DTensors (or modules holding them)
    donate: Tuple[int, ...] = ()
    static: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # MODEL_FLOPS (useful work definition) for the roofline's utilisation row
    model_flops: float = 0.0
    note: str = ""


def _meta(shape, dtype, mesh, spec) -> DTensor:
    """A meta DTensor of the global `shape` laid out by `spec`."""
    return distribute(torch.empty(shape, dtype=dtype, device="meta"), mesh,
                      spec)


def _on_meta(build: Callable[[], nn.Module]) -> nn.Module:
    """The module `build()` makes, every parameter and buffer on meta:
    built under `FakeTensorMode`, so its draws allocate nothing."""
    with FakeTensorMode():
        module = build()
    for mod in module.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, nn.Parameter(torch.empty(
                p.shape, dtype=p.dtype, device="meta")))
        for name, b in list(mod.named_buffers(recurse=False)):
            mod.register_buffer(name, torch.empty(
                b.shape, dtype=b.dtype, device="meta"), persistent=False)
    return module


def _replicated(module: nn.Module, mesh) -> nn.Module:
    """Every parameter of `module` a replicated DTensor, in place."""
    return shard_parameters(module, mesh, {
        n: P() for n, _ in module.named_parameters()})


def _adamw_meta(module: nn.Module) -> dict:
    """`optim.adamw_init`'s state for `module`'s (DTensor) parameters:
    float32 moments laid out as each parameter, the step replicated."""
    def zeros():
        return {n: _meta(p.shape, torch.float32, p.device_mesh,
                         spec_of(p)) for n, p in module.named_parameters()}
    p0 = next(module.parameters())
    return dict(mu=zeros(), nu=zeros(),
                step=_meta((), torch.int32, p0.device_mesh, P()))


# ===========================================================================
# LM family
# ===========================================================================

def _lm_cell(spec: ArchSpec, cell: ShapeCell, mesh, cfg_map=None
             ) -> CellProgram:
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_steps import make_prefill_step, make_train_step
    from repro_torch.sharding.lm import lm_sharding, shard_transformer

    cfg = spec.build()
    if cfg_map is not None:
        cfg = cfg_map(cfg)
    dp = data_axes(mesh)
    sh = lm_sharding(cfg, mesh, dp_axes=dp)
    # float32 parameters, as the reference stores them
    params = shard_transformer(_on_meta(lambda: T.init_params(
        cfg, torch.Generator(), dtype=torch.float32)), sh)

    seq = cell.meta["seq_len"]
    batch = cell.meta["global_batch"]
    tok_spec = sh.token_spec(batch)

    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = _meta((batch, seq), torch.int32, mesh, tok_spec)
        targets = _meta((batch, seq), torch.int32, mesh, tok_spec)
        return CellProgram(spec.name, cell.name, "train",
                           make_train_step(cfg),
                           (params, _adamw_meta(params), tokens, targets),
                           donate=(0, 1),
                           model_flops=6.0 * n_active * batch * seq)
    if cell.kind == "prefill":
        tokens = _meta((batch, seq), torch.int32, mesh, tok_spec)
        return CellProgram(spec.name, cell.name, "prefill",
                           make_prefill_step(cfg), (params, tokens),
                           model_flops=2.0 * n_active * batch * seq)
    # decode: one new token against a seq_len KV cache
    c = T.cache_len(cfg, seq)
    kv_spec = sh.cache_spec(cfg, batch, c)
    shape = (cfg.n_layers, batch, c, cfg.n_kv_heads, cfg.d_head)
    dt = T.compute_dtype(cfg)
    # `decode_step` takes the position as an int: the reference's cell
    # decodes at its `init_cache`'s position, 0 (the work does not depend
    # on it: the cache length is fixed)
    cache = dict(k=_meta(shape, dt, mesh, kv_spec["k"]),
                 v=_meta(shape, dt, mesh, kv_spec["v"]), pos=0)
    token = _meta((batch, 1), torch.int32, mesh, tok_spec)

    def fn(p, c_, t):
        return T.decode_step(cfg, p, c_, t)
    return CellProgram(spec.name, cell.name, "decode", fn,
                       (params, cache, token), donate=(1,),
                       model_flops=2.0 * n_active * batch * 1)


# ===========================================================================
# GNN family
# ===========================================================================

def _gnn_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> CellProgram:
    from repro_torch.launch.flops import gnn_model_flops
    from repro_torch.models import gnn as G
    from repro_torch.models.gnn_steps import FORWARD, make_gnn_train_step
    from repro_torch.sharding.gnn import gnn_sharding

    cfg = spec.build()
    meta = dict(cell.meta)
    if spec.name != "dimenet":
        meta["n_triplets"] = 0
    dp = data_axes(mesh)
    sh = gnn_sharding(mesh, meta, dp_axes=dp)

    shapes = G.GraphShapes(n_nodes=meta["n_nodes"], n_edges=meta["n_edges"],
                           d_feat=meta["d_feat"],
                           n_triplets=meta.get("n_triplets", 0),
                           n_graphs=meta.get("n_graphs", 1))
    batch = {k: distribute(v, mesh, sh.batch_specs[k])
             for k, v in G.batch_spec(shapes).items()}

    _, init, _, _ = FORWARD[spec.name]
    params = _replicated(_on_meta(lambda: init(
        cfg, torch.Generator(), meta["d_feat"])), mesh)
    fn = make_gnn_train_step(spec.name, cfg, meta.get("n_graphs", 1))
    return CellProgram(spec.name, cell.name, "train", fn,
                       (params, _adamw_meta(params), batch), donate=(0, 1),
                       model_flops=gnn_model_flops(spec.name, cfg, meta))


# ===========================================================================
# Recsys family
# ===========================================================================

def _recsys_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> CellProgram:
    from repro_torch.launch.flops import recsys_model_flops
    from repro_torch.models import recsys as R
    from repro_torch.sharding.recsys import recsys_sharding, shard_two_tower

    cfg = spec.build()
    dp = data_axes(mesh)
    kind = {"train": "train", "serve": "serve", "bulk": "bulk",
            "retrieval": "retrieval"}[cell.kind]
    sh = recsys_sharding(cfg, mesh, kind, cell.meta, dp_axes=dp)
    params = shard_two_tower(_on_meta(lambda: R.init_params(
        cfg, torch.Generator())), sh)

    spec_map = R.batch_spec(cfg, kind, cell.meta.get("batch", 1),
                            n_candidates=cell.meta.get("n_candidates", 0))
    batch = {k: distribute(v, mesh, sh.batch_specs[k])
             for k, v in spec_map.items()}
    model_flops = recsys_model_flops(cfg, kind, cell.meta)
    if kind == "train":
        return CellProgram(spec.name, cell.name, "train",
                           R.make_train_step(cfg),
                           (params, _adamw_meta(params), batch),
                           donate=(0, 1), model_flops=model_flops)
    fn = {"serve": R.make_serve_step, "bulk": R.make_bulk_score_step,
          "retrieval": R.make_retrieval_step}[kind](cfg)
    return CellProgram(spec.name, cell.name, kind, fn, (params, batch),
                       model_flops=model_flops)


# ===========================================================================
# MCE (the paper's own arch)
# ===========================================================================

def mce_engine_config(cfg_arch):
    """The engine configuration an `rmce` cell runs its roots with: the
    arch's backend and dynamic reduction, counting only."""
    from repro_torch.core.engine import EngineConfig
    return EngineConfig(dynamic_red=cfg_arch.dynamic_red,
                        backend=cfg_arch.backend, out_cap=0,
                        max_iters=1 << 20)


def _mce_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> CellProgram:
    from repro_torch.core.driver import COUNTER_KEYS, _shard_counts

    dp = data_axes(mesh)
    n_shards = size_of(mesh, dp)
    m = cell.meta
    r, u, xc = m["roots_chunk"], m["u_pad"], m["x_pad"]
    w = u // 32
    ecfg = mce_engine_config(spec.build())
    sp = P(dp)
    # bitset words as the port holds them: int32 bit patterns of the
    # reference's uint32 words
    a = _meta((n_shards, r, u, w), torch.int32, mesh, sp)
    p0 = _meta((n_shards, r, w), torch.int32, mesh, sp)
    xr = _meta((n_shards, r, xc, w), torch.int32, mesh, sp)
    xa = _meta((n_shards, r, xc), torch.bool, mesh, sp)
    rz = _meta((n_shards, r), torch.int32, mesh, sp)
    groups = [mesh.get_group(ax) for ax in dp]

    def fn(a_, p_, x_, l_, z_):
        """Each rank runs its shard's chunk (`core.driver._shard_counts`,
        per root, on the device its arguments lie on); the int64 counters
        are summed over the data ranks, as the driver does. Returns
        {counter: int64 scalar tensor}."""
        local = [t.to_local() if isinstance(t, DTensor) else t
                 for t in (a_, p_, x_, l_, z_)]
        out = sum(_shard_counts(*(t[i] for t in local), ecfg, "perroot", 64)
                  for i in range(local[0].shape[0]))
        for g in groups:
            if dist.get_world_size(g) > 1:
                dist.all_reduce(out, group=g)
        return dict(zip(COUNTER_KEYS, out))

    # per while-iteration useful work: deg_P popcount rows over (U, W) words
    model_flops = float(n_shards * r * u * w)
    return CellProgram(spec.name, cell.name, "mce", fn, (a, p0, xr, xa, rz),
                       model_flops=model_flops,
                       note="flops counted per DFS iteration (while_loop "
                            "body), not per full enumeration")


# ===========================================================================
# Dispatcher
# ===========================================================================

def build_cell(arch: str, cell_name: str, mesh, cfg_map=None) -> CellProgram:
    """cfg_map (LM family only): transform the model config before
    building. `mesh` is a `DeviceMesh` whose axes the rules name."""
    spec = get_arch(arch)
    cfg = spec.build()
    cells = {c.name: c for c in spec.shapes(cfg)}
    cell = cells[cell_name]
    if cell.skip_reason:
        raise ValueError(f"cell {arch}/{cell_name} is skipped: "
                         f"{cell.skip_reason}")
    if spec.family == "lm":
        return _lm_cell(spec, cell, mesh, cfg_map=cfg_map)
    builder = {"gnn": _gnn_cell, "recsys": _recsys_cell,
               "mce": _mce_cell}[spec.family]
    return builder(spec, cell, mesh)


def input_specs(arch: str, cell_name: str, mesh):
    """Meta stand-ins (with placements) for every input of the cell's step
    function: the no-allocation dry-run contract."""
    return build_cell(arch, cell_name, mesh).args


def all_cells():
    """Yield (arch, cell_name, skip_reason|None) over the assignment matrix."""
    from repro_torch.configs import list_archs
    for arch in list_archs():
        spec = get_arch(arch)
        cfg = spec.build()
        for cell in spec.shapes(cfg):
            yield arch, cell.name, cell.skip_reason
