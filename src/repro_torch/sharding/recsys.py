"""Sharding rules for the two-tower recsys stack, the port of the
reference's `repro.sharding.recsys`, as the port's specs.

Production layout (TorchRec/DLRM row-wise sharding):

* **Embedding tables row-shard over "model"** — the tables are the memory
  (user_id: 33.5M × 128 = 17GB fp32; item_id 8.6GB). A lookup in a
  row-sharded table is a masked local bag plus a sum over "model", as in
  Megatron's vocab-parallel embedding (`models.recsys.embedding_bag` and
  `embedding_lookup` on a DTensor table).
* **Batch shards over (pod, data)** — towers are data-parallel.
* **Tower MLPs replicate** (~2M params); the in-batch softmax logits
  matrix (B × B) shards rows over dp.
* ``retrieval_cand``: the 1M-candidate corpus shards over the data axes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from torch.distributed.tensor import Placement

from repro_torch.models.recsys import TwoTower, TwoTowerConfig
from repro_torch.sharding.spec import (P, Spec, placements, shard_parameters,
                                       size_of)

TABLES = ("user_id_table", "item_id_table", "geo_table", "tag_table")


@dataclasses.dataclass
class RecsysSharding:
    mesh: object                   # a DeviceMesh, or a MeshShape stand-in
    dp: Tuple[str, ...]
    table_axis: str
    param_specs: dict
    batch_specs: Dict[str, Spec]

    def placements(self, spec: Spec) -> Tuple[Placement, ...]:
        return placements(spec, self.mesh)


def recsys_sharding(cfg: TwoTowerConfig, mesh, kind: str, meta: dict,
                    dp_axes: Tuple[str, ...] = ("data",),
                    table_axis: str = "model") -> RecsysSharding:
    dp_size = size_of(mesh, dp_axes)

    n_mlp = len(cfg.tower_mlp)
    mlp_spec = {f"w{i}": P(None, None) for i in range(n_mlp)} | \
               {f"b{i}": P(None) for i in range(n_mlp)}
    params = dict(
        user_id_table=P(table_axis, None),
        item_id_table=P(table_axis, None),
        geo_table=P(table_axis, None),
        tag_table=P(table_axis, None),
        user_mlp=mlp_spec,
        item_mlp=mlp_spec,
    )

    batch = meta.get("batch", 1)
    row = P(dp_axes) if batch % dp_size == 0 else P(None)
    specs = dict(
        user_id=row,
        user_geo=row,
        user_hist=P(*row, None),
        user_dense=P(*row, None),
    )
    if kind in ("train", "bulk"):
        specs |= dict(item_id=row, item_tags=P(*row, None))
    elif kind == "serve":
        specs |= dict(cand_emb=P(*row, None, None))
    elif kind == "retrieval":
        c = meta["n_candidates"]
        cspec = P(dp_axes) if c % dp_size == 0 else P(None)
        specs |= dict(cand_id=cspec, cand_tags=P(*cspec, None))
    return RecsysSharding(mesh=mesh, dp=dp_axes, table_axis=table_axis,
                          param_specs=params, batch_specs=specs)


def named_specs(sharding: RecsysSharding) -> Dict[str, Spec]:
    """`param_specs` keyed by the port's parameter names (the tables,
    `<tower>.w.<i>`, `<tower>.b.<i>`)."""
    sp = sharding.param_specs
    out = {k: sp[k] for k in TABLES}
    for tower in ("user_mlp", "item_mlp"):
        out.update({f"{tower}.{k[0]}.{k[1:]}": v
                    for k, v in sp[tower].items()})
    return out


def shard_two_tower(model: TwoTower, sharding: RecsysSharding) -> TwoTower:
    """Lay `model`'s parameters out by `sharding` on its `DeviceMesh`, in
    place (`spec.shard_parameters`): the tables row-sharded, the towers
    replicated. Returns the model."""
    return shard_parameters(model, sharding.mesh, named_specs(sharding))
