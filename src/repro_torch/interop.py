"""State carried across from the reference package. Only numpy crosses
over; nothing here imports the reference.

* MCE has no weights: the engine's device state is the packed `RootBucket`
  (uint32 bitset words, bool X0 alive masks, int32 base sizes).
  `bucket_from_reference` moves one bucket's numpy arrays into the port's
  tensors and `bitset_rows_to_reference` maps the port's enumerated bitset
  rows back, bit for bit, so one bucket can be fed to both engines.
* The substrate models do: `transformer_params_from_reference`,
  `two_tower_params_from_reference` and `gnn_params_from_reference`
  build the port's modules from the reference's `init_params` /
  `*_init` pytrees (as numpy arrays), so both packages serve and train
  the same weights. Neither package reproduces the other's random draws.
* Training state: `transformer_named`, `two_tower_named` and `gnn_named`
  key a params-shaped pytree of the reference (its params, or its AdamW
  moments) by the port's parameter names, and
  `adamw_state_from_reference` builds the port's AdamW state from the
  reference's (`mu`, `nu`, `step`), so one step from one state can be
  compared across packages.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.engine.loop import bucket_tensors
from repro_torch.models import recsys as R
from repro_torch.models.gnn_steps import FORWARD as GNN_FORWARD
from repro_torch.models import transformer as T

BUCKET_KEYS = ("a", "p0", "x_rows", "x_alive0", "rsz0")


def bucket_from_reference(arrays: Dict[str, np.ndarray], device
                          ) -> Dict[str, torch.Tensor]:
    """The port's tensors for a reference bucket's arrays: `a`, `p0`,
    `x_rows` (uint32, viewed as int32), `x_alive0` (bool), `rsz0`
    (int32), keyed as given, on `device`."""
    return dict(zip(BUCKET_KEYS, bucket_tensors(
        *(arrays[k] for k in BUCKET_KEYS), device)))


def bitset_rows_to_reference(words: torch.Tensor) -> np.ndarray:
    """int32 bitset words (e.g. the port's enumerated `out_rows`) as the
    reference's uint32 words, bit for bit."""
    return words.cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                         dtype=dtype)


def transformer_params_from_reference(params_np: dict,
                                      cfg: T.TransformerConfig, device,
                                      dtype: Optional[torch.dtype] = None
                                      ) -> T.Transformer:
    """The port's `Transformer` for the reference's `init_params(cfg, key)`
    pytree as numpy float32 arrays: each stacked (n_layers, ...) leaf of
    `layers` split along dim 0 into the layers, matrices stored in `dtype`
    (cfg.dtype by default, the cast the reference makes at every use;
    float32 to train, as the reference stores them), norm weights
    float32, on `device`."""
    dt = dtype or T.compute_dtype(cfg)

    def leaf(name, a):
        return _tensor(a, torch.float32 if name in T.NORM_WEIGHTS else dt,
                       device)
    stacked = params_np["layers"]
    layers = [{name: leaf(name, a[i]) for name, a in stacked.items()}
              for i in range(cfg.n_layers)]
    head = params_np.get("lm_head")
    return T.Transformer(
        cfg, leaf("embed", params_np["embed"]), layers,
        leaf("ln_final", params_np["ln_final"]),
        None if head is None else leaf("lm_head", head))


def two_tower_params_from_reference(params_np: dict, cfg: R.TwoTowerConfig,
                                    device) -> R.TwoTower:
    """The port's `TwoTower` for the reference's `init_params(cfg, key)`
    pytree as numpy float32 arrays (tables, and each MLP's w{i} / b{i}),
    float32 on `device`."""
    def t(a):
        return _tensor(a, torch.float32, device)

    def mlp(p):
        n = sum(1 for k in p if k.startswith("w"))
        return R.MLP([t(p[f"w{i}"]) for i in range(n)],
                     [t(p[f"b{i}"]) for i in range(n)])
    return R.TwoTower(
        cfg, **{k: t(params_np[k]) for k in (
            "user_id_table", "item_id_table", "geo_table", "tag_table")},
        user_mlp=mlp(params_np["user_mlp"]),
        item_mlp=mlp(params_np["item_mlp"]))


def transformer_named(tree: dict, cfg: T.TransformerConfig
                      ) -> Dict[str, np.ndarray]:
    """A params-shaped pytree of the reference's transformer (params, or
    AdamW's mu / nu) keyed by the port's parameter names: `embed`,
    `layers.<i>.<leaf>` (dim 0 of each stacked leaf), `ln_final`,
    `lm_head` unless tied."""
    out = {"embed": tree["embed"]}
    for i in range(cfg.n_layers):
        out.update({f"layers.{i}.{name}": a[i]
                    for name, a in tree["layers"].items()})
    out["ln_final"] = tree["ln_final"]
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    return out


def two_tower_named(tree: dict) -> Dict[str, np.ndarray]:
    """A params-shaped pytree of the reference's two-tower model keyed by
    the port's parameter names: the four tables, `<tower>.w.<i>` and
    `<tower>.b.<i>` for each MLP's w{i} / b{i}."""
    out = {k: tree[k] for k in ("user_id_table", "item_id_table",
                                "geo_table", "tag_table")}
    for tower in ("user_mlp", "item_mlp"):
        for name, a in tree[tower].items():
            out[f"{tower}.{name[0]}.{name[1:]}"] = a
    return out


def gnn_named(tree) -> Dict[str, np.ndarray]:
    """A params-shaped pytree of a reference GNN (its `*_init` params, or
    AdamW's mu / nu) keyed by the port's parameter names: dict keys and
    list indices joined by dots (`blocks.<i>.…`, MACE's
    `blocks.<i>.w_prod.<j>`), each MLP's w{i} / b{i} as `w.<i>` /
    `b.<i>`."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                mlp = re.fullmatch(r"([wb])(\d+)", k)
                walk(v, prefix + (f"{mlp[1]}.{mlp[2]}" if mlp else k) + ".")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            out[prefix[:-1]] = node
    walk(tree, "")
    return out


# each GNN's first MLP, whose first weight's rows are d_feat
_GNN_INPUT = {"meshgraphnet": "enc_node", "schnet": "embed",
              "dimenet": "embed_node", "mace": "embed"}


def gnn_params_from_reference(arch: str, params_np: dict, cfg, device
                              ) -> torch.nn.Module:
    """The port's module for `arch` (a GNN) holding the reference's
    `*_init(cfg, key, d_feat)` pytree as numpy float32 arrays, float32 on
    `device`. The module's parameter names must be exactly `gnn_named`'s
    keys: `load_state_dict(strict=True)` raises otherwise."""
    _, init, _, _ = GNN_FORWARD[arch]
    d_feat = np.shape(params_np[_GNN_INPUT[arch]]["w0"])[0]
    model = init(cfg, torch.Generator(device=device), d_feat)
    model.load_state_dict({n: _tensor(a, torch.float32, device)
                           for n, a in gnn_named(params_np).items()},
                          strict=True)
    return model


def adamw_state_from_reference(opt_np: dict, named: Callable[[dict], Dict],
                               device) -> dict:
    """The port's AdamW state (`optim.adamw_init`'s layout) for the
    reference's `adamw_init` / `adamw_update` state as numpy: `mu` and
    `nu` keyed by `named` (`transformer_named` with its config,
    `two_tower_named` or `gnn_named`), float32 on `device`, and the int32
    step."""
    def moments(tree):
        return {n: _tensor(a, torch.float32, device)
                for n, a in named(tree).items()}
    return dict(mu=moments(opt_np["mu"]), nu=moments(opt_np["nu"]),
                step=torch.tensor(int(opt_np["step"]), dtype=torch.int32,
                                  device=device))
