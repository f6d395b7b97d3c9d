"""State carried across from the reference package. Only numpy crosses
over; nothing here imports the reference.

* MCE has no weights: the engine's device state is the packed `RootBucket`
  (uint32 bitset words, bool X0 alive masks, int32 base sizes).
  `bucket_from_reference` moves one bucket's numpy arrays into the port's
  tensors and `bitset_rows_to_reference` maps the port's enumerated bitset
  rows back, bit for bit, so one bucket can be fed to both engines.
* The substrate models do: `transformer_params_from_reference` and
  `two_tower_params_from_reference` build the port's modules from the
  reference's `init_params` pytrees (as numpy arrays), so both packages
  serve the same weights. Neither package reproduces the other's random
  draws.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.engine.loop import bucket_tensors
from repro_torch.models import recsys as R
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
                                      cfg: T.TransformerConfig,
                                      device) -> T.Transformer:
    """The port's `Transformer` for the reference's `init_params(cfg, key)`
    pytree as numpy float32 arrays: each stacked (n_layers, ...) leaf of
    `layers` split along dim 0 into the layers, matrices cast to
    cfg.dtype (the cast the reference makes at every use), norm weights
    float32, on `device`."""
    dt = T.compute_dtype(cfg)

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
