"""Analytic MODEL_FLOPS per (arch × shape): the "useful work" definition,
the port's own copy of the reference's `repro.launch.flops` (pure Python).

LM follows the brief: 6·N·D (train) / 2·N·D (inference) with N = active
params. GNN/recsys count the model's actual einsum structure (message MLPs,
triplet bilinear forms, irrep tensor products, tower GEMMs) — forward ×1,
train ×3 (fwd + ~2× bwd). Scatter/gather adds bytes, not flops.
"""
from __future__ import annotations

TRAIN_MULT = 3.0      # fwd + 2x bwd


def _mlp_flops(batch: float, dims) -> float:
    return 2.0 * batch * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def gnn_model_flops(arch: str, cfg, meta: dict) -> float:
    n, e = float(meta["raw_nodes"]), float(meta["raw_edges"])
    f = float(meta["d_feat"])
    if arch == "meshgraphnet":
        h = float(cfg.d_hidden)
        fwd = (_mlp_flops(n, (f, h, h)) + _mlp_flops(e, (4, h, h))
               + cfg.n_layers * (_mlp_flops(e, (3 * h, h, h))
                                 + _mlp_flops(n, (2 * h, h, h)))
               + _mlp_flops(n, (h, h, 1)))
    elif arch == "schnet":
        h = float(cfg.d_hidden)
        r = float(cfg.n_rbf)
        fwd = (_mlp_flops(n, (f, h))
               + cfg.n_interactions * (_mlp_flops(e, (r, h, h))
                                       + _mlp_flops(n, (h, h)) + e * h
                                       + _mlp_flops(n, (h, h, h)))
               + _mlp_flops(n, (h, h // 2, 1)))
    elif arch == "dimenet":
        h = float(cfg.d_hidden)
        t = float(meta.get("n_triplets", meta["raw_edges"] * 16))
        sbf = cfg.n_spherical * cfg.n_radial
        fwd = (_mlp_flops(n, (f, h)) + _mlp_flops(e, (2 * h + cfg.n_radial, h))
               + cfg.n_blocks * (
                   2.0 * t * sbf * cfg.n_bilinear              # sbf @ w_sbf
                   + 2.0 * t * cfg.n_bilinear * h * h          # bilinear form
                   + _mlp_flops(e, (h, h)) * 2                 # msg + upd
                   + 2.0 * e * cfg.n_radial * h)
               + _mlp_flops(n, (h, h, 1)))
    elif arch == "mace":
        h = float(cfg.d_hidden)
        irr = 9.0
        tp = 2.0 * irr * irr * irr * h                         # gaunt product
        fwd = (_mlp_flops(n, (f, h))
               + cfg.n_layers * (
                   _mlp_flops(e, (cfg.n_rbf, h, h))            # radial
                   + 2.0 * e * irr * h * h                     # w_msg
                   + e * tp                                    # msg product
                   + (cfg.correlation - 1) * n * tp            # product basis
                   + cfg.correlation * 2.0 * n * irr * h * h   # w_prod mixes
                   + 2.0 * n * irr * h * h)                    # w_upd
               + _mlp_flops(n, (h, h // 2, 1)))
    else:
        raise KeyError(arch)
    return TRAIN_MULT * fwd


def recsys_model_flops(cfg, kind: str, meta: dict) -> float:
    b = float(meta.get("batch", 1))
    u_in = cfg.d_id * 2 + cfg.d_small + cfg.d_dense
    i_in = cfg.d_id + cfg.d_small
    u_tower = _mlp_flops(1, (u_in,) + cfg.tower_mlp)
    i_tower = _mlp_flops(1, (i_in,) + cfg.tower_mlp)
    d = cfg.tower_mlp[-1]
    if kind == "train":
        return TRAIN_MULT * (b * (u_tower + i_tower) + 2.0 * b * b * d)
    if kind == "serve":
        return b * u_tower + 2.0 * b * 256 * d
    if kind == "bulk":
        return b * (u_tower + i_tower)
    if kind == "retrieval":
        c = float(meta["n_candidates"])
        return b * u_tower + c * i_tower + 2.0 * c * d
    raise KeyError(kind)
