"""Sharding rules for the LM transformer stack (MaxText-style FSDP+TP+EP),
the port of the reference's `repro.sharding.lm`, as the port's specs
(`sharding.spec`) and their DTensor placements.

Mesh axes: optional "pod" (pure DP, gradient all-reduce crosses pods),
"data" (FSDP: weight storage sharded, gathered at use; batch parallel),
"model" (TP: heads / d_ff / vocab; EP for MoE experts when divisible).

Divisibility-driven choices per architecture:
  * attention heads sharded over "model" iff n_heads % model_size == 0
    (qwen3's 40 heads on a 16-way axis fall back to FSDP-only attention —
    batch-parallel compute, fully sharded storage);
  * kv projections: n_kv_heads (8 or 2) never divides 16 — stored
    FSDP-sharded on the D dim, replicated over "model" at use (GQA KV is
    small: D × kv × hd);
  * MoE experts sharded over "model" iff n_experts % model_size == 0
    (phi-3.5's 16 experts -> expert parallelism; mixtral's 8 experts ->
    per-expert tensor parallelism on d_ff);
  * vocab always sharded over "model" (all five vocabs divide 16).

The port holds the layers as a `ModuleList` of per-layer tensors where the
reference stacks them (n_layers, ...): each spec of `param_specs["layers"]`
is the reference's without its leading None (the stacked-layer axis), and
applies to every layer alike. The KV cache keeps the stacked form
(`transformer.init_cache`), and so does `cache_spec`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from torch.distributed.tensor import Placement

from repro_torch.models.transformer import Transformer, TransformerConfig
from repro_torch.sharding.spec import (P, Spec, axis_sizes, distribute,
                                       placements, shard_parameters,
                                       size_of)


@dataclasses.dataclass
class LMSharding:
    mesh: object                   # a DeviceMesh, or a MeshShape stand-in
    dp: Tuple[str, ...]            # batch axes ("pod","data") or ("data",)
    fsdp: str                      # weight-storage axis
    tp: str                        # tensor/expert axis
    param_specs: dict
    batch_is_shardable: bool       # False for global_batch < dp size

    def placements(self, spec: Spec) -> Tuple[Placement, ...]:
        return placements(spec, self.mesh)

    def token_spec(self, batch: int) -> Spec:
        if batch % size_of(self.mesh, self.dp) == 0:
            return P(self.dp, None)
        return P(None, None)

    def cache_spec(self, cfg: TransformerConfig, batch: int,
                   cache_seq: int) -> dict:
        """KV cache (L, B, S, KV, dh) layout.

        Batch shards over dp AND the cache sequence dim over the tp axis
        when both divide (batch-only sharding left 36-75 GiB/device caches
        on phi3.5/qwen3/command-r decode_32k; flash streaming over KV
        blocks is associative, so partial reductions over the seq dim are
        exact). Falls back gracefully."""
        dp_size = size_of(self.mesh, self.dp)
        tp_size = axis_sizes(self.mesh)[self.tp]
        if batch % dp_size == 0:
            if cache_seq % tp_size == 0:
                kv = P(None, self.dp, self.tp, None, None)
            else:
                kv = P(None, self.dp, None, None, None)
        elif cache_seq % tp_size == 0:
            # batch=1 long-context decode: shard the cache sequence dim
            kv = P(None, None, self.tp, None, None)
        else:
            kv = P(None, None, None, None, None)
        return dict(k=kv, v=kv, pos=P())


def lm_sharding(cfg: TransformerConfig, mesh,
                dp_axes: Tuple[str, ...] = ("data",),
                fsdp_axis: str = "data", tp_axis: str = "model") -> LMSharding:
    tp_size = axis_sizes(mesh)[tp_axis]
    fsdp = fsdp_axis
    tp = tp_axis

    heads_tp = cfg.n_heads % tp_size == 0
    experts_tp = cfg.is_moe and (cfg.n_experts % tp_size == 0)

    layer = dict(
        ln_attn=P(None),
        ln_ffn=P(None),
        wq=P(fsdp, tp, None) if heads_tp else P(fsdp, None, None),
        wk=P(fsdp, None, None),
        wv=P(fsdp, None, None),
        wo=P(tp, None, fsdp) if heads_tp else P(None, None, fsdp),
    )
    if cfg.qk_norm:
        layer["q_norm"] = P(None)
        layer["k_norm"] = P(None)
    if cfg.is_moe:
        layer.update(
            router=P(fsdp, None),
            w_in=P(tp, fsdp, None) if experts_tp else P(None, fsdp, tp),
            w_gate=P(tp, fsdp, None) if experts_tp else P(None, fsdp, tp),
            w_out=P(tp, None, fsdp) if experts_tp else P(None, tp, fsdp),
        )
    else:
        layer.update(
            w_in=P(fsdp, tp),
            w_gate=P(fsdp, tp),
            w_out=P(tp, fsdp),
        )
    specs = dict(
        embed=P(tp, None),
        layers=layer,
        ln_final=P(None),
    )
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(fsdp, tp)
    return LMSharding(mesh=mesh, dp=dp_axes, fsdp=fsdp, tp=tp,
                      param_specs=specs, batch_is_shardable=True)


def opt_state_specs(sharding: LMSharding) -> dict:
    """AdamW moments inherit the param layout; step is replicated."""
    return dict(mu=sharding.param_specs, nu=sharding.param_specs, step=P())


def named_specs(sharding: LMSharding, n_layers: int) -> Dict[str, Spec]:
    """`param_specs` keyed by the port's parameter names (`embed`,
    `layers.<i>.<leaf>`, `ln_final`, `lm_head`): each layer's leaves take
    the layer specs."""
    sp = sharding.param_specs
    out = {k: v for k, v in sp.items() if k != "layers"}
    for i in range(n_layers):
        out.update({f"layers.{i}.{k}": v for k, v in sp["layers"].items()})
    return out


def shard_transformer(model: Transformer, sharding: LMSharding
                      ) -> Transformer:
    """Lay `model`'s parameters out by `sharding` on its `DeviceMesh`, in
    place (`spec.shard_parameters`). Returns the model."""
    return shard_parameters(model, sharding.mesh,
                            named_specs(sharding, model.cfg.n_layers))


def shard_opt_state(state: dict, sharding: LMSharding,
                    n_layers: int) -> dict:
    """AdamW state (`optim.adamw_init`'s layout, keyed by the port's
    parameter names) laid out by `opt_state_specs`: the moments as the
    parameters, the step replicated (a plain tensor)."""
    specs = named_specs(sharding, n_layers)

    def moments(tree):
        return {n: distribute(t, sharding.mesh, specs[n])
                for n, t in tree.items()}
    return dict(mu=moments(state["mu"]), nu=moments(state["nu"]),
                step=state["step"])
