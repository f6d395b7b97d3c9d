"""GPipe-style pipeline parallelism for the dense transformer (PP axis):
the port of the reference's `repro.models.pipeline`.

The stages are the ranks of the "pp" axis of a `DeviceMesh`: rank s owns
stage s, L/S consecutive layers (`stack_stages` splits the model's
`ModuleList`). The classic GPipe schedule sends M microbatches through S
stages in M + S − 1 ticks: at tick t stage s runs microbatch t − s, its
input received from stage s − 1 and its output sent to stage s + 1
(blocking `send`/`recv` in microbatch order, so the ranks move in lock
step). The last stage's outputs then reach every rank (a broadcast, the
reference's `psum`), where the final norm, the head and the loss run
replicated. The embedding and head are not stage-split.

Backward (`make_pipeline_train_step`) is GPipe's reverse schedule, which
the reference gets from the transpose of `ppermute`: every rank's loss
gives the outputs' gradient, the last stage back-propagates microbatches
M − 1 … 0 through its layers and sends each input's gradient to stage
s − 1, and so on down to stage 0, whose inputs' gradients reach the
embedding (summed over the stages, every rank alike). Each stage's
layers' gradients stay on their rank; the global gradient norm that
clips them is summed over the stages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def stack_stages(layers: nn.ModuleList, n_stages: int) -> nn.ModuleList:
    """L layers -> a `ModuleList` of S stages, each a `ModuleList` of L/S
    consecutive layers (the same modules: nothing copied). Parameter
    names become `layers.<stage>.<j>.<leaf>` once assigned to
    `model.layers`."""
    n = len(layers)
    if n % n_stages:
        raise ValueError(f"{n} layers not divisible by {n_stages} stages")
    k = n // n_stages
    return nn.ModuleList(nn.ModuleList(layers[s * k:(s + 1) * k])
                         for s in range(n_stages))


def _stage(mesh, pp_axis: str):
    """(group, this rank's stage, stages, global rank of each stage)."""
    group = mesh.get_group(pp_axis)
    n = dist.get_world_size(group)
    ranks = [dist.get_global_rank(group, i) for i in range(n)]
    return group, dist.get_rank(group), n, ranks


def stage_parameters(params: T.Transformer, mesh, pp_axis: str = "pp"
                     ) -> Dict[str, nn.Parameter]:
    """The parameters this rank trains: its stage's layers
    (`layers.<stage>.…`) and the replicated embedding, final norm and
    head, by name. The other stages' layers, if it holds them, are not
    its to update."""
    _, sid, _, _ = _stage(mesh, pp_axis)
    return {n: p for n, p in params.named_parameters()
            if not n.startswith("layers.") or n.split(".")[1] == str(sid)}


def _run_stages(cfg: T.TransformerConfig, params: T.Transformer,
                xs: torch.Tensor, positions: torch.Tensor, mesh,
                pp_axis: str):
    """This rank's stage over the M microbatches `xs` (M, mb, s, D) in
    GPipe's order. Returns (the last stage's outputs (M, mb, s, D) on
    every rank, this stage's inputs, its outputs): each input a leaf that
    requires grad when gradients are on."""
    group, sid, n, ranks = _stage(mesh, pp_axis)
    layers = params.layers[sid]
    ins: List[torch.Tensor] = []
    outs: List[torch.Tensor] = []
    for i in range(xs.shape[0]):
        if sid == 0:
            x = xs[i].detach()
        else:
            x = torch.empty_like(xs[i])
            dist.recv(x, src=ranks[sid - 1], group=group)
        x.requires_grad_(torch.is_grad_enabled())
        y = x
        for lp in layers:
            y, _, _ = T._layer(cfg, lp, y, positions,
                               inv_freq=params.inv_freq)
        if sid < n - 1:
            dist.send(y.detach().contiguous(), dst=ranks[sid + 1],
                      group=group)
        ins.append(x)
        outs.append(y)
    out = (torch.stack([y.detach() for y in outs]) if sid == n - 1
           else torch.empty_like(xs))
    if n > 1:
        dist.broadcast(out, src=ranks[-1], group=group)
    return out, ins, outs


def _embed(cfg, params, tokens, n_microbatches):
    b, s = tokens.shape
    m = n_microbatches
    if b % m:
        raise ValueError("batch must divide into microbatches")
    x = T.embed_tokens(cfg, params, tokens)
    positions = T.positions_of(b // m, s, x.device)
    return x, x.reshape(m, b // m, s, -1), positions


def _head(cfg, params, y: torch.Tensor, b: int, s: int) -> torch.Tensor:
    y = L.rms_norm(y.reshape(b, s, -1), params.ln_final, cfg.norm_eps)
    return (y @ params.head().to(y.dtype)).float()


def pipeline_forward(cfg: T.TransformerConfig, params: T.Transformer,
                     tokens: torch.Tensor, *, mesh, n_microbatches: int,
                     pp_axis: str = "pp") -> torch.Tensor:
    """Training/prefill forward with the trunk pipelined over `pp_axis`.

    params: a `Transformer` whose `layers` are stage-split
    (`stack_stages`; this rank runs `layers[stage]`). tokens: (B, S_seq)
    with B % n_microbatches == 0, alike on every rank. Returns float32
    logits (B, S_seq, V) on every rank. Not differentiable across the
    stages: train with `make_pipeline_train_step`."""
    b, s = tokens.shape
    _, xs, positions = _embed(cfg, params, tokens, n_microbatches)
    out, _, _ = _run_stages(cfg, params, xs, positions, mesh, pp_axis)
    return _head(cfg, params, out, b, s)


def _nll_mean(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def pipeline_loss(cfg, params, tokens, targets, *, mesh, n_microbatches,
                  pp_axis: str = "pp") -> torch.Tensor:
    """Mean next-token NLL of the pipelined forward (no MoE aux loss, as
    the reference's)."""
    logits = pipeline_forward(cfg, params, tokens, mesh=mesh,
                              n_microbatches=n_microbatches, pp_axis=pp_axis)
    return _nll_mean(logits, targets)


def make_pipeline_train_step(cfg, mesh, n_microbatches: int,
                             pp_axis: str = "pp", lr: float = 1e-3):
    """GPipe training step: step(params, opt_state, tokens, targets) ->
    (params, opt_state, loss). `opt_state` is `optim.adamw_init` of
    `stage_parameters(params, mesh)`; the step updates those parameters
    in place (AdamW, no weight decay, the gradients clipped by their
    global norm over every stage), every rank alike for the replicated
    ones."""
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.optim.adamw import global_norm
    opt_cfg = AdamWConfig(weight_decay=0.0)

    def step(params: T.Transformer, opt_state, tokens, targets
             ) -> Tuple[T.Transformer, dict, torch.Tensor]:
        group, sid, n, ranks = _stage(mesh, pp_axis)
        owned = stage_parameters(params, mesh, pp_axis)
        for p in params.parameters():
            p.grad = None
        b, s = tokens.shape
        x, xs, positions = _embed(cfg, params, tokens, n_microbatches)
        out, ins, outs = _run_stages(cfg, params, xs, positions, mesh,
                                     pp_axis)
        # the head and loss, replicated: the outputs' gradient on every rank
        out = out.requires_grad_()
        loss = _nll_mean(_head(cfg, params, out, b, s), targets)
        loss.backward()
        # GPipe's reverse schedule through the stages
        for i in reversed(range(len(outs))):
            if sid == n - 1:
                g = out.grad[i]
            else:
                g = torch.empty_like(outs[i])
                dist.recv(g, src=ranks[sid + 1], group=group)
            outs[i].backward(g)
            if sid > 0:
                dist.send(ins[i].grad.contiguous(), dst=ranks[sid - 1],
                          group=group)
        # the embedding's lookup gradient: stage 0's inputs', on every rank
        if sid == 0:
            (g_embed,) = torch.autograd.grad(
                x, params.embed, torch.stack([t.grad for t in ins]).reshape(
                    x.shape))
        else:
            g_embed = torch.zeros_like(params.embed)
        if n > 1:
            dist.all_reduce(g_embed, group=group)
        params.embed.grad = (g_embed if params.embed.grad is None
                             else params.embed.grad + g_embed)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in owned.items()}
        # clip by the global norm: the replicated parameters once, every
        # stage's layers summed over the stages
        stage = [k for k in owned if k.startswith("layers.")]
        rep = [k for k in owned if not k.startswith("layers.")]
        sq = global_norm([grads[k] for k in stage]).square()
        if n > 1:
            dist.all_reduce(sq, group=group)
        gnorm = (global_norm([grads[k] for k in rep]).square() + sq).sqrt()
        scale = torch.clamp(opt_cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        grads = {k: g.float() * scale for k, g in grads.items()}
        _, opt_state = adamw_update(
            owned, grads, opt_state, lr,
            dataclasses.replace(opt_cfg, clip_norm=float("inf")))
        for p in params.parameters():
            p.grad = None
        return params, opt_state, loss.detach()

    return step
