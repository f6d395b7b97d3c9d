"""Copies taken before the in-place writes, reads made before them, and
results rebound over the arguments."""
from good_r5.launch.cells import build_cell
from good_r5.models.lm_steps import make_train_step
from good_r5.models.transformer import decode_step


def serve(cfg, params, cache, tokens):
    old_k = cache["k"].clone()
    first = cache["v"][:, :1].sum()
    logits, cache = decode_step(cfg, params, cache, tokens[:, :1])
    drift = (cache["k"] - old_k).abs()
    return logits, drift, first


def train(cfg, params, opt, batches):
    step = make_train_step(cfg)
    w0 = params.w_in.detach().clone()
    for tokens, targets in batches:
        params, opt, loss = step(params, opt, tokens, targets)
    return w0 - params.w_in


def dry(arch, cell, mesh):
    prog = build_cell(arch, cell, mesh)
    size = len(prog.args[1])
    out = prog.fn(*prog.args)
    return out, size
