"""Aliases of arguments written in place, read after the writes."""
from bad_r5.launch.cells import build_cell
from bad_r5.models.lm_steps import make_train_step
from bad_r5.models.transformer import decode_step


def serve(cfg, params, cache, tokens):
    old_k = cache["k"]
    first = cache["v"][:, :1]
    logits, cache = decode_step(cfg, params, cache, tokens[:, :1])
    drift = (cache["k"] - old_k).abs()  # EXPECT-R5
    return logits, drift, first  # EXPECT-R5


def train(cfg, params, opt, batches):
    step = make_train_step(cfg)
    w0 = params.w_in
    for tokens, targets in batches:
        params, opt, loss = step(params, opt, tokens, targets)
    return w0 - params.w_in  # EXPECT-R5


def dry(arch, cell, mesh):
    """A cell's function donates its arguments (CellProgram.donate)."""
    prog = build_cell(arch, cell, mesh)
    moments = prog.args[1]
    out = prog.fn(*prog.args)
    return out, moments  # EXPECT-R5
