"""End-to-end training driver for the LM, GNN and recsys families (the
port of the reference's `repro.launch.train`).

Random float32 master weights from seed 0, AdamW, a deterministic data
stream keyed by step, async keep-k checkpoints and restart from the last
commit. It runs on the CUDA card unless asked for the CPU
(`device="cpu"`, `--device cpu`); without a card it raises. On the card
the LM's attention and the two-tower bags run on the hand-written
kernels, forward and backward; the GNNs run on PyTorch's own operations
(their aggregation is a segment sum, as the reference leaves it to XLA).

Usage:
  python -m repro_torch.launch.train --arch qwen3-14b --steps 20
  python -m repro_torch.launch.train --arch schnet --device cpu
  python -m repro_torch.launch.train --arch two-tower-retrieval --steps 8 \\
      --ckpt /tmp/tt_ckpt --resume --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core.engine.loop import resolve_device
from repro_torch.optim import adamw_init


def _lm_setup(cfg, smoke: bool, dev: torch.device):
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_steps import make_train_step

    batch, seq = (8, 128) if smoke else (256, 4096)
    stream = TokenStream(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dtype=torch.float32)
    step_fn = make_train_step(cfg)

    def apply(params, opt, step):
        toks, tgts = (torch.from_numpy(a).to(dev) for a in stream.batch(step))
        return step_fn(params, opt, toks, tgts)

    return params, apply


def gnn_batch(arch: str, smoke: bool):
    """The launcher's one fixed batch for a GNN arch, numpy, as the
    reference's: MeshGraphNet on a random geometric graph (256 nodes at
    smoke, 4,096: 100,118 directed edges), the others on batched 12-atom
    molecules (8 at smoke, 128), DimeNet with triplets; d_feat 16.
    Returns (batch, n_graphs, d_feat)."""
    from repro_torch.graph.generators import random_geometric
    from repro_torch.models.gnn_steps import batch_from_graph, batch_molecules

    d_feat = 16
    if arch in ("schnet", "dimenet", "mace"):
        n_graphs = 8 if smoke else 128
        return batch_molecules(n_graphs, 12, d_feat,
                               with_triplets=(arch == "dimenet")), \
            n_graphs, d_feat
    g = random_geometric(256 if smoke else 4096, seed=0)
    return batch_from_graph(g, d_feat), 1, d_feat


def _gnn_setup(arch, cfg, smoke: bool, dev: torch.device):
    from repro_torch.models.gnn_steps import (FORWARD, make_gnn_train_step,
                                              to_device)

    _, init, _, _ = FORWARD[arch]
    b0, n_graphs, d_feat = gnn_batch(arch, smoke)
    params = init(cfg, torch.Generator(device=dev).manual_seed(0), d_feat)
    step_fn = make_gnn_train_step(arch, cfg, n_graphs)
    batch = to_device(b0, dev)

    def apply(params, opt, step):
        return step_fn(params, opt, batch)

    return params, apply


def _recsys_setup(cfg, smoke: bool, dev: torch.device):
    from repro_torch.models import recsys as R

    batch = 256 if smoke else 65536
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    step_fn = R.make_train_step(cfg)

    def apply(params, opt, step):
        return step_fn(params, opt,
                       R.to_device(R.synth_batch(cfg, batch, seed=step), dev))

    return params, apply


def _state(params: torch.nn.Module, opt: Dict) -> Dict[str, Any]:
    """The checkpointed tree: the model's state dict (views of its
    parameters) and AdamW's moments and step."""
    return dict(params=params.state_dict(), opt=opt)


def train(arch: str, steps: int = 50, smoke: bool = True,
          ckpt_dir: Optional[str] = None, resume: bool = False,
          ckpt_every: int = 10, log_every: int = 10,
          fail_at_step: Optional[int] = None, *, device=None
          ) -> Dict[str, Any]:
    """Returns dict(final_loss, losses, restored_from, params).
    `fail_at_step` simulates a node failure mid-run (tests exercise
    restart): the async writer is flushed before the failure propagates,
    so a resume finds the last commit."""
    spec = get_arch(arch)
    if spec.family not in ("lm", "gnn", "recsys"):
        raise ValueError(f"train.py drives lm/gnn/recsys archs, not "
                         f"{spec.family}; use repro_torch.launch.mce_run")
    dev = resolve_device(device)
    cfg = spec.build_smoke() if smoke else spec.build()
    if spec.family == "lm":
        params, apply = _lm_setup(cfg, smoke, dev)
    elif spec.family == "gnn":
        params, apply = _gnn_setup(arch, cfg, smoke, dev)
    else:
        params, apply = _recsys_setup(cfg, smoke, dev)

    opt = adamw_init(dict(params.named_parameters()))
    start = 0
    restored_from = None
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    if mgr and resume and mgr.latest_step() is not None:
        _, start, _ = mgr.restore(_state(params, opt))
        restored_from = start

    losses: List = []
    loss = None
    t0 = time.time()
    loop_ok = False
    try:
        for step in range(start, steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"simulated node failure at step {step}")
            params, opt, loss = apply(params, opt, step)
            if step % log_every == 0 or step == steps - 1:
                lv = float(loss)
                losses.append((step, lv))
                print(f"step {step:5d} loss {lv:.4f} "
                      f"({(time.time()-t0):.1f}s)", flush=True)
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, _state(params, opt),
                               meta=dict(arch=arch))
        loop_ok = True
    finally:
        # flush the async writer even on the failure path: an in-flight
        # snapshot must commit (or surface its error) before we propagate,
        # otherwise resume races the worker thread for latest_step()
        if mgr:
            try:
                mgr.wait()
            except Exception as flush_err:
                if loop_ok:
                    raise
                # a training exception is already propagating: the flush
                # error must not mask it, but leave a diagnostic trail
                print(f"WARNING: checkpoint flush failed during error "
                      f"propagation: {flush_err!r}", file=sys.stderr,
                      flush=True)
    if mgr:
        mgr.save(steps, _state(params, opt), meta=dict(arch=arch))
    return dict(final_loss=None if loss is None else float(loss),
                losses=losses, restored_from=restored_from, params=params)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, smoke=args.smoke,
                ckpt_dir=args.ckpt, resume=args.resume, device=args.device)
    print(f"final loss: {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
