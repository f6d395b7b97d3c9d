#!/usr/bin/env python3
"""The GNNs' full-width losses, reference against port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/gnn_loss_check.py \
        [--arch dimenet] [--steps 3] [--threads 4]

Not a test (pytest does not collect it): it runs both packages, so it
lives with the tests and not in tools/, whose scripts must stand without
JAX. For each GNN at build() widths, on the cells the card measures
(`chip_smoke.py`'s gnn phase): SchNet, DimeNet and MACE on the molecule
cell (`batch_molecules(128, 30, 32)`, DimeNet with triplets),
MeshGraphNet on the launcher's `random_geometric(4096)` graph (d_feat
16). The reference's weights (`*_init` at PRNGKey(0)) go to the port
through `interop.gnn_params_from_reference`; both take `--steps` AdamW
steps (lr 1e-3, no weight decay) of their `make_gnn_train_step` on the
same numpy batch. Each arch runs in a process of its own, the reference
first, so one arch's buffers are freed before the next. Prints the
losses side by side, their largest relative difference, and each
process's peak resident memory; the last line is JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

ARCHS = ("meshgraphnet", "schnet", "dimenet", "mace")


def batch_for(arch):
    """The numpy batch and n_graphs of `arch`'s cell (reference builders,
    which give the port's arrays for the same seed)."""
    from repro.graph.generators import random_geometric
    from repro.models.gnn_steps import batch_from_graph, batch_molecules
    if arch == "meshgraphnet":
        return batch_from_graph(random_geometric(4096, seed=0), 16), 1, 16
    return batch_molecules(128, 30, 32,
                           with_triplets=(arch == "dimenet")), 128, 32


def one_arch(arch, steps, threads):
    """Both packages' losses for `arch`, in this process."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.configs import get_arch as ref_arch
    from repro.models.gnn_steps import FORWARD as JF
    from repro.models.gnn_steps import make_gnn_train_step as ref_step
    from repro.optim import adamw_init as ref_adamw_init
    from repro_torch.configs import get_arch
    from repro_torch.interop import gnn_params_from_reference
    from repro_torch.models.gnn_steps import make_gnn_train_step, to_device
    from repro_torch.optim import adamw_init

    torch.set_num_threads(threads)
    batch_np, n_graphs, d_feat = batch_for(arch)
    rcfg = ref_arch(arch).build()
    params = JF[arch][1](rcfg, jax.random.PRNGKey(0), d_feat)
    params_np = jax.tree.map(np.asarray, params)
    step = jax.jit(ref_step(arch, rcfg, n_graphs))
    state = ref_adamw_init(params)
    batch = jax.tree.map(jnp.asarray, batch_np)
    ref, t0 = [], time.perf_counter()
    for _ in range(steps):
        params, state, loss = step(params, state, batch)
        ref.append(float(loss))
    ref_s = time.perf_counter() - t0
    del params, state, batch, step
    jax.clear_caches()

    cfg = get_arch(arch).build()
    model = gnn_params_from_reference(arch, params_np, cfg, "cpu")
    opt = adamw_init(dict(model.named_parameters()))
    tstep = make_gnn_train_step(arch, cfg, n_graphs)
    tb = to_device(batch_np, "cpu")
    port, t0 = [], time.perf_counter()
    for _ in range(steps):
        model, opt, loss = tstep(model, opt, tb)
        port.append(float(loss))
    return dict(arch=arch, reference=ref, port=port,
                nodes=len(batch_np["node_feat"]), edges=len(batch_np["src"]),
                triplets=len(batch_np.get("trip_kj", ())),
                reference_s=ref_s, port_s=time.perf_counter() - t0,
                peak_rss_gb=resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss / 2**20)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS, action="append")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    archs = args.arch or list(ARCHS)
    if args.one:
        print(json.dumps(one_arch(archs[0], args.steps, args.threads)))
        return 0
    out = []
    for arch in archs:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", "--arch",
             arch, "--steps", str(args.steps), "--threads",
             str(args.threads)], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["max_rel_diff"] = max(abs(p - r) / abs(r) for p, r in
                                  zip(res["port"], res["reference"]))
        out.append(res)
        print(f"{arch:13s} reference {res['reference']}\n"
              f"{'':13s} port      {res['port']}\n"
              f"{'':13s} max relative difference {res['max_rel_diff']:.3g}"
              f" (peak RSS {res['peak_rss_gb']:.1f} GB)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
