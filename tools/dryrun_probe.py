#!/usr/bin/env python3
"""Look inside the port's dry run (`repro_torch.launch.dryrun`): one cell's
per-rank terms by aten op, where chosen ops of a cell come from, or how
DTensor lays out the ops that insert a dim. Needs no card.

    PYTHONPATH=src python3 tools/dryrun_probe.py by-op qwen3-14b decode_32k \\
        --multi-pod off --out build/byop.json
    PYTHONPATH=src python3 tools/dryrun_probe.py trace schnet full_graph_sm \\
        --ops log1p nonzero
    PYTHONPATH=src python3 tools/dryrun_probe.py placements

`by-op` runs the cell as `dryrun.run_cell` does and prints one line a
cell (all flops and matrix flops a rank), writing `StepCost`'s totals and
its table of [calls, flops, bytes] by op to `--out`. `trace` prints, for
each op named, each distinct stack of the port's and DTensor's frames it
was dispatched from and how often (local ops only, as `StepCost` sees
them, DTensor's sharding propagation included). `placements` prints the
placements and local shapes of dim-inserting ops on rows split over
"data" of a fake 16×16 world: the probe that shows where two torch
versions' DTensor rules differ. Compare two torch versions by running the
same command under each.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
import traceback


def _cell(arch: str, cell: str, multi_pod: bool):
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh
    dryrun.join_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    return build_cell(arch, cell, mesh), mesh


def by_op(args) -> None:
    import torch
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    prog, mesh = _cell(args.arch, args.cell, args.multi_pod == "on")
    m = dryrun._measure(prog, mesh)
    rec = dict(torch=torch.__version__, arch=args.arch, cell=args.cell,
               mesh="2x16x16" if args.multi_pod == "on" else "16x16",
               flops=m["flops"], matmul_flops=m["matmul_flops"],
               bytes=m["bytes"], link=m["link"],
               collectives=m["collectives"], by_op=m["by_op"],
               wall=time.perf_counter() - t0)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps({k: rec[k] for k in ("torch", "arch", "cell", "mesh",
                                          "flops", "matmul_flops")}))


def trace(args) -> None:
    import torch
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels import shapes_only
    ops = set(args.ops)
    seen = collections.Counter()

    class Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args_=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented          # DTensor first, as StepCost
            out = func(*args_, **(kwargs or {}))
            name = func._schema.name.split("::")[-1]
            if name in ops and not any(issubclass(t, FakeTensor)
                                       for t in types):
                frames = tuple(
                    f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}:{f.name}"
                    for f in traceback.extract_stack()
                    if "repro_torch" in f.filename
                    or "distributed/tensor" in f.filename)
                seen[(name, frames[-args.depth:])] += 1
            return out

    prog, _ = _cell(args.arch, args.cell, args.multi_pod == "on")
    with shapes_only(), Trace():
        prog.fn(*prog.args)
    print(f"torch {torch.__version__}")
    for (name, frames), n in sorted(seen.items()):
        print(f"{name} x{n}")
        for f in frames:
            print(f"    {f}")


def placements(args) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))

    def rows(*shape):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                 [Shard(0), Replicate()])
    x1, x2, x3 = rows(16384), rows(16384, 9), rows(16384, 9, 128)
    cases = {
        "x2[:, :, None]": lambda: x2[:, :, None],
        "x2.unsqueeze(-1)": lambda: x2.unsqueeze(-1),
        "x2[:, None, :]": lambda: x2[:, None, :],
        "x1[:, None]": lambda: x1[:, None],
        "x3.transpose(-1, -2).unsqueeze(-1)":
            lambda: x3.transpose(-1, -2).unsqueeze(-1),
        "x3[:, 0, :]": lambda: x3[:, 0, :],
        "x2.reshape(16384, 3, 3)": lambda: x2.reshape(16384, 3, 3),
        "torch.stack([x1, x1], 0)": lambda: torch.stack([x1, x1], 0),
        "torch.stack([x1, x1], -1)": lambda: torch.stack([x1, x1], -1),
        "torch.cat([x2, x2], 1)": lambda: torch.cat([x2, x2], 1),
        "x2[:, :, None].expand(16384, 9, 128)":
            lambda: x2[:, :, None].expand(16384, 9, 128),
    }
    print(f"torch {torch.__version__}")
    for name, fn in cases.items():
        try:
            y = fn()
            line = dict(op=name, placements=repr(y.placements),
                        shape=list(y.shape), local=list(y.to_local().shape))
        except Exception as e:                       # a refusal is a result
            line = dict(op=name, error=f"{type(e).__name__}: {e}"[:300])
        print(json.dumps(line))
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="what", required=True)
    for name in ("by-op", "trace"):
        p = sub.add_parser(name)
        p.add_argument("arch")
        p.add_argument("cell")
        p.add_argument("--multi-pod", choices=("on", "off"), default="off")
        if name == "by-op":
            p.add_argument("--out", default=None)
        else:
            p.add_argument("--ops", nargs="+", required=True)
            p.add_argument("--depth", type=int, default=8,
                           help="innermost frames kept a stack")
    sub.add_parser("placements")
    args = ap.parse_args(argv)
    {"by-op": by_op, "trace": trace, "placements": placements}[args.what](
        args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
