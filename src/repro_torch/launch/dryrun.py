"""Multi-pod dry run: every (arch × shape) cell on the production meshes,
the port of the reference's `repro.launch.dryrun`, with per-rank terms
for the roofline.

The reference lowers and compiles each cell for 256 or 512 host devices
and reads XLA's analyses of the partitioned program. The port has no
compiler to ask. It joins a fake world of 256 or 512 ranks in this one
process (`FakeStore`, backend "fake": every collective returns a tensor
of the right shape and moves nothing), builds the cell's arguments as
meta DTensors (`launch/cells.py`), and runs the step once, as rank 0,
under `launch.cost.StepCost` and inside `kernels.shapes_only()`,
where the kernel wrappers take meta tensors to their plain versions.
Nothing is allocated and nothing is computed; no card is needed.

An `rmce` cell costs one `dfs_step` of its roots (the reference's cell
counts its while body once) and the counters' all-reduce: the roots'
first frames are set up outside the count, and the step itself reads
nothing back to the host (`python -m repro_torch.analysis`, rule R4).

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

# NVIDIA H100 SXM, per card (NVIDIA's data sheet and the Hopper
# architecture white paper; dense rates)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s
NVLINK_BW = 450e9                 # B/s each way, to the cards of its host
HOST_CARDS = 8                    # cards joined by NVLink in one host
# between hosts: one 400 Gb/s NDR InfiniBand port a card (NVIDIA DGX H100
# data sheet: eight ConnectX-7 adapters for the compute fabric), each way
HOST_LINK_BW = 50e9               # B/s


@dataclasses.dataclass
class DryrunRecord:
    """The reference's record. In the port: `compile_s` is the seconds of
    the step's run on meta (there is no compile); `flops_ca` the per-rank
    matrix-product flops (torch's formulas), what MODEL_FLOPS models;
    `bytes_ca` the argument plus output bytes a rank must touch at least
    once; `peak_memory_per_device` is not measured (meta tensors hold no
    memory) and stays 0."""
    arch: str
    cell: str
    kind: str
    mesh: str
    n_devices: int
    ok: bool
    error: Optional[str] = None
    compile_s: float = 0.0
    # per-device terms
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    peak_memory_per_device: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    collectives: Dict = dataclasses.field(default_factory=dict)
    link_bytes_per_device: float = 0.0
    model_flops: float = 0.0
    # secondary (see the class docstring)
    flops_ca: float = 0.0
    bytes_ca: float = 0.0
    # roofline terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    note: str = ""


def join_fake_world(n: int) -> None:
    """This process as rank 0 of a fake world of `n` ranks (a fake world
    of another size is left first; a real group raises)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised: the "
                               "dry run needs a fake world of its own")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _mce_step(prog, mesh):
    """The function an `rmce` cell is costed by, and its arguments: one
    `dfs_step` of each local shard's roots from their first frames (set
    up here, outside the count), then the counters summed over the data
    ranks, as the cell's own function ends."""
    from repro_torch.configs import get_arch
    from repro_torch.core.driver import COUNTER_KEYS
    from repro_torch.core.engine import frames as fr
    from repro_torch.core.engine import loop
    from repro_torch.launch.cells import mce_engine_config
    from repro_torch.launch.mesh import data_axes

    cfg = mce_engine_config(get_arch(prog.arch).build())
    groups = [mesh.get_group(ax) for ax in data_axes(mesh)]
    shards = []
    for args in zip(*(_local(t) for t in prog.args)):
        a, p0, xr, xa, rz = args
        r, u, w = a.shape
        dev = a.device
        ctx = fr.make_context(a, xr)
        zeros = torch.zeros((r, w), dtype=torch.int32, device=dev)
        carry = fr.carry_init(cfg, r, w, dev)
        carry, push0, frame0 = loop.enter_call(
            carry, cfg, ctx, p0, zeros, fr.mask_to_bitset(xa, ctx.xc_words),
            rz.to(torch.int32), zeros,
            enable=torch.ones(r, dtype=torch.bool, device=dev))
        stack = fr.FrameStack.alloc(r, u + 2, w, ctx.xc_words, dev)
        stack.push(ctx.ar, torch.zeros(r, dtype=torch.long, device=dev),
                   frame0)
        depth = torch.where(push0, 0, -1)
        shards.append((ctx, depth, stack, carry))

    def step(shards):
        out = None
        for ctx, depth, stack, carry in shards:
            live = depth >= 0
            _, _, carry = loop.dfs_step(cfg, ctx, depth, stack, carry, live)
            counts = torch.stack([
                carry[k].sum(dtype=torch.int64) if k in carry
                else torch.zeros((), dtype=torch.int64, device=depth.device)
                for k in COUNTER_KEYS])
            out = counts if out is None else out + counts
        for g in groups:
            if dist.get_world_size(g) > 1:
                dist.all_reduce(out, group=g)
        return out
    return step, (shards,)


def _measure(prog, mesh) -> Dict[str, object]:
    """Run one CellProgram's step once on meta; per-rank terms."""
    from repro_torch.kernels import shapes_only
    from repro_torch.launch.cost import StepCost, local_bytes

    arg_bytes = float(local_bytes(prog.args))   # before: steps write them
    with shapes_only():
        if prog.kind == "mce":
            fn, args = _mce_step(prog, mesh)
        else:
            fn, args = prog.fn, prog.args
        cost = StepCost(host_size=HOST_CARDS)
        t0 = time.perf_counter()
        with cost:
            out = fn(*args)
        seconds = time.perf_counter() - t0
    return dict(compile_s=seconds, args=arg_bytes,
                outs=float(local_bytes(out)), **cost.totals())


def run_cell(arch: str, cell_name: str, multi_pod: bool,
             cfg_map=None) -> DryrunRecord:
    """One dry-run cell on the fake production world: build, run once on
    meta, per-rank costs and the H100 roofline terms.

    `cfg_map` (LM family): config transform hook, as the reference's."""
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh

    n_dev = 512 if multi_pod else 256
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = DryrunRecord(arch=arch, cell=cell_name, kind="?", mesh=mesh_name,
                       n_devices=n_dev, ok=False)
    try:
        join_fake_world(n_dev)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        prog = build_cell(arch, cell_name, mesh, cfg_map=cfg_map)
        rec.kind = prog.kind
        rec.model_flops = prog.model_flops
        rec.note = prog.note
        m = _measure(prog, mesh)
        rec.compile_s = m["compile_s"]
        rec.argument_bytes = m["args"]
        rec.output_bytes = m["outs"]
        rec.collectives = m["collectives"]
        rec.flops_per_device = m["flops"]
        rec.bytes_per_device = m["bytes"]
        rec.link_bytes_per_device = m["link"]
        rec.flops_ca = m["matmul_flops"]
        rec.bytes_ca = m["args"] + m["outs"]
        rec.t_compute = m["flops"] / PEAK_FLOPS_BF16
        rec.t_memory = m["bytes"] / HBM_BW
        across = m["link_across_hosts"]
        rec.t_collective = ((m["link"] - across) / NVLINK_BW
                            + across / HOST_LINK_BW)
        terms = dict(compute=rec.t_compute, memory=rec.t_memory,
                     collective=rec.t_collective)
        rec.bottleneck = max(terms, key=terms.get)
        rec.ok = True
    except Exception as e:
        rec.error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("on", "off", "both"),
                    default="off")
    ap.add_argument("--out", default=None, help="JSON output directory")
    args = ap.parse_args(argv)

    from repro_torch.launch.cells import all_cells

    if args.all:
        todo = list(all_cells())
    else:
        if not args.arch or not args.shape:
            ap.error("--arch/--shape or --all required")
        todo = [(args.arch, args.shape, None)]

    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    n_fail = 0
    for mp in pods:
        for arch, cell, skip in todo:
            mesh_name = "2x16x16" if mp else "16x16"
            tag = f"{arch}/{cell}@{mesh_name}"
            if skip:
                print(f"[SKIP] {tag}: {skip}")
                if args.out:
                    _dump(args.out, DryrunRecord(
                        arch=arch, cell=cell, kind="skip", mesh=mesh_name,
                        n_devices=0, ok=True, note=f"SKIPPED: {skip}"))
                continue
            rec = run_cell(arch, cell, mp)
            if rec.ok:
                print(f"[ OK ] {tag}: run={rec.compile_s:.1f}s "
                      f"flops/dev={rec.flops_per_device:.3e} "
                      f"bytes/dev={rec.bytes_per_device:.3e} "
                      f"link/dev={rec.link_bytes_per_device:.3e} "
                      f"args/dev={rec.argument_bytes / 2**30:.2f}GiB "
                      f"bottleneck={rec.bottleneck}", flush=True)
            else:
                n_fail += 1
                first = rec.error.splitlines()[0] if rec.error else "?"
                print(f"[FAIL] {tag}: {first}", flush=True)
            if args.out:
                _dump(args.out, rec)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"dry-run finished: {n_fail} failures")
    return 1 if n_fail else 0


def _dump(out_dir: str, rec: DryrunRecord) -> None:
    name = f"{rec.arch}__{rec.cell}__{rec.mesh}.json".replace("/", "_")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(dataclasses.asdict(rec), f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
