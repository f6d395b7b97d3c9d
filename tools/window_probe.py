#!/usr/bin/env python3
"""Same-call measurements of the window walk on one NVIDIA GPU.

They stand behind rows 6-7 of the kernel table in PERF.md §6 and the
per-root window finding there:

    python3 tools/window_probe.py [--src DIR]
    python3 tools/window_probe.py --earlier OLD_BITSET_OPS_CU

1. the per-root window path of the `repro_torch` package under DIR
   (default: this checkout's `src`), so that two trees can be run in
   turns, each in a process of its own: `run()` on kronecker(12, 16,
   seed=0) with dynamic_red=False and window_steps=16, twice (the
   second run is the one to read), each held to the reference's counters (chip_smoke.py's
   WINDOW_EXPECT) and timed on the host's clock; chip_smoke.py's trip
   profile of that path and of the pivot lanes on the U = 64 bucket (ms a
   trip, device busy ms a trip, the device's idle share); and the host
   time of one call of each window wrapper on that bucket's real windows
   (µs to enqueue a launch, the median of 7 rounds of 200 calls);
2. with --earlier, instead: an earlier tree's window kernel (the block-per-lane
   kernel, whose C entry point `bitset_dfs_step_window` takes no launch
   geometry), built beside this tree's, held bit for bit to the plain
   version on each scale-12 bucket's real windows (chip_smoke.py's
   `real_windows`) and timed in turns with the kernel of the tree under
   DIR (this, earlier, earlier, this; each a median of chip_smoke.py's
   CUDA-event timing).

Run from the root of a checkout with a CUDA card and nvcc. Prints one JSON
line per result; a failed check raises. Imports nothing of JAX or of the
reference package.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)

GRAPH = "kron:scale=12,ef=16,seed=0"


def host_us(fn, calls: int = 200, rounds: int = 7) -> float:
    """Host µs to enqueue one call of `fn` (no sync inside a round)."""
    import torch
    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e6 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def perroot_window(dev, g, runs: int = 2, u: int = 64) -> None:
    """The per-root window path `runs` times, its trip profile beside the
    pivot lanes', and the window wrappers' host time a call."""
    from repro_torch.core.engine.prepare import prepare
    from repro_torch.kernels.bitset_ops import ops
    for _ in range(runs):
        cs.drive(dev, g, "perroot_window", GRAPH, cs.WINDOW_EXPECT,
                 ("dfs_step_window",), dynamic_red=False, window_steps=16)
    prep = prepare(g, device=dev)
    cs.trip_profile(dev, prep, u=u, paths=("persistent", "perroot_window"))
    for b, name, args, live in cs.real_windows(dev, prep):
        if b.u_pad == u:
            cs.emit(dict(phase="wrapper_host", name=name, bucket_u=u,
                         lanes=args[3].shape[0], host_us_per_call=host_us(
                             lambda: getattr(ops, name)(*args, steps=16))))


def earlier_kernel(dev, g, source: Path) -> None:
    """The earlier window kernel against this one on the real windows."""
    import torch
    from repro_torch.core.engine.prepare import prepare
    from repro_torch.kernels._build import CudaLibrary, stream
    from repro_torch.kernels.bitset_ops import ops, ref
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = CudaLibrary(source.resolve(), {
        "bitset_dfs_step_window": [p] * 15 + [ctypes.c_longlong] + [i] * 5
        + [p]})
    t0 = time.perf_counter()
    lib.load()
    cs.emit(dict(phase="earlier_build", source=str(source),
                 nvcc_seconds=lib.build_seconds,
                 build_and_load_seconds=time.perf_counter() - t0))
    for b, name, args, live in cs.real_windows(dev, prep=prepare(
            g, device=dev)):
        want = getattr(ref, name)(*args, steps=16)
        L, U, XC, T, W = cs.lanes_of(args)
        outs = [torch.empty_like(t) for t in args[3:8]] + \
            [torch.empty_like(want[-1])]

        def this():
            return getattr(ops, name)(*args, steps=16)

        def earlier():
            cs.check(lib.load().bitset_dfs_step_window(
                *(t.data_ptr() for t in list(args) + outs), L, U, XC, T, W,
                16, stream()) == 0, "the earlier window kernel's launch "
                "failed")
        err = cs.exact(name, this(), want, args[3].shape)
        earlier()
        err = max(err, cs.exact(f"earlier {name}", outs, want,
                                args[3].shape))
        turns = [cs.cuda_ms(fn)[0] for fn in (this, earlier, earlier, this)]
        nbytes, nops = cs.window_cost(args, want[-1])
        cs.emit(dict(
            phase="earlier_window", name=name, bucket_u=b.u_pad,
            bucket_xc=b.x_pad, roots=b.num_roots, live=live,
            shape=list(args[0].shape), window=list(args[3].shape), steps=16,
            max_abs_err=err, ms=statistics.mean(turns[::3]),
            earlier_ms=statistics.mean(turns[1:3]), turns_ms=turns,
            bound_ms=1e3 * max(nbytes / cs.HBM_BYTES_PER_S,
                               nops / cs.OPS_PER_S)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory whose repro_torch to run")
    parser.add_argument("--earlier", type=Path, metavar="BITSET_OPS_CU",
                        help="an earlier tree's bitset_ops.cu to time the "
                             "window kernel against")
    opts = parser.parse_args()
    sys.path.insert(0, str(opts.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("window_probe: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.graph.generators import kronecker
    dev = torch.device("cuda")
    lib = importlib.import_module(
        "repro_torch.kernels.bitset_ops.ops").LIBRARY
    lib.load()
    cs.emit(dict(phase="probe", repro_torch=repro_torch.__file__,
                 name_power=cs.nvidia_smi("name,power.limit"),
                 nvcc_seconds=lib.build_seconds))
    g = kronecker(12, 16, seed=0)
    if opts.earlier is None:
        perroot_window(dev, g)
    else:
        earlier_kernel(dev, g, opts.earlier)
    return 0


if __name__ == "__main__":
    sys.exit(main())
