#!/usr/bin/env python3
"""Same-call measurements of the census and dense_spmm kernels against an
earlier tree's, on one NVIDIA GPU.

They stand behind rows 4 and 10 of the kernel table in PERF.md §6:

    python3 tools/kernel_probe.py --export-earlier DIR [--rev REV]
    python3 tools/kernel_probe.py --earlier DIR
    python3 tools/kernel_probe.py --hybrid-lanes [--src DIR]

1. --export-earlier (no card needed): writes REV's (default HEAD~1)
   `bitset_ops.cu` and `segment_spmm.cu` into DIR with `git show`, for a
   machine whose copy of the checkout has no git history.
2. --earlier: builds DIR's two sources beside this tree's (one nvcc each,
   started together) and times, in turns in this process (this, earlier,
   earlier, this; each a median of chip_smoke.py's CUDA-event timing):
   - the census (`clique_counts`, the reference's contract) at each
     Graph500 scale-12 bucket's roots and at the hybrid lanes' 64, held
     bit for bit to the plain version, with this tree's `hybrid_census`
     (the engine's entry point, the same kernel) and each census block
     size beside it;
   - `dense_spmm` at the molecule cell (128 graphs of 30 nodes, F = 128
     and 32) and at chip_smoke.py's ring and plain-load shapes, held
     within 1e-5 of the plain version, with `torch.bmm` (TF32 off) beside
     it;
3. --hybrid-lanes: the hybrid lanes path of the `repro_torch` package
   under DIR (default: this checkout's `src`), so that two trees can be
   run in turns, each in a process of its own: `run()` on kronecker(12,
   16, seed=0) with backend="hybrid", engine="persistent", held to the
   reference's counters and stats (chip_smoke.py's `drive`) and timed on
   the host's clock, then chip_smoke.py's trip profile of that path on
   the U = 64 bucket (ms, torch kernels and device busy ms a trip).

Run from the root of a checkout with a CUDA card and nvcc. Prints one JSON
line per result; a failed check raises. Imports nothing of JAX or of the
reference package.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)

SOURCES = {"bitset_ops": "src/repro_torch/kernels/bitset_ops/csrc/"
                         "bitset_ops.cu",
           "segment_spmm": "src/repro_torch/kernels/segment_spmm/csrc/"
                           "segment_spmm.cu"}


def export_earlier(out: Path, rev: str) -> None:
    """REV's two kernel sources into `out`, by `git show`."""
    out.mkdir(parents=True, exist_ok=True)
    for name, path in SOURCES.items():
        text = subprocess.run(["git", "show", f"{rev}:{path}"], cwd=ROOT,
                              capture_output=True, text=True,
                              check=True).stdout
        (out / f"{name}.cu").write_text(text)
        print(f"{rev}:{path} -> {out / f'{name}.cu'}")


def build(src: Path) -> dict:
    """This tree's and the earlier tree's libraries of the two kernels, the
    four nvcc runs started together; the earlier ones declare only the C
    entry points this probe calls, with the earlier signatures (its census
    takes no block size)."""
    from repro_torch.kernels._build import CudaLibrary
    from repro_torch.kernels.bitset_ops.build import LIBRARY as bitset_lib
    from repro_torch.kernels.segment_spmm.ops import LIBRARY as spmm_lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {"bitset_ops": bitset_lib, "segment_spmm": spmm_lib,
            "earlier bitset_ops": CudaLibrary(
                (src / "bitset_ops.cu").resolve(),
                {"bitset_clique_counts": [p] * 6 + [ll, i, i, p]}),
            "earlier segment_spmm": CudaLibrary(
                (src / "segment_spmm.cu").resolve(),
                {"dense_spmm": [p, p, p, ll, i, i, p]})}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.build) for lib in libs.values()]:
            fut.result()
    for lib in libs.values():
        lib.load()
    cs.emit(dict(phase="probe", earlier=str(src),
                 name_power=cs.nvidia_smi("name,power.limit"),
                 nvcc_seconds={n: lib.build_seconds
                               for n, lib in libs.items()},
                 build_and_load_seconds=time.perf_counter() - t0))
    return libs


def in_turns(this, earlier) -> dict:
    """this, earlier, earlier, this: each the mean of its two medians."""
    turns = [cs.cuda_ms(fn)[0] for fn in (this, earlier, earlier, this)]
    return dict(ms=statistics.mean(turns[::3]),
                earlier_ms=statistics.mean(turns[1:3]), turns_ms=turns)


def census(dev, lib) -> None:
    """The census at each scale-12 bucket's roots and lanes, in turns."""
    import numpy as np
    import torch
    from repro_torch.core.engine.prepare import prepare
    from repro_torch.graph.generators import kronecker
    from repro_torch.kernels._build import stream
    from repro_torch.kernels.bitset_ops import ops, ref
    rng = np.random.default_rng(1)
    for b in prepare(kronecker(12, 16, seed=0), device=dev).buckets:
        o = cs.bucket_operands(b, dev, rng)
        for form, n in (("roots", b.num_roots), ("lanes", 64)):
            t = {k: v[:n].contiguous() for k, v in o.items()}
            rows, P, in_p, in_x = t["census"], t["P"], t["in_p"], t["in_x"]
            R, K, W = rows.shape
            want = ref.clique_counts(rows, P, in_p, in_x)
            outs = [torch.empty_like(want[0]) for _ in range(2)]
            hybrid = (t["a"], t["x_rows"], P, t["Xp"], t["xal"])

            def this():
                return ops.clique_counts(rows, P, in_p, in_x)

            def earlier():
                cs.check(lib.load().bitset_clique_counts(
                    rows.data_ptr(), P.data_ptr(), in_p.data_ptr(),
                    in_x.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                    R, K, W, stream()) == 0,
                    "the earlier census's launch failed")
                return outs
            err = cs.exact("clique_counts", this(), want, rows.shape)
            err = max(err, cs.exact("earlier clique_counts", earlier(), want,
                                    rows.shape))
            err = max(err, cs.exact(
                "hybrid_census", ops.hybrid_census(*hybrid),
                ref.hybrid_census(*hybrid), rows.shape))
            threads_ms = {}
            for nt in cs.CENSUS_THREADS:
                def forced(nt=nt):
                    return ops.clique_counts(rows, P, in_p, in_x, threads=nt)
                cs.exact(f"clique_counts threads={nt}", forced(), want,
                         rows.shape)
                threads_ms[nt] = cs.cuda_ms(forced)[0]
            nbytes, nops = cs.kernel_cost("clique_counts", rows, P)
            cs.emit(dict(
                phase="census_in_turns", bucket_u=b.u_pad, bucket_xc=b.x_pad,
                form=form, shape=[R, K, W], max_abs_err=err,
                **in_turns(this, earlier),
                hybrid_census_ms=cs.cuda_ms(
                    lambda: ops.hybrid_census(*hybrid))[0],
                threads_ms=threads_ms,
                bound_ms=1e3 * max(nbytes / cs.HBM_BYTES_PER_S,
                                   nops / cs.OPS_PER_S)))


def dense_spmm(dev, lib) -> None:
    """dense_spmm at the molecule cell and the ring and plain-load
    shapes, in turns, with torch.bmm beside."""
    import numpy as np
    import torch
    from repro_torch.kernels._build import stream
    from repro_torch.kernels.segment_spmm import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    for b, n, f in [(128, 30, 128), (128, 30, 32), (3, 400, 128),
                    (2, 333, 64), (4, 7, 3), (2, 100, 130)]:
        adj = torch.from_numpy((rng.random((b, n, n)) < 0.15).astype(
            np.float32)).to(dev)
        x = torch.from_numpy(rng.normal(size=(b, n, f)).astype(
            np.float32)).to(dev)
        want = ref.dense_spmm(adj, x)
        out = torch.empty_like(want)

        def this():
            return ops.dense_spmm(adj, x)

        def earlier():
            cs.check(lib.load().dense_spmm(
                adj.data_ptr(), x.data_ptr(), out.data_ptr(), b, n, f,
                stream()) == 0, "the earlier dense_spmm's launch failed")
            return out
        errs = []
        for fn in (this, earlier):
            err, rel, ok = cs.close(fn(), want, 1e-5, 1e-5)
            cs.check(ok, f"dense_spmm differs by {err} at {(b, n, f)}")
            errs.append(err)
        nbytes, nops = 4 * (b * n * n + 2 * b * n * f), 2 * b * n * n * f
        bound_ms, bound_by = cs.bound(nbytes, nops)
        cs.emit(dict(phase="dense_spmm_in_turns", shape=[b, n, f],
                     path=ops.kernel_path(adj, x), max_abs_err=max(errs),
                     **in_turns(this, earlier),
                     library_ms=cs.cuda_ms(lambda: torch.bmm(adj, x))[0],
                     bound_ms=bound_ms, bound_by=bound_by))


def hybrid_lanes(dev) -> None:
    """The hybrid lanes on scale 12 and their trip profile."""
    from repro_torch.core.engine.prepare import prepare
    from repro_torch.graph.generators import kronecker
    g = kronecker(12, 16, seed=0)
    cs.drive(dev, g, "hybrid_persistent", "kron:scale=12,ef=16,seed=0",
             cs.SLICE_EXPECT, cs.HYBRID_KERNELS, cs.HYBRID_STATS,
             backend="hybrid", engine="persistent")
    cs.trip_profile(dev, prepare(g, device=dev),
                    paths=("hybrid_persistent",))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--earlier", type=Path, metavar="DIR",
                        help="a directory holding an earlier tree's "
                             "bitset_ops.cu and segment_spmm.cu")
    parser.add_argument("--export-earlier", type=Path, metavar="DIR",
                        help="write REV's two sources into DIR and stop")
    parser.add_argument("--rev", default="HEAD~1")
    parser.add_argument("--hybrid-lanes", action="store_true",
                        help="run the hybrid lanes path of --src's tree")
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory whose repro_torch to run")
    opts = parser.parse_args()
    if opts.export_earlier is not None:
        export_earlier(opts.export_earlier, opts.rev)
        return 0
    if opts.earlier is None and not opts.hybrid_lanes:
        parser.error("give --earlier DIR, --hybrid-lanes or "
                     "--export-earlier DIR")
    sys.path.insert(0, str(opts.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if opts.hybrid_lanes:
        import repro_torch
        cs.emit(dict(phase="probe", repro_torch=repro_torch.__file__,
                     name_power=cs.nvidia_smi("name,power.limit")))
        hybrid_lanes(dev)
        return 0
    libs = build(opts.earlier)
    census(dev, libs["earlier bitset_ops"])
    dense_spmm(dev, libs["earlier segment_spmm"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
