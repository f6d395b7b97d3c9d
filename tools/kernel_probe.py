#!/usr/bin/env python3
"""Same-call measurements of the bitset kernels and their engine entry
points, and of the common-neighbour kernel and its entry point, against an
earlier tree's, on one NVIDIA GPU.

They stand behind rows 1-3, 5 and 8 of the kernel table in PERF.md §6:

    python3 tools/kernel_probe.py --export-earlier DIR [--rev REV]
    python3 tools/kernel_probe.py --earlier DIR
    python3 tools/kernel_probe.py --hybrid-lanes [--src DIR]
    python3 tools/kernel_probe.py --profiles [--src DIR]

1. --export-earlier (no card needed): writes REV's (default HEAD~1)
   `bitset_ops.cu` and `common_neighbor.cu` into DIR with `git show`, for
   a machine whose copy of the checkout has no git history.
2. --earlier: builds each of DIR's sources that differs from this tree's
   beside this tree's (the nvcc runs started together) and times, in
   turns in this process (this, earlier, earlier, this; each a median of
   chip_smoke.py's CUDA-event timing), for `bitset_ops.cu`:
   - `frame_step` (A against P), `and_popcount_rows` (A against P, and
     the X-subset shape: ~X0 rows against P), `and_popcount_argmax` (the
     X0 rows) and `and_popcount_many` (P against ~X0 rows stacked on ~A)
     at each Graph500 scale-12 bucket's roots, held bit for bit to the
     plain version;
   - the engine's four entry points against the torch compositions
     they replaced, around the earlier tree's kernels, on the U = 64
     bucket's own operands (chip_smoke.py's `real_frames` and
     `real_steps`, roots and lanes): `branch_step` against `dfs_step`'s
     torch ops around one `frame_step` launch, `rcd_dominated` against
     `rcd_maximality_report`'s ops around one `and_popcount_many` launch
     (the stacked complement hoisted, as it was), and `lemma8_reduce` and
     `pivot_select` against the ops that stood around the row kernels
     (`and_popcount_rows`, `and_popcount_argmax`) before they were
     entry points; device ms, host µs a call (the enqueue of 50 calls),
     and CUDA kernels a call (torch.profiler), both held bit for bit to
     the plain version;
   and for `common_neighbor.cu`, on kronecker(12, 16, seed=0),
   kronecker(14, 16, seed=0) and chip_smoke.py's triangle-poor
   `bipartite_hubs` graph:
   - `has_common_neighbor` on scale 12's and the bipartite graph's rows
     gathered beforehand against the earlier kernel (CUDA events);
   - `edge_common_neighbor` against the earlier composition (the two row
     gathers, then the earlier kernel), both held to the host Lemma-4
     mask, back to back and with L2 flushed before each call: device ms
     a call (kernels summed, chip_smoke.py's `kernel_ms`), wall ms, and
     host µs and CUDA kernels a call;
3. --hybrid-lanes: the hybrid lanes path of the `repro_torch` package
   under DIR (default: this checkout's `src`), so that two trees can be
   run in turns, each in a process of its own: `run()` on kronecker(12,
   16, seed=0) with backend="hybrid", engine="persistent", held to the
   reference's counters and stats (chip_smoke.py's `drive`) and timed on
   the host's clock, then chip_smoke.py's trip profile of that path on
   the U = 64 bucket (ms, torch kernels and device busy ms a trip).
4. --profiles: chip_smoke.py's step and trip profiles (the pivot and
   rcd per-root steps; the pivot, hybrid and rcd lane trips) on the U = 64
   bucket of kronecker(12, 16, seed=0), of the `repro_torch` under
   --src's DIR, for trees run in turns, a process each.

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

SOURCES = {
    "bitset_ops": "src/repro_torch/kernels/bitset_ops/csrc/bitset_ops.cu",
    "common_neighbor":
        "src/repro_torch/kernels/common_neighbor/csrc/common_neighbor.cu"}


def export_earlier(out: Path, rev: str) -> None:
    """REV's kernel sources into `out`, by `git show`."""
    out.mkdir(parents=True, exist_ok=True)
    for name, source in SOURCES.items():
        text = subprocess.run(["git", "show", f"{rev}:{source}"], cwd=ROOT,
                              capture_output=True, text=True,
                              check=True).stdout
        (out / f"{name}.cu").write_text(text)
        print(f"{rev}:{source} -> {out / f'{name}.cu'}")


def build(src: Path) -> dict:
    """The earlier libraries of DIR's sources that differ from this
    tree's, built beside this tree's (the nvcc runs started together);
    each earlier one declares only the C entry points this probe calls.
    Returns {name: earlier library}."""
    from repro_torch.kernels._build import CudaLibrary
    from repro_torch.kernels.bitset_ops.build import LIBRARY
    from repro_torch.kernels.common_neighbor import ops as cn_ops
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        "bitset_ops": {
            "bitset_and_popcount_rows": [p, p, p, ll, i, i, p],
            "bitset_and_popcount_argmax": [p] * 5 + [ll, i, i, p],
            "bitset_frame_step": [p] * 8 + [ll, i, i, p],
            "bitset_and_popcount_many": [p, p, p, ll, i, i, i, p]},
        "common_neighbor": {
            "common_neighbor_has_common": [p, p, p, ll, i, p]}}
    this = {"bitset_ops": LIBRARY, "common_neighbor": cn_ops.LIBRARY}
    earlier = {name: CudaLibrary((src / f"{name}.cu").resolve(),
                                 signatures[name])
               for name in SOURCES if (src / f"{name}.cu").exists()
               and (src / f"{name}.cu").read_bytes()
               != (ROOT / SOURCES[name]).read_bytes()}
    libs = {**{n: this[n] for n in earlier},
            **{f"earlier {n}": lib for n, lib in earlier.items()}}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max(1, len(libs))) as pool:
        for fut in [pool.submit(lib.build) for lib in libs.values()]:
            fut.result()
    for lib in libs.values():
        lib.load()
    cs.emit(dict(phase="probe", earlier=str(src),
                 compared=sorted(earlier),
                 name_power=cs.nvidia_smi("name,power.limit"),
                 nvcc_seconds={n: lib.build_seconds
                               for n, lib in libs.items()},
                 build_and_load_seconds=time.perf_counter() - t0))
    return earlier


def in_turns(this, earlier) -> dict:
    """this, earlier, earlier, this: each the mean of its two medians."""
    turns = [cs.cuda_ms(fn)[0] for fn in (this, earlier, earlier, this)]
    return dict(ms=statistics.mean(turns[::3]),
                earlier_ms=statistics.mean(turns[1:3]), turns_ms=turns)


class Earlier:
    """The earlier tree's four kernels behind its wrappers' checks
    (`ops._check`, unchanged) and allocations, and the torch compositions
    the engine's entry points replace."""

    def __init__(self, lib):
        self.lib = lib

    def frame_step(self, rows, p, xp, wrow):
        import torch
        from repro_torch.kernels._build import stream
        from repro_torch.kernels.bitset_ops import ops
        lead, r, k, w = ops._check("frame_step", rows, p, xp, wrow)
        dev = rows.device
        outs = (torch.empty(lead + (w,), dtype=torch.int32, device=dev),
                torch.empty(lead + (w,), dtype=torch.int32, device=dev),
                torch.empty(lead + (k,), dtype=torch.int32, device=dev),
                torch.empty(lead + (k,), dtype=torch.int32, device=dev))
        cs.check(self.lib.load().bitset_frame_step(
            rows.data_ptr(), p.data_ptr(), xp.data_ptr(), wrow.data_ptr(),
            *(t.data_ptr() for t in outs), r, k, w, stream()) == 0,
            "the earlier frame_step did not launch")
        return outs

    def and_popcount_many(self, rows, masks):
        import torch
        from repro_torch.kernels._build import stream
        from repro_torch.kernels.bitset_ops import ops
        lead, r, k, w = ops._check("and_popcount_many", rows, masks)
        m = masks.shape[-2]
        out = torch.empty(lead + (m, k), dtype=torch.int32,
                          device=rows.device)
        cs.check(self.lib.load().bitset_and_popcount_many(
            rows.data_ptr(), masks.data_ptr(), out.data_ptr(), r, k, m, w,
            stream()) == 0, "the earlier and_popcount_many did not launch")
        return out

    def branch_step(self, a, x_rows, sP, sB, sXp, sRb, srsz, sxal, depth,
                    live, w, d, eye, ar):
        """The earlier dfs_step around its frame_step launch (d: the
        clamped depth, which dfs_step keeps computing; eye and ar: the
        root context's, built once a bucket)."""
        import torch
        from repro_torch.core.engine import frames as fr
        U = a.shape[1]
        f = fr.FrameStack(sP, sB, sXp, sRb, srsz, sxal).read(ar, d)
        pivot_family = w is None
        if pivot_family:
            has_branch = fr.any_bit(f.B) & live
            w = fr.first_bit_index(f.B).clamp(max=U - 1)
        else:
            has_branch = live
            w = w.long()
        wbit = eye[w]
        childP, childXp, deg, partner = self.frame_step(a, f.P, f.Xp,
                                                        a[ar, w])
        row_word = x_rows[ar, :, w // 32]
        adj_w = ((row_word >> (w % 32).to(torch.int32).unsqueeze(-1))
                 & 1) != 0
        childxal = f.xal & fr.mask_to_bitset(adj_w, sxal.shape[-1])
        hb = has_branch.unsqueeze(-1)
        cur = dict(P=torch.where(hb, f.P & ~wbit, f.P),
                   Xp=torch.where(hb, f.Xp | wbit, f.Xp))
        if pivot_family:
            cur["B"] = torch.where(hb, f.B & ~wbit, f.B)
        fr.FrameStack(sP, sB, sXp, sRb, srsz, sxal).write(ar, d, **cur)
        return (has_branch, childP, childXp, childxal, f.Rb | wbit,
                f.rsz + 1, deg, partner)

    def rcd_dominated(self, a, x_rows, P, Xp, xal, not_xa):
        """The earlier rcd_maximality_report up to its report, with the
        stacked complement `not_xa` hoisted as its make_context did."""
        import torch
        from repro_torch.kernels.bitset_ops import ops
        sub = self.and_popcount_many(P.unsqueeze(-2), not_xa)[..., 0]
        in_x = torch.cat([ops.bits_to_mask(xal, x_rows.shape[-2]),
                          ops.bits_to_mask(Xp, a.shape[-2])], -1)
        return (in_x & (sub == 0)).any(-1), ops.popcount_words(P)

    def and_popcount_rows(self, rows, mask):
        import torch
        from repro_torch.kernels._build import stream
        from repro_torch.kernels.bitset_ops import ops
        lead, r, k, w = ops._check("and_popcount_rows", rows, mask)
        ops._check_mask("and_popcount_rows", mask, lead, w)
        out = torch.empty(lead + (k,), dtype=torch.int32, device=rows.device)
        cs.check(self.lib.load().bitset_and_popcount_rows(
            rows.data_ptr(), mask.data_ptr(), out.data_ptr(), r, k, w,
            stream()) == 0, "the earlier and_popcount_rows did not launch")
        return out

    def and_popcount_argmax(self, rows, mask, valid):
        import torch
        from repro_torch.kernels._build import stream
        from repro_torch.kernels.bitset_ops import ops
        lead, r, k, w = ops._check("and_popcount_argmax", rows, mask, valid)
        ops._check_mask("and_popcount_argmax", mask, lead, w)
        idx = torch.empty(lead, dtype=torch.int32, device=rows.device)
        best = torch.empty(lead, dtype=torch.int32, device=rows.device)
        cs.check(self.lib.load().bitset_and_popcount_argmax(
            rows.data_ptr(), mask.data_ptr(), valid.data_ptr(),
            idx.data_ptr(), best.data_ptr(), r, k, w, stream()) == 0,
            "the earlier and_popcount_argmax did not launch")
        return idx, best

    def lemma8_reduce(self, a, not_x, P, Xp, xal, Rb, rsz):
        """The earlier reductions.py's Lemma-8 block."""
        import torch
        from repro_torch.kernels.bitset_ops import ops
        U, W = a.shape[-2:]
        degP2 = self.and_popcount_rows(a, P)
        in_p2 = ops.bits_to_mask(P, U)
        psize = ops.popcount_words(P).unsqueeze(-1)
        full = in_p2 & (degP2 == psize - 1) & (psize > 0)
        any_full = full.any(-1)
        n_full = full.sum(-1, dtype=torch.int32)
        full_bits = ops.mask_to_bits(full, W)
        common = ops.and_reduce(a, full)
        sub_ok = self.and_popcount_rows(not_x, full_bits) == 0
        af = any_full.unsqueeze(-1)
        return (torch.where(af, P & ~full_bits, P),
                torch.where(af, Xp & common, Xp),
                torch.where(af, xal & ops.mask_to_bits(sub_ok, xal.shape[-1]),
                            xal),
                torch.where(af, Rb | full_bits, Rb),
                torch.where(any_full, rsz + n_full, rsz), degP2, n_full)

    def pivot_select(self, a, x_rows, P, Xp, xal, deg, n_full, ar):
        """The earlier pivot.py's branch_set (pivot backend, reduced
        frame)."""
        import torch
        from repro_torch.kernels.bitset_ops import ops
        U, XC = a.shape[-2], x_rows.shape[-2]
        in_p = ops.bits_to_mask(P, U)
        pool = in_p | ops.bits_to_mask(Xp, U)
        uni = torch.where(pool, deg - n_full.unsqueeze(-1), -1)
        best_u = uni.argmax(-1)
        su = uni.gather(-1, best_u.unsqueeze(-1)).squeeze(-1)
        best_x, sx = self.and_popcount_argmax(x_rows, P,
                                              ops.bits_to_mask(xal, XC))
        use_x = (sx > su).unsqueeze(-1)
        pivot_row = torch.where(use_x, x_rows[ar, best_x.long()],
                                a[ar, best_u.long()])
        return P & ~pivot_row


def row_kernels(dev, old) -> None:
    """Rows 1-3 and 5 at each scale-12 bucket's roots, in turns."""
    import numpy as np
    import torch
    from repro_torch.core.engine.prepare import prepare
    from repro_torch.graph.generators import kronecker
    from repro_torch.kernels.bitset_ops import ops, ref
    rng = np.random.default_rng(1)
    for b in prepare(kronecker(12, 16, seed=0), device=dev).buckets:
        o = cs.bucket_operands(b, dev, rng)
        not_x = ~o["x_rows"]
        not_xa = torch.cat([not_x, ~o["a"]], 1)
        for name, args in (
                ("frame_step", (o["a"], o["P"], o["Xp"],
                                o["a"][:, 0].contiguous())),
                ("and_popcount_many", (o["P"].unsqueeze(1), not_xa)),
                ("and_popcount_rows", (o["a"], o["P"])),
                ("and_popcount_rows", (not_x, o["P"])),
                ("and_popcount_argmax", (o["x_rows"], o["P"],
                                         o["x_alive0"]))):
            def this():
                out = getattr(ops, name)(*args)
                return out if isinstance(out, tuple) else (out,)

            def earlier():
                out = getattr(old, name)(*args)
                return out if isinstance(out, tuple) else (out,)
            want = getattr(ref, name)(*args)
            want = want if isinstance(want, tuple) else (want,)
            err = max(cs.exact(name, this(), want, args[0].shape),
                      cs.exact(f"earlier {name}", earlier(), want,
                               args[0].shape))
            nbytes, nops = cs.kernel_cost(name, *args[:2], args[2:])
            cs.emit(dict(
                phase="rows_in_turns", name=name, bucket_u=b.u_pad,
                bucket_xc=b.x_pad, shape=list(args[0].shape),
                max_abs_err=err, **in_turns(this, earlier),
                bound_ms=cs.bound(nbytes, nops)[0]))


def per_call(fn, calls=50) -> dict:
    """Host µs a call (the enqueue of `calls` calls, then one sync) and
    CUDA kernels a call (torch.profiler over `calls` calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return dict(host_us=1e6 * host / calls, kernels=len(kernels) / calls)


def entry_points(dev, old) -> None:
    """The four entry points against the earlier compositions on the U =
    64 bucket's own operands (roots and lanes), in turns."""
    import torch
    from repro_torch.core.engine import frames as fr
    from repro_torch.core.engine.prepare import prepare
    from repro_torch.graph.generators import kronecker
    from repro_torch.kernels.bitset_ops import ops, ref
    prep = prepare(kronecker(12, 16, seed=0), device=dev)
    for b, form, name, (a, mask, extra) in cs.real_steps(dev, prep):
        x_rows = extra[0]
        ar = torch.arange(a.shape[0], device=dev)
        if name == "branch_step":
            # both run on their own copy of the recorded stack, which each
            # timed call writes in place, as the engine's steps do
            stack, (depth, live, w) = extra[1:7], extra[7:]
            d = depth.clamp(min=0)
            eye = fr.eye_bits(a.shape[1], a.shape[2], dev)
            mine = [t.clone() for t in stack]
            theirs = [t.clone() for t in stack]

            def this():
                return ops.branch_step(a, x_rows, *mine, depth, live, w)

            def earlier():
                return old.branch_step(a, x_rows, *theirs, depth, live, w,
                                       d, eye, ar)
            want = cs.run_kernel(name, a, mask, extra, ref)
            err = max(cs.exact(name, this() + tuple(mine), want, a.shape),
                      cs.exact(f"earlier {name}", earlier() + tuple(theirs),
                               want, a.shape))
        else:
            P, (Xp, xal) = mask, extra[1:]
            not_xa = torch.cat([~x_rows, ~a], 1)      # hoisted, as it was

            def this():
                return ops.rcd_dominated(a, x_rows, P, Xp, xal)

            def earlier():
                return old.rcd_dominated(a, x_rows, P, Xp, xal, not_xa)
            want = ref.rcd_dominated(a, x_rows, P, Xp, xal)
            err = max(cs.exact(name, this(), want, a.shape),
                      cs.exact(f"earlier {name}", earlier(), want, a.shape))
        nbytes, nops = cs.kernel_cost(name, a, mask, extra)
        cs.emit(dict(
            phase="entry_in_turns", name=name, form=form, bucket_u=b.u_pad,
            bucket_xc=b.x_pad, shape=list(a.shape), max_abs_err=err,
            **in_turns(this, earlier), this_call=per_call(this),
            earlier_call=per_call(earlier),
            bound_ms=cs.bound(nbytes, nops)[0]))
    for b, form, l8, piv in cs.real_frames(dev, prep):
        a, x_rows = l8[0], l8[1]
        not_x = ~x_rows                       # hoisted, as the earlier did
        ar = torch.arange(a.shape[0], device=dev)
        calls = {
            "lemma8_reduce": (lambda: ops.lemma8_reduce(*l8),
                              lambda: old.lemma8_reduce(a, not_x, *l8[2:]),
                              ref.lemma8_reduce(*l8)),
            "pivot_select": (lambda: (ops.pivot_select(*piv),),
                             lambda: (old.pivot_select(*piv, ar),),
                             (ref.pivot_select(*piv),))}
        for name, (this, earlier, want) in calls.items():
            err = max(cs.exact(name, this(), want, a.shape),
                      cs.exact(f"earlier {name}", earlier(), want, a.shape))
            args = l8 if name == "lemma8_reduce" else piv
            nbytes, nops = cs.kernel_cost(name, a, args[2],
                                          (x_rows,) + tuple(args[3:]))
            cs.emit(dict(
                phase="entry_in_turns", name=name, form=form,
                bucket_u=b.u_pad, bucket_xc=b.x_pad, shape=list(a.shape),
                max_abs_err=err, **in_turns(this, earlier),
                this_call=per_call(this), earlier_call=per_call(earlier),
                bound_ms=cs.bound(nbytes, nops)[0]))


def common_neighbor(dev, lib) -> None:
    """Rows gathered beforehand (scale 12, the bipartite graph) and the
    entry point (scales 12 and 14, the bipartite graph) against the
    earlier kernel and composition, in turns."""
    import torch
    from repro_torch.core.global_reduction import _triangle_edge_mask
    from repro_torch.graph.generators import kronecker
    from repro_torch.kernels._build import stream
    from repro_torch.kernels.common_neighbor import ops

    def earlier_kernel(au, av):
        e, d = au.shape
        out = torch.empty(e, dtype=torch.bool, device=au.device)
        cs.check(lib.load().common_neighbor_has_common(
            au.data_ptr(), av.data_ptr(), out.data_ptr(), e, d,
            stream()) == 0, "the earlier has_common_neighbor did not launch")
        return out
    flush = cs.l2_flush(dev)
    graphs = [("kron:scale=12,ef=16,seed=0", True,
               lambda: kronecker(12, 16, seed=0)),
              ("kron:scale=14,ef=16,seed=0", False,
               lambda: kronecker(14, 16, seed=0)),
              (cs.BIPARTITE_LABEL, True,
               lambda: cs.bipartite_hubs(**cs.BIPARTITE))]
    for label, rows, make in graphs:
        g = make()
        padded, edges, deg = cs.triangle_table(dev, g)
        host = torch.from_numpy(_triangle_edge_mask(g))

        def this():
            return ops.edge_common_neighbor(padded, edges)

        def earlier():
            ids = edges.long()
            return earlier_kernel(padded[ids[:, 0]], padded[ids[:, 1]])
        for name, fn in (("this", this), ("earlier", earlier)):
            cs.check(torch.equal(fn().cpu(), host),
                     f"{name} edge_common_neighbor differs from the host "
                     f"Lemma-4 mask on {label}")
        if rows:
            au = padded[edges[:, 0].long()]
            av = padded[edges[:, 1].long()]
            cs.check(torch.equal(ops.has_common_neighbor(au, av),
                                 earlier_kernel(au, av)),
                     "has_common_neighbor differs from the earlier kernel")
            real = int((deg[edges[:, 0].long()]
                        + deg[edges[:, 1].long()]).sum())
            least, staged = cs.swept_bytes(au, av)
            cs.emit(dict(phase="cn_in_turns", name="has_common_neighbor",
                         graph=label, shape=list(au.shape), max_abs_err=0,
                         triangle_share=float(host.float().mean()),
                         bound_ms=cs.bound(least, real)[0],
                         bound_ms_staged_design=cs.bound(staged, real)[0],
                         **in_turns(lambda: ops.has_common_neighbor(au, av),
                                    lambda: earlier_kernel(au, av))))
            del au, av
            torch.cuda.empty_cache()
        out = dict(phase="cn_in_turns", name="edge_common_neighbor",
                   graph=label,
                   shape=[*padded.shape, edges.shape[0]], max_abs_err=0)
        for temp, fl in (("warm", None), ("cold", flush)):
            turns = [cs.kernel_ms(fn, flush=fl)
                     for fn in (this, earlier, earlier, this)]
            out[temp] = dict(
                ms=statistics.mean(t[0] for t in turns[::3]),
                earlier_ms=statistics.mean(t[0] for t in turns[1:3]),
                wall_ms=statistics.mean(t[1] for t in turns[::3]),
                earlier_wall_ms=statistics.mean(t[1] for t in turns[1:3]),
                turns=turns)
        out.update(this_call=per_call(this), earlier_call=per_call(earlier))
        cs.emit(out)
        del padded, edges
        torch.cuda.empty_cache()


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


def profiles(dev) -> None:
    """The per-root step and lane trip profiles of the U = 64 bucket."""
    from repro_torch.core.engine.prepare import prepare
    from repro_torch.graph.generators import kronecker
    prep = prepare(kronecker(12, 16, seed=0), device=dev)
    cs.step_profile(dev, prep)
    cs.step_profile(dev, prep, backend="rcd")
    cs.trip_profile(dev, prep, paths=("persistent", "hybrid_persistent",
                                      "rcd_persistent"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--earlier", type=Path, metavar="DIR",
                        help="a directory holding an earlier tree's "
                             "bitset_ops.cu and/or common_neighbor.cu")
    parser.add_argument("--export-earlier", type=Path, metavar="DIR",
                        help="write REV's bitset_ops.cu and "
                             "common_neighbor.cu into DIR and stop")
    parser.add_argument("--rev", default="HEAD~1")
    parser.add_argument("--hybrid-lanes", action="store_true",
                        help="run the hybrid lanes path of --src's tree")
    parser.add_argument("--profiles", action="store_true",
                        help="profile --src's tree's step and lane trips")
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory whose repro_torch to run")
    opts = parser.parse_args()
    if opts.export_earlier is not None:
        export_earlier(opts.export_earlier, opts.rev)
        return 0
    if opts.earlier is None and not (opts.hybrid_lanes or opts.profiles):
        parser.error("give --earlier DIR, --hybrid-lanes, --profiles or "
                     "--export-earlier DIR")
    sys.path.insert(0, str(opts.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if opts.hybrid_lanes or opts.profiles:
        import repro_torch
        cs.emit(dict(phase="probe", repro_torch=repro_torch.__file__,
                     name_power=cs.nvidia_smi("name,power.limit")))
        if opts.hybrid_lanes:
            hybrid_lanes(dev)
        if opts.profiles:
            profiles(dev)
        return 0
    earlier = build(opts.earlier)
    if "bitset_ops" in earlier:
        old = Earlier(earlier["bitset_ops"])
        row_kernels(dev, old)
        entry_points(dev, old)
    if "common_neighbor" in earlier:
        common_neighbor(dev, earlier["common_neighbor"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
