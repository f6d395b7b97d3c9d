#!/usr/bin/env python3
"""Run the port's dry run (`python -m repro_torch.launch.dryrun`) over many
cells at once, one process a cell, and print one summary line a cell.

    PYTHONPATH=src python3 tools/dryrun_sweep.py --jobs 6 --out DIR
    PYTHONPATH=src python3 tools/dryrun_sweep.py --cells qwen3-14b/decode_32k \\
        schnet/full_graph_sm --multi-pod on
    python3 tools/dryrun_sweep.py --compare DIR_A DIR_B

Without `--cells` it takes every runnable cell of `launch/cells.all_cells()`.
Each cell runs in a process of its own (a fake world is one per process)
with a time limit; its record goes to DIR as the CLI writes it, and a line
`{"arch", "cell", "mesh", "ok", "wall_s", "run_s", "error", ...}` to
standard output and to DIR/summary.jsonl. The last line counts the cells
that are not `ok`. Needs no card.

`--compare A B` runs nothing: it reads two sweeps' summary.jsonl (say,
one under each of two torch versions) and prints one line for each cell
whose matrix-product flops or all flops a rank differ between them, or
that is not `ok` in one, with B's figure over A's; the last line counts
the cells that are equal, that differ and that only one sweep has.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("kind", "n_devices", "flops_per_device", "bytes_per_device",
        "argument_bytes", "link_bytes_per_device", "model_flops", "flops_ca",
        "t_compute", "t_memory", "t_collective", "bottleneck")


def _cells(args):
    if args.cells:
        return [tuple(c.split("/", 1)) for c in args.cells]
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.cells import all_cells
    return [(a, c) for a, c, skip in all_cells() if not skip]


def _one(arch, cell, pod, out, timeout):
    mesh = "2x16x16" if pod == "on" else "16x16"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    line = dict(arch=arch, cell=cell, mesh=mesh, ok=False)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", cell, "--multi-pod", pod, "--out", str(out)],
            env=env, cwd=ROOT, capture_output=True, text=True,
            timeout=timeout)
        path = out / f"{arch}__{cell}__{mesh}.json"
        if path.exists():
            rec = json.loads(path.read_text())
            line.update(ok=rec["ok"], run_s=rec["compile_s"],
                        error=(rec["error"] or "").splitlines()[:1],
                        **{k: rec[k] for k in KEYS})
        else:
            line.update(error=[proc.stderr.strip()[-300:]])
    except subprocess.TimeoutExpired:
        line.update(error=[f"not done in {timeout} s"])
    line["wall_s"] = time.perf_counter() - t0
    return line


def _summary(path: str) -> dict:
    path = Path(path)
    if path.is_dir():
        path = path / "summary.jsonl"
    lines = [json.loads(ln) for ln in path.read_text().splitlines()
             if ln.strip()]
    return {(ln["arch"], ln["cell"], ln["mesh"]): ln for ln in lines
            if "arch" in ln}


def compare(a_path: str, b_path: str) -> int:
    """The cells of two sweeps whose per-rank terms differ; 1 if any."""
    a, b = _summary(a_path), _summary(b_path)
    equal = differ = 0
    for key in sorted(a.keys() & b.keys()):
        ra, rb = a[key], b[key]
        line = dict(zip(("arch", "cell", "mesh"), key), ok=[ra["ok"],
                                                            rb["ok"]])
        same = ra["ok"] and rb["ok"]
        for k in ("flops_ca", "flops_per_device"):
            x, y = ra.get(k), rb.get(k)
            line[k] = [x, y]
            line[k + "_ratio"] = y / x if x and y is not None else None
            same = same and x == y
        if same:
            equal += 1
        else:
            differ += 1
            print(json.dumps(line), flush=True)
    only = dict(only_in_a=sorted("/".join(k) for k in a.keys() - b.keys()),
                only_in_b=sorted("/".join(k) for k in b.keys() - a.keys()))
    print(json.dumps(dict(cells=equal + differ, equal=equal, differ=differ,
                          **only)))
    return 1 if differ or only["only_in_a"] or only["only_in_b"] else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cells", nargs="*", default=None,
                    help="arch/cell names (default: every runnable cell)")
    ap.add_argument("--multi-pod", choices=("on", "off", "both"),
                    default="both")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="two sweeps' folders or summary.jsonl files: "
                         "print the cells whose terms differ, run nothing")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    pods = {"on": ["on"], "off": ["off"], "both": ["off", "on"]}[
        args.multi_pod]
    todo = [(a, c, p) for p in pods for a, c in _cells(args)]
    bad = 0
    with ThreadPoolExecutor(args.jobs) as pool, \
            open(out / "summary.jsonl", "w") as summary:
        for line in pool.map(lambda t: _one(*t, out, args.timeout), todo):
            bad += not line["ok"]
            print(json.dumps(line), flush=True)
            summary.write(json.dumps(line) + "\n")
    print(json.dumps(dict(cells=len(todo), not_ok=bad)))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
