"""PyTorch port, layering: it stands alone and has one kernel choke point.

* `repro_torch` and chip_smoke.py import neither JAX nor the reference
  package `repro` — checked on the source and in a fresh interpreter that
  runs the engine on the CPU;
* the engine reaches the kernels only through `kernels.bitset_ops.ops`
  (no module outside the kernel package imports `ref` or `build`);
* with no CUDA device, `run(g)` raises instead of falling back, and
  chip_smoke.py exits non-zero without printing a result — also from a
  directory that holds chip_smoke.py alone.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
KERNEL_PKG = PKG / "kernels" / "bitset_ops"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.lineno, node.module
            for a in node.names:
                yield node.lineno, f"{node.module}.{a.name}"


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference():
    bad = [(str(p.relative_to(ROOT)), ln, mod)
           for p in _port_sources() for ln, mod in _imports(p)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_kernels_reached_only_through_ops():
    """R1 of the reference's layering, for the port: `ref` and `build` are
    private to the kernel package."""
    bad = []
    for p in PKG.rglob("*.py"):
        if KERNEL_PKG in p.parents:
            continue
        for ln, mod in _imports(p):
            if mod in ("repro_torch.kernels.bitset_ops.ref",
                       "repro_torch.kernels.bitset_ops.build",
                       "repro_torch.kernels.bitset_ops.words"):
                bad.append((str(p.relative_to(ROOT)), ln, mod))
    assert not bad


def _run_py(code: str, cwd=ROOT, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_running_the_port_loads_no_jax():
    code = """
import json, sys
import repro_torch
from repro_torch.core.engine import run
from repro_torch.graph.generators import erdos_renyi
res = run(erdos_renyi(80, 0.2, seed=1), enumerate_cliques=True, device="cpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps(dict(cliques=res.cliques, bad=bad)))
"""
    proc = _run_py(code)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["cliques"] > 0 and out["bad"] == []


def test_run_without_cuda_raises_in_a_fresh_process():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_py("from repro_torch.core.engine import run\n"
                   "from repro_torch.graph.generators import complete_graph\n"
                   "run(complete_graph(6))\n")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    """Without the rest of the checkout the script cannot pass."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
