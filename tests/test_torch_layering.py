"""PyTorch port, layering: it stands alone and has one kernel choke point.

* `repro_torch`, tools/ and chip_smoke.py import neither JAX nor the reference
  package `repro` — checked on the source and in a fresh interpreter that
  runs the engine on the CPU;
* every kernel package is reached only through its `ops` (no module
  outside a kernel package imports its `ref`, `build` or `words`, and only
  the kernel packages import the build helper `kernels._build`);
* importing the kernel packages builds and loads nothing; every kernel
  library refuses to build without nvcc; every CUDA source names the TPU
  kernel it replaces, its bound and its C entry points;
* with no CUDA device, `run(g)`, `DistributedMCE(g)`, `MCEService(g)`,
  `mce_run.main()`, `serve_lm`, `serve_recsys`, `serve.main()`,
  `train.train` and `train.main()` raise instead of falling back, and
  chip_smoke.py
  exits non-zero without printing a result — also from a directory that
  holds chip_smoke.py alone.
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
KERNELS = PKG / "kernels"
# kernel package -> (its private modules, the reference kernel it ports
# and that kernel's file:line)
KERNEL_PACKAGES = {
    "bitset_ops": ("ref", "build", "words"),
    "common_neighbor": ("ref",),
    "embedding_bag": ("ref",),
    "segment_spmm": ("ref",),
    "flash_attention": ("ref",),
}
PORTED = {
    "common_neighbor": ("has_common_neighbor", 30),
    "embedding_bag": ("embedding_bag_sum", 47),
    "segment_spmm": ("dense_spmm", 32),
    "flash_attention": ("flash_attention", 82),
}


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
    return sorted(PKG.rglob("*.py")) + sorted((ROOT / "tools").glob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference():
    sources = _port_sources()
    # the training path's, the GNN family's, the sharding and launch
    # tools' modules are among those checked
    for mod in ("optim/adamw.py", "optim/schedule.py", "optim/compress.py",
                "data/tokens.py", "data/prefetch.py", "checkpoint/store.py",
                "launch/train.py", "models/gnn.py", "models/gnn_steps.py",
                "models/equivariant.py", "graph/triplets.py",
                "graph/sampler.py", "configs/gnn_shapes.py",
                "configs/meshgraphnet.py", "configs/schnet.py",
                "configs/dimenet.py", "configs/mace.py",
                "launch/flops.py", "launch/mesh.py", "launch/cells.py",
                "sharding/__init__.py", "sharding/spec.py",
                "sharding/lm.py", "sharding/recsys.py", "sharding/gnn.py",
                "models/pipeline.py"):
        assert PKG / mod in sources, mod
    bad = [(str(p.relative_to(ROOT)), ln, mod)
           for p in sources for ln, mod in _imports(p)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_kernels_reached_only_through_ops():
    """R1 of the reference's layering, for the port: a kernel package's
    `ref` (and `build`, `words`) are private to it, and the build helper
    to the kernel packages."""
    bad = []
    for p in PKG.rglob("*.py"):
        for ln, mod in _imports(p):
            parts = mod.split(".")
            if parts[:2] != ["repro_torch", "kernels"] or len(parts) < 3:
                continue
            if parts[2] == "_build":
                if KERNELS not in p.parents:
                    bad.append((str(p.relative_to(ROOT)), ln, mod))
            elif len(parts) > 3 and parts[3] in KERNEL_PACKAGES.get(
                    parts[2], ()) and KERNELS / parts[2] not in p.parents:
                bad.append((str(p.relative_to(ROOT)), ln, mod))
    assert not bad


def _libraries():
    """Each kernel package on disk (a folder with an `ops.py`) -> the
    library its `ops` launches."""
    import importlib
    return {p.name: importlib.import_module(
        f"repro_torch.kernels.{p.name}.ops").LIBRARY
        for p in sorted(KERNELS.iterdir()) if (p / "ops.py").exists()}


def test_every_kernel_package_has_its_library():
    assert sorted(_libraries()) == sorted(KERNEL_PACKAGES)
    for name, lib in _libraries().items():
        assert lib.source == KERNELS / name / "csrc" / f"{name}.cu"
        assert lib.source.exists()


@pytest.mark.parametrize("name", sorted(KERNEL_PACKAGES))
def test_build_without_nvcc_raises(monkeypatch, tmp_path, name):
    from repro_torch.kernels import _build
    lib = _libraries()[name]
    monkeypatch.setattr(_build.shutil, "which", lambda exe: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(lib, "build_dir", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.load()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("name", sorted(PORTED))
def test_kernel_source_note_and_entry_points(name):
    """Each CUDA source names the TPU kernel it replaces (file:line), what
    bounds it on the H100, and defines every C entry point its wrapper
    declares, each returning the launch's error."""
    fn, line = PORTED[name]
    lib = _libraries()[name]
    src = lib.source.read_text()
    assert f"repro/kernels/{name}/kernel.py::{fn}" in src
    assert f"src/repro/kernels/{name}/kernel.py:{line}" in src
    assert "Bound on an H100" in src and "Design:" in src
    for entry in lib.signatures:
        assert f"int {entry}(" in src
    assert "cudaGetLastError()" in src


def test_importing_the_kernels_builds_nothing():
    """No nvcc and no library load at import (after torch's own, which
    loads its libraries with ctypes): the CPU tests import every module."""
    code = """
import ctypes, json, subprocess
import numpy, torch
def refuse(*a, **k):
    raise SystemExit("built or loaded at import")
subprocess.run = subprocess.Popen = ctypes.CDLL = refuse
import repro_torch.kernels as kernels
from repro_torch.kernels import _build
names = ["bitset_ops", "common_neighbor", "segment_spmm", "embedding_bag",
         "flash_attention"]
libs = [getattr(kernels, n).LIBRARY for n in names]
print(json.dumps(dict(loaded=[l._lib is not None for l in libs],
                      built=[l.build_seconds is not None for l in libs],
                      exported=[hasattr(getattr(kernels, n), "LAUNCHES")
                                for n in names])))
"""
    proc = _run_py(code)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == dict(loaded=[False] * 5, built=[False] * 5,
                       exported=[True] * 5)


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


# the port's entry points beside run(g), each called without a device
ENTRY_POINTS = {
    "DistributedMCE": "from repro_torch.core.driver import DistributedMCE\n"
                      "DistributedMCE(complete_graph(6))\n",
    "MCEService": "from repro_torch.launch.mce_service import MCEService\n"
                  "MCEService(complete_graph(6))\n",
    "mce_run.main": "import sys\nfrom repro_torch.launch import mce_run\n"
                    "sys.argv = ['mce_run', '--graph', 'er:n=30,p=0.2']\n"
                    "mce_run.main()\n",
    "serve_lm": "from repro_torch.launch.serve import serve_lm\n"
                "serve_lm('qwen3-14b')\n",
    "serve_recsys": "from repro_torch.launch.serve import serve_recsys\n"
                    "serve_recsys()\n",
    "serve.main": "import sys\nfrom repro_torch.launch import serve\n"
                  "sys.argv = ['serve', '--arch', 'two-tower-retrieval']\n"
                  "serve.main()\n",
    "train": "from repro_torch.launch.train import train\n"
             "train('qwen3-14b', steps=1)\n",
    "train.main": "import sys\nfrom repro_torch.launch import train\n"
                  "sys.argv = ['train', '--arch', 'two-tower-retrieval']\n"
                  "train.main()\n",
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_without_cuda_raise_in_a_fresh_process(entry):
    """Without a card and without a CPU device asked for, the driver, the
    service, the CLI, the serving and the training entry points raise
    before any work: no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_py("from repro_torch.graph.generators import complete_graph\n"
                   + ENTRY_POINTS[entry])
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "maximal cliques" not in proc.stdout


def test_launchers_load_no_jax():
    """The driver, both MCE launchers, the shim, the k-core peel and the
    serving and training of both model families run on the CPU when
    asked, in a fresh interpreter that never loads JAX or the
    reference."""
    code = """
import json, sys
from repro_torch.core import bitset_engine
from repro_torch.core.driver import DistributedMCE
from repro_torch.graph import erdos_renyi, kcore_peel_torch
from repro_torch.launch import mce_run, serve, train
from repro_torch.launch.mce_service import MCEService
g = erdos_renyi(60, 0.2, seed=1)
svc = MCEService(g, device="cpu", chunk=16)
res = DistributedMCE(g, device="cpu", chunk=16).run()
sys.argv = ["mce_run", "--graph", "er:n=60,p=0.2,seed=1", "--device", "cpu"]
mce_run.main()
lm = serve.serve_lm("qwen3-14b", new_tokens=3, device="cpu")
rec = serve.serve_recsys(device="cpu")
serve.main(["--arch", "mixtral-8x7b", "--tokens", "2", "--device", "cpu"])
fit = train.train("qwen3-14b", steps=2, device="cpu")
train.main(["--arch", "two-tower-retrieval", "--steps", "2", "--device",
            "cpu"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps(dict(cliques=res.cliques, svc=svc.query().cliques,
                      peel=len(kcore_peel_torch(g, device="cpu")),
                      generated=lm["generated"].shape,
                      top=rec["top_idx"].shape, fit=len(fit["losses"]),
                      bad=bad)))
"""
    proc = _run_py(code)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["cliques"] == out["svc"] > 0 and out["peel"] == 60
    assert out["generated"] == [4, 3] and out["top"] == [10]
    assert out["fit"] == 2 and out["bad"] == []
    assert "maximal cliques: %d" % out["cliques"] in proc.stdout
    assert "tok/s" in proc.stdout and "final loss:" in proc.stdout


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
