"""Fault-tolerant checkpointing of tensor trees: atomic, keep-k, async.

The reference's contract (`repro.checkpoint.store`) for the port's state,
a tree of nested dicts whose leaves are tensors (a model's state dict,
AdamW's moments and step):

* **Atomic commit** — each leaf is written as one ``.npy`` under
  ``<dir>/step_<n>.tmp/``, then ``manifest.json`` (the commit record,
  written last), then the directory is ``os.replace``'d into place. A
  crash mid-write never corrupts the resume point: a directory without a
  manifest is not a checkpoint.
* **Keep-k GC** — the oldest committed steps beyond ``keep`` are deleted
  after a successful commit (never before).
* **Async save** — ``save_async`` snapshots every leaf to host memory
  (``.detach().cpu()``, a copy even for a CPU tensor; the only sync) and
  commits on a worker thread, so the train loop overlaps checkpoint I/O
  with the next steps; ``wait`` joins it and raises its error.
* **Restore** — ``load_checkpoint`` copies each stored leaf into the
  matching tensor of the caller's tree, on that tensor's device and in its
  type, in place (a second copy of the model would not fit at full
  width); the keys must match.
* **Step metadata** — arbitrary JSON (data cursor, arch) rides in the
  manifest.

numpy has no bfloat16: such a leaf is stored as its 16-bit pattern
(uint16) and the manifest records its dtype.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(key, leaf) of a tree of nested mappings, keys joined by "/", in
    the tree's own order."""
    out = []
    for name, leaf in tree.items():
        key = f"{prefix}{name}"
        if isinstance(leaf, Mapping):
            out.extend(_flatten(leaf, key + "/"))
        else:
            out.append((key, leaf))
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def save_checkpoint(directory: str, step: int, tree: Mapping,
                    meta: Optional[Dict] = None) -> str:
    """Synchronous atomic checkpoint. Returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names = []
    for i, (key, leaf) in enumerate(_flatten(tree)):
        arr = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        names.append(dict(key=key, file=fname, shape=list(leaf.shape),
                          dtype=str(leaf.dtype).removeprefix("torch.")))
    manifest = dict(step=step, leaves=names, meta=meta or {})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _committed_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


@torch.no_grad()
def load_checkpoint(directory: str, tree: Mapping,
                    step: Optional[int] = None) -> Tuple[Mapping, int, Dict]:
    """Restore the latest (or `step`'s) commit into `tree`'s tensors in
    place. Returns (tree, step, meta)."""
    steps = _committed_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = dict(_flatten(tree))
    stored = [rec["key"] for rec in manifest["leaves"]]
    if sorted(stored) != sorted(leaves):
        raise ValueError(f"checkpoint {path} holds {len(stored)} leaves "
                         f"that do not match the model's {len(leaves)}: "
                         f"{sorted(set(stored) ^ set(leaves))[:5]}")
    for rec in manifest["leaves"]:
        t = torch.from_numpy(np.load(os.path.join(path, rec["file"])))
        if rec["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        dst = leaves[rec["key"]]
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint leaf {rec['key']}: shape "
                             f"{tuple(t.shape)} != {tuple(dst.shape)}")
        dst.copy_(t)
    return tree, manifest["step"], manifest.get("meta", {})


class CheckpointManager:
    """Keep-k + async wrapper around save/load."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---- save ------------------------------------------------------------
    def save(self, step: int, tree: Mapping, meta: Optional[Dict] = None
             ) -> None:
        save_checkpoint(self.directory, step, tree, meta)
        self._gc()

    def save_async(self, step: int, tree: Mapping,
                   meta: Optional[Dict] = None) -> None:
        """Snapshot to host now; write + commit on a worker thread."""
        self.wait()
        host = _snapshot(tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host, meta)
                self._gc()
            except BaseException as e:  # surfaced in wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---- load ------------------------------------------------------------
    def restore(self, tree: Mapping, step: Optional[int] = None
                ) -> Tuple[Mapping, int, Dict]:
        self.wait()
        return load_checkpoint(self.directory, tree, step)

    def latest_step(self) -> Optional[int]:
        steps = _committed_steps(self.directory)
        return steps[-1] if steps else None

    def _gc(self) -> None:
        steps = _committed_steps(self.directory)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)


def _snapshot(tree: Mapping) -> Dict[str, Any]:
    """A host copy of every leaf (a copy also of a CPU tensor, which the
    train loop goes on updating in place)."""
    return {name: _snapshot(leaf) if isinstance(leaf, Mapping)
            else leaf.detach().to("cpu", copy=True)
            for name, leaf in tree.items()}
