"""Arch registry plumbing + the LM arch family adapter."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

_REGISTRY: Dict[str, "ArchSpec"] = {}


@dataclasses.dataclass
class ShapeCell:
    """One (architecture × input shape) dry-run cell."""
    name: str
    kind: str                      # 'train' | 'prefill' | 'decode' | 'serve' | ...
    meta: dict
    skip_reason: Optional[str] = None


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str                                   # 'lm' | 'gnn' | 'recsys' | 'mce'
    build: Callable[[], object]                   # full-size model config
    build_smoke: Callable[[], object]             # reduced config, same family
    shapes: Callable[[object], List[ShapeCell]]   # cells for a model config
    source: str = ""                              # citation tag from the brief


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# LM family: the four assigned shape cells
# ---------------------------------------------------------------------------

def lm_shapes(cfg) -> List[ShapeCell]:
    cells = [
        ShapeCell("train_4k", "train", dict(seq_len=4096, global_batch=256)),
        ShapeCell("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
        ShapeCell("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ]
    if cfg.sliding_window is not None:
        cells.append(ShapeCell("long_500k", "decode",
                               dict(seq_len=524288, global_batch=1)))
    else:
        cells.append(ShapeCell(
            "long_500k", "decode", dict(seq_len=524288, global_batch=1),
            skip_reason="pure full-attention arch: 512k decode needs "
                        "sub-quadratic attention (see DESIGN.md)"))
    return cells
