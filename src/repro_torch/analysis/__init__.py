"""mce_lint for the port: AST-based static analysis of `repro_torch`, the
counterpart of the reference's `repro.analysis`.

Five rule families keep the reference's ids (DESIGN.md §7), each read on
the port's source:

* R1 layering                      (layering.py — declarative LAYERS)
* R2 accumulators left unset       (kernel_rules.py — CUDA atomics)
* R3 fails only on the hardware    (kernel_rules.py — C prototypes)
* R4 host syncs in the step        (tracer_rules.py — declared ROOTS)
* R5 donation                      (donation.py — declared DONORS)

The package is stdlib-only: it imports neither torch nor jax, so
`python -m repro_torch.analysis` runs without either installed.
"""
from repro_torch.analysis.cli import RULE_FAMILIES, analyze, main
from repro_torch.analysis.findings import Finding, Suppressions
from repro_torch.analysis.layering import LAYERS, LayerRule
from repro_torch.analysis.modindex import PackageIndex

__all__ = [
    "RULE_FAMILIES", "analyze", "main", "Finding", "Suppressions",
    "LAYERS", "LayerRule", "PackageIndex",
]
