"""PyTorch port, configs: the arch registry against the reference's.

Every arch the port registers (the five LMs, two-tower-retrieval, rmce)
has the reference's family and source, and its `build()` and
`build_smoke()` equal the reference's field by field; its `shapes()`
cells equal the reference's. The four GNN archs wait for the GNN slice:
`get_arch` raises the registry's KeyError for them.
"""
import dataclasses

import pytest

from repro import configs as ref_configs
from repro_torch import configs

PORTED = ["chatglm3-6b", "command-r-plus-104b", "mixtral-8x7b",
          "phi3.5-moe-42b-a6.6b", "qwen3-14b", "rmce", "two-tower-retrieval"]
GNN = ["dimenet", "mace", "meshgraphnet", "schnet"]


def test_registry_is_the_reference_less_the_gnn_archs():
    assert configs.list_archs() == PORTED
    assert sorted(ref_configs.list_archs()) == sorted(PORTED + GNN)


@pytest.mark.parametrize("name", GNN + ["no-such-arch"])
def test_unported_arch_raises_the_reference_error(name):
    with pytest.raises(KeyError) as got:
        configs.get_arch(name)
    assert got.value.args[0] == (f"unknown arch '{name}'; known: "
                                 f"{PORTED}")


def _fields(cfg):
    assert dataclasses.is_dataclass(cfg)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("build", ["build", "build_smoke"])
def test_builds_equal_the_reference_field_by_field(name, build):
    spec, ref = configs.get_arch(name), ref_configs.get_arch(name)
    assert (spec.name, spec.family, spec.source) == (
        ref.name, ref.family, ref.source)
    got, want = getattr(spec, build)(), getattr(ref, build)()
    assert type(got).__name__ == type(want).__name__
    assert _fields(got) == _fields(want)
    assert type(got).__module__.startswith("repro_torch.")


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("build", ["build", "build_smoke"])
def test_shape_cells_equal_the_reference(name, build):
    spec, ref = configs.get_arch(name), ref_configs.get_arch(name)
    got = spec.shapes(getattr(spec, build)())
    want = ref.shapes(getattr(ref, build)())
    assert [(c.name, c.kind, c.meta, c.skip_reason) for c in got] == \
        [(c.name, c.kind, c.meta, c.skip_reason) for c in want]
    assert all(isinstance(c, configs.ShapeCell) for c in got)


def test_register_adds_an_arch(monkeypatch):
    from repro_torch.configs import base
    monkeypatch.setattr(base, "_REGISTRY", dict(base._REGISTRY))
    spec = configs.register(configs.ArchSpec(
        name="tiny", family="lm", build=lambda: None,
        build_smoke=lambda: None, shapes=lambda cfg: []))
    assert configs.get_arch("tiny") is spec
    assert "tiny" in configs.list_archs()
