"""PyTorch port, serving: `repro_torch.launch.serve` against the
reference's `repro.launch.serve`.

Both serve the reference's weights (its own `init_params` at PRNGKey(0),
carried across with `repro_torch.interop`) and numpy's prompts and
requests at seed 0. At float32 (the smoke configs `replace`d to float32 in
both registries for the test) `serve_lm`'s greedy tokens are identical
for all five LMs, the Mixtral prompt past its window included;
`serve_recsys`'s top-k candidates are identical, its scores within
1e-5. At bfloat16 the models are held in tests/test_torch_models_lm.py.
Sampling at temperature > 0 is the port's own seeded torch stream: the
same seed gives the same tokens. `main` serves both families on the CPU
with `--device cpu` and refuses other families.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.launch import serve as ref_serve
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.interop import (transformer_params_from_reference,
                                 two_tower_params_from_reference)
from repro_torch.launch import serve

pytest_plugins = ["torch_jax_executables"]

LM_ARCHS = ["qwen3-14b", "chatglm3-6b", "command-r-plus-104b",
            "mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]


def _float32_smoke(monkeypatch, arch):
    """Both registries' smoke build of `arch` at float32."""
    for spec in (ref_arch(arch), get_arch(arch)):
        build = spec.build_smoke
        monkeypatch.setattr(spec, "build_smoke", lambda build=build:
                            dataclasses.replace(build(), dtype="float32"))
    return get_arch(arch).build_smoke()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_lm_greedy_matches_reference(arch, monkeypatch):
    cfg = _float32_smoke(monkeypatch, arch)
    kw = dict(batch=3, prompt_len=40, new_tokens=8)
    want = ref_serve.serve_lm(arch, **kw)
    params = JT.init_params(ref_arch(arch).build_smoke(),
                            jax.random.PRNGKey(0))
    model = transformer_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, "cpu")
    got = serve.serve_lm(arch, device="cpu", params=model, **kw)
    assert got["generated"].shape == (3, 8)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["prefill_s"] > 0 and got["decode_s"] > 0
    assert got["tok_per_s"] == pytest.approx(3 * 8 / got["decode_s"])


def test_serve_lm_sampling_is_seeded():
    kw = dict(batch=2, prompt_len=8, new_tokens=12, temperature=0.8,
              device="cpu")
    one = serve.serve_lm("mixtral-8x7b", **kw)["generated"]
    again = serve.serve_lm("mixtral-8x7b", **kw)["generated"]
    other = serve.serve_lm("mixtral-8x7b", seed=1, **kw)["generated"]
    greedy = serve.serve_lm("mixtral-8x7b", **{**kw, "temperature": 0.0}
                            )["generated"]
    np.testing.assert_array_equal(one, again)
    vocab = get_arch("mixtral-8x7b").build_smoke().vocab
    assert one.min() >= 0 and one.max() < vocab
    np.testing.assert_array_equal(one[:, 0], greedy[:, 0])  # prefill's pick
    assert not np.array_equal(one, greedy)
    assert not np.array_equal(one, other)


def test_serve_recsys_matches_reference():
    want = ref_serve.serve_recsys()
    rcfg = ref_arch("two-tower-retrieval").build_smoke()
    params = JR.init_params(rcfg, jax.random.PRNGKey(0))
    model = two_tower_params_from_reference(
        jax.tree.map(np.asarray, params),
        get_arch("two-tower-retrieval").build_smoke(), "cpu")
    got = serve.serve_recsys(device="cpu", params=model)
    np.testing.assert_array_equal(got["top_idx"], want["top_idx"])
    # the reference's scores of the same candidates
    rng = np.random.default_rng(0)
    q = JR.synth_batch(rcfg, 1, seed=0, with_items=False)
    q["cand_id"] = rng.integers(0, rcfg.n_items, 4096).astype(np.int32)
    q["cand_tags"] = rng.integers(-1, rcfg.n_tags,
                                  (4096, rcfg.tags_len)).astype(np.int32)
    scores, idx = jax.jit(JR.make_retrieval_step(rcfg, top_k=10))(
        params, {k: jax.numpy.asarray(v) for k, v in q.items()})
    np.testing.assert_array_equal(np.asarray(idx), got["top_idx"])
    np.testing.assert_allclose(got["top_scores"], np.asarray(scores),
                               rtol=1e-5, atol=1e-5)
    assert got["serve_scores"].shape == (64, 256)
    assert got["qps"] == pytest.approx(64 / got["serve_s"])


@pytest.mark.parametrize("argv,expect", [
    (["--arch", "qwen3-14b", "--tokens", "3"], "tok/s"),
    (["--arch", "chatglm3-6b", "--smoke"], "tok/s"),
    (["--arch", "two-tower-retrieval"], "qps")])
def test_main_serves_on_the_cpu(argv, expect, capsys):
    serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert expect in out and out.startswith(("prefill", "retrieval"))


def test_main_refuses_other_families():
    with pytest.raises(SystemExit, match="lm/recsys"):
        serve.main(["--arch", "rmce", "--device", "cpu"])
    with pytest.raises(ValueError, match="not an LM arch"):
        serve.serve_lm("two-tower-retrieval", device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: serve.serve_lm("qwen3-14b"),
                 lambda: serve.serve_recsys(),
                 lambda: serve.main(["--arch", "qwen3-14b"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
