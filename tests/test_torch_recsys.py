"""PyTorch port, two-tower recsys: bags, towers, serve, bulk and retrieval
against the reference.

The reference's weights (`repro.models.recsys.init_params` at
PRNGKey(0), or PRNGKey(1)) are carried across with
`repro_torch.interop.two_tower_params_from_reference`; the same numpy
batches (`synth_batch`, copied as it is) go through both packages. Every
output is float32 and held at rtol = atol = 1e-5; top-k indices are
identical, ties included (the lower candidate index first, as
`jax.lax.top_k`). The bags run through the EmbeddingBag kernel's entry
point (its plain version here). The reference's own recsys tests
(tests/test_recsys.py) are repeated on the port as cases here, all but
the two that train (the training slice).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import recsys as JR
from repro_torch.configs import get_arch
from repro_torch.interop import two_tower_params_from_reference
from repro_torch.models import recsys as R

pytest_plugins = ["torch_jax_executables"]

TOL = dict(rtol=1e-5, atol=1e-5)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=[0, 1], ids=["key0", "key1"])
def towers(request):
    """(ref cfg, ref params, port cfg, port model) at the smoke config."""
    rcfg = ref_arch("two-tower-retrieval").build_smoke()
    cfg = get_arch("two-tower-retrieval").build_smoke()
    params = JR.init_params(rcfg, jax.random.PRNGKey(request.param))
    model = two_tower_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, "cpu")
    return rcfg, params, cfg, model


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = np.where(rng.random((9, 5)) < 0.6, rng.integers(0, 50, (9, 5)),
                   -1).astype(np.int32)
    ids[0] = -1                                     # an empty bag
    got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), mode)
    want = JR.embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embedding_bag_mean_semantics():
    table = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    ids = torch.tensor([[0, 1, -1], [5, -1, -1], [-1, -1, -1]],
                       dtype=torch.int32)
    np.testing.assert_allclose(R.embedding_bag(table, ids, mode="mean"),
                               [[1.0, 2.0], [10.0, 11.0], [0.0, 0.0]])
    np.testing.assert_allclose(R.embedding_bag(table, ids, mode="sum"),
                               [[2.0, 4.0], [10.0, 11.0], [0.0, 0.0]])


@pytest.mark.parametrize("batch,seed", [(32, 0), (7, 3)])
def test_synth_batch_is_the_reference(batch, seed):
    cfg = get_arch("two-tower-retrieval").build_smoke()
    rcfg = ref_arch("two-tower-retrieval").build_smoke()
    for with_items in (True, False):
        got = R.synth_batch(cfg, batch, seed=seed, with_items=with_items)
        want = JR.synth_batch(rcfg, batch, seed=seed, with_items=with_items)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_towers_match_reference(towers):
    rcfg, params, cfg, model = towers
    b = R.synth_batch(cfg, 32, seed=0)
    for tower, jtower in ((R.user_tower, JR.user_tower),
                          (R.item_tower, JR.item_tower)):
        got = tower(cfg, model, R.to_device(b, "cpu"))
        want = jtower(rcfg, params, _j(b))
        assert got.shape == (32, cfg.tower_mlp[-1])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                                   rtol=1e-4)


def test_serve_and_bulk_match_reference(towers):
    rcfg, params, cfg, model = towers
    b = R.synth_batch(cfg, 16, seed=3)
    b["cand_emb"] = np.random.default_rng(2).normal(
        size=(16, 256, cfg.tower_mlp[-1])).astype(np.float32)
    got = R.make_serve_step(cfg)(model, R.to_device(b, "cpu"))
    want = jax.jit(JR.make_serve_step(rcfg))(params, _j(b))
    assert got.shape == (16, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = R.make_bulk_score_step(cfg)(model, R.to_device(b, "cpu"))
    want = jax.jit(JR.make_bulk_score_step(rcfg))(params, _j(b))
    assert got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(np.abs(got.numpy()) <= 1.0 + 1e-5)        # cosine range


@pytest.mark.parametrize("n_cand,top_k,dups", [(512, 10, False),
                                               (4096, 10, True),
                                               (300, 25, True)])
def test_retrieval_matches_reference(towers, n_cand, top_k, dups):
    """Duplicated candidates (same id and tags) score exactly alike: the
    tied ones must come in the reference's order, lower index first."""
    rcfg, params, cfg, model = towers
    rng = np.random.default_rng(n_cand)
    q = R.synth_batch(cfg, 1, seed=5, with_items=False)
    q["cand_id"] = rng.integers(0, cfg.n_items, n_cand).astype(np.int32)
    q["cand_tags"] = rng.integers(-1, cfg.n_tags,
                                  (n_cand, cfg.tags_len)).astype(np.int32)
    if dups:
        # copy the query's best candidates onto later slots, twice
        scores0 = np.asarray(jax.jit(JR.make_retrieval_step(
            rcfg, top_k=n_cand))(params, _j(q))[1])
        best = scores0[:top_k // 2]
        for rep, slot in enumerate((n_cand // 3, n_cand // 2)):
            dst = slot + np.arange(len(best)) * 2 + rep
            q["cand_id"][dst] = q["cand_id"][best]
            q["cand_tags"][dst] = q["cand_tags"][best]
    want_scores, want_idx = jax.jit(JR.make_retrieval_step(
        rcfg, top_k=top_k))(params, _j(q))
    scores, idx = R.make_retrieval_step(cfg, top_k=top_k)(
        model, R.to_device(q, "cpu"))
    assert scores.shape == idx.shape == (top_k,)
    if dups:
        assert len(set(np.asarray(want_scores).tolist())) < top_k   # ties
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), **TOL)


def test_param_count_and_init_match_reference():
    for build in ("build", "build_smoke"):
        got = getattr(get_arch("two-tower-retrieval"), build)()
        want = getattr(ref_arch("two-tower-retrieval"), build)()
        assert got.param_count() == want.param_count()
    cfg = get_arch("two-tower-retrieval").build_smoke()
    model = R.init_params(cfg, torch.Generator().manual_seed(0))
    ref = JR.init_params(ref_arch("two-tower-retrieval").build_smoke(),
                         jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    for name in ("user_id_table", "item_id_table", "geo_table", "tag_table"):
        mine = getattr(model, name)
        assert tuple(mine.shape) == ref[name].shape
        assert float(mine.std()) == pytest.approx(0.02, rel=0.1)
    for tower in ("user_mlp", "item_mlp"):
        mlp = getattr(model, tower)
        for i, (w, b) in enumerate(zip(mlp.w, mlp.b)):
            assert tuple(w.shape) == ref[tower][f"w{i}"].shape
            assert float(w.std()) == pytest.approx(
                float(np.std(ref[tower][f"w{i}"])), rel=0.1)
            assert not b.any()


# ---------------------------------------------------------------------------
# the reference's own recsys tests (tests/test_recsys.py) on the port
# ---------------------------------------------------------------------------

def test_towers_normalised():
    cfg = get_arch("two-tower-retrieval").build_smoke()
    model = R.init_params(cfg, torch.Generator().manual_seed(0))
    b = R.to_device(R.synth_batch(cfg, 32, seed=0), "cpu")
    u = R.user_tower(cfg, model, b)
    v = R.item_tower(cfg, model, b)
    assert u.shape == (32, cfg.tower_mlp[-1])
    np.testing.assert_allclose(torch.linalg.norm(u, dim=-1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(torch.linalg.norm(v, dim=-1), 1.0, rtol=1e-4)


def test_serve_and_bulk_shapes():
    cfg = get_arch("two-tower-retrieval").build_smoke()
    model = R.init_params(cfg, torch.Generator().manual_seed(0))
    b = R.synth_batch(cfg, 16, seed=3)
    b["cand_emb"] = np.random.default_rng(2).normal(
        size=(16, 256, cfg.tower_mlp[-1])).astype(np.float32)
    b = R.to_device(b, "cpu")
    assert R.make_serve_step(cfg)(model, b).shape == (16, 256)
    out = R.make_bulk_score_step(cfg)(model, b)
    assert out.shape == (16,)
    assert bool((out.abs() <= 1.0 + 1e-5).all())
