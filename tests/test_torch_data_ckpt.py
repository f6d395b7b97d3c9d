"""PyTorch port, data pipeline and checkpoint store against the reference.

`TokenStream` gives the reference's arrays bit for bit (the same numpy
draws); the Prefetcher keeps step order, stops on `close` and raises a
worker's error at the consumer. The checkpoint store keeps the
reference's contract (tests/test_checkpoint_optim_data.py): a roundtrip,
keep-k garbage collection, an async save whose snapshot is taken at the
call, a torn write ignored; and it restores into the caller's tensors in
place, bf16 included, refusing a tree with other keys.
"""
import os

import numpy as np
import pytest
import torch

from repro.data import Prefetcher as JPrefetcher
from repro.data import TokenStream as JTokenStream
from repro.data import synth_tokens as j_synth_tokens
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.data import Prefetcher, TokenStream, synth_tokens


@pytest.mark.parametrize("vocab,seq,batch,seed", [(1000, 16, 4, 7),
                                                  (151_936, 128, 8, 0),
                                                  (256, 33, 3, 5)])
def test_token_stream_matches_reference(vocab, seq, batch, seed):
    ours = TokenStream(vocab=vocab, seq_len=seq, global_batch=batch,
                       seed=seed)
    ref = JTokenStream(vocab=vocab, seq_len=seq, global_batch=batch,
                       seed=seed)
    for step in (0, 1, 12):
        for got, want in zip(ours.batch(step), ref.batch(step)):
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    toks, tgts = ours.batch(3)
    np.testing.assert_array_equal(toks[:, 1:], tgts[:, :-1])
    np.testing.assert_array_equal(synth_tokens(vocab, batch, seq, seed),
                                  j_synth_tokens(vocab, batch, seq, seed))


@pytest.mark.parametrize("cls", [Prefetcher, JPrefetcher])
def test_prefetcher_order_and_close(cls):
    pf = cls(lambda step: step * step, depth=2, start_step=3, num_steps=5)
    assert [(s, v) for s, v in pf] == [(i, i * i) for i in range(3, 8)]
    pf.close()


def test_prefetcher_close_stops_an_endless_worker():
    made = []
    pf = Prefetcher(lambda step: made.append(step) or step, depth=1)
    it = iter(pf)
    assert [next(it) for _ in range(3)] == [(0, 0), (1, 1), (2, 2)]
    pf.close()
    assert not pf._thread.is_alive()
    assert len(made) <= 5


def test_prefetcher_propagates_errors():
    def boom(step):
        if step == 2:
            raise ValueError("bad shard")
        return step

    pf = Prefetcher(boom, depth=1, num_steps=5)
    with pytest.raises(ValueError, match="bad shard"):
        list(pf)


def tree():
    return dict(a=torch.arange(6.0).reshape(2, 3),
                b=dict(c=torch.ones(4, dtype=torch.int32),
                       d=torch.tensor(2.5)),
                e=torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16))


def zeros_like_tree(t):
    return {k: zeros_like_tree(v) if isinstance(v, dict) else
            torch.zeros_like(v) for k, v in t.items()}


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])


def test_roundtrip(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), 3, t, meta=dict(cursor=7))
    into = zeros_like_tree(t)
    leaf = into["a"]
    got, step, meta = load_checkpoint(str(tmp_path), into)
    assert step == 3 and meta["cursor"] == 7
    assert got is into and into["a"] is leaf      # restored in place
    _equal(into, t)
    names = sorted(os.listdir(tmp_path / "step_00000003"))
    assert names == ["leaf_00000.npy", "leaf_00001.npy", "leaf_00002.npy",
                     "leaf_00003.npy", "manifest.json"]


def test_restore_refuses_another_tree(tmp_path):
    save_checkpoint(str(tmp_path), 1, tree())
    other = zeros_like_tree(tree())
    other["f"] = torch.zeros(2)
    with pytest.raises(ValueError, match="do not match"):
        load_checkpoint(str(tmp_path), other)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), other)


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree())
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert mgr.latest_step() == 4


def test_async_save_snapshots_at_the_call(tmp_path):
    """The tree is copied when save_async is called: a later in-place
    update (what the train loop does) does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = tree()
    mgr.save_async(5, t, meta=dict(x=1))
    t["a"].add_(100.0)
    mgr.wait()
    into = zeros_like_tree(t)
    _, step, meta = mgr.restore(into)
    assert step == 5 and meta["x"] == 1
    _equal(into, tree())


def test_async_save_error_raises_at_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker))
    mgr.save_async(1, tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                   # the error is raised once


def test_torn_write_ignored(tmp_path):
    """A .tmp directory, or one without a manifest, is not a checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree())
    os.makedirs(tmp_path / "step_00000002.tmp")
    os.makedirs(tmp_path / "step_00000003")
    assert mgr.latest_step() == 1
    into = zeros_like_tree(tree())
    assert mgr.restore(into)[1] == 1
