"""PyTorch port, the training launcher `repro_torch.launch.train` on the
CPU: the reference's contracts (tests/test_checkpoint_optim_data.py,
tests/test_system.py) held on the port.

* Killed at step 6 of 8 and resumed from the step-4 checkpoint, a run
  ends with the uninterrupted run's parameters and AdamW state bit for
  bit (the CPU's sums run in one order; on the card the bags' and the
  segment sums' atomics make the last bits run-dependent, and
  chip_smoke.py holds the resume within 1e-5), for the two-tower model,
  an LM and a GNN;
* the loss decreases over 10 steps, finite; for each GNN arch over 5
  steps (the reference's `test_smoke_train_step`);
* the CLI trains on the CPU; without a card a run that names no device
  raises; `rmce` is refused with the MCE launcher's name.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import train as train_mod
from repro_torch.launch.train import train


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "qwen3-14b",
                                  "mace"])
def test_train_restart_bitexact(tmp_path, arch):
    full = train(arch, steps=8, ckpt_dir=str(tmp_path / "a"), ckpt_every=4,
                 device="cpu")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        train(arch, steps=8, ckpt_dir=str(tmp_path / "b"), ckpt_every=4,
              fail_at_step=6, device="cpu")
    resumed = train(arch, steps=8, ckpt_dir=str(tmp_path / "b"),
                    ckpt_every=4, resume=True, device="cpu")
    assert resumed["restored_from"] == 4 and full["restored_from"] is None
    assert resumed["final_loss"] == full["final_loss"]
    got = dict(resumed["params"].named_parameters())
    for name, p in full["params"].named_parameters():
        assert torch.equal(p, got[name]), name
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [
        "step_00000004", "step_00000008"]


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "qwen3-14b"])
def test_train_loss_decreases(arch):
    out = train(arch, steps=10, log_every=3, device="cpu")
    assert [s for s, _ in out["losses"]] == [0, 3, 6, 9]
    assert np.isfinite(out["final_loss"])
    assert out["final_loss"] < out["losses"][0][1]


@pytest.mark.parametrize("arch", ["meshgraphnet", "schnet", "dimenet",
                                  "mace"])
def test_train_gnn_loss_decreases(arch):
    out = train(arch, steps=5, log_every=1, device="cpu")
    losses = [v for _, v in out["losses"]]
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_train_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: train() would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train("schnet", steps=1)


def test_train_cli_on_the_cpu(capsys):
    train_mod.main(["--arch", "two-tower-retrieval", "--steps", "2",
                    "--device", "cpu"])
    assert "final loss:" in capsys.readouterr().out


def test_train_refuses_other_families():
    with pytest.raises(ValueError, match="mce_run"):
        train("rmce", device="cpu")
