"""A run with the timed path broken underneath must come out ``correct: false``.

Each test drives the rest of a real run of a cell (its mode, the program's
entry points, the reference and the comparison) on the CPU at a size a test
can hold, with one fault planted in the program: a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, an answer altered where it is produced.  (No cell spans chips, so no
exchange between chips can be left out.)  The controls, the reference in the
nearest lower precision in the program's place, must fail too."""

import json

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


def _limits(workload):
    return harness.cell_files(workload)["cell"]["limits"]


@pytest.mark.parametrize("workload", ["rgb_int8pall_infer", "rgb_bf16_infer"])
def test_sound_runs_are_correct(workload):
    r = tiny.run(harness, workload)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["rgb_int8pall_infer", "rgb_bf16_infer"])
def test_an_answer_altered_where_it_is_produced(workload, monkeypatch):
    from bmcnet_esr_torch.models import bmcnet

    head = bmcnet._Model._head

    def altered(self, x_o, skip):
        out = head(self, x_o, skip)
        return out + 0.05 * out.abs().amax()

    monkeypatch.setattr(bmcnet._Model, "_head", altered)
    r = tiny.run(harness, workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["rgb_int8pall_infer", "rgb_bf16_infer"])
def test_a_step_that_returns_its_state_unchanged(workload, monkeypatch):
    from bmcnet_esr_torch.models import bmcnet

    forward = bmcnet._Model.forward

    def stuck(self, x, *states):
        out = forward(self, x, *states)
        return (*states[:-1], out[-1])

    monkeypatch.setattr(bmcnet._Model, "forward", stuck)
    # the state's share of the output grows with the width: at 32 channels a
    # frozen state moves it about as far as at the cells' own 128
    wide = {"config": {"model": {**tiny.CONFIG["model"], "n_c": 32}}}
    r = tiny.run(harness, workload, extra=wide)
    assert not r["correct"], r["checks"]


def test_a_train_step_that_leaves_the_state_unchanged(monkeypatch):
    from bmcnet_esr_torch.training import train_step

    def no_update(state, total, mse, skip_nonfinite, ema_decay, gnorm=None):
        state.step += 1
        return {"train_loss": total, "train_mse_loss": mse}

    monkeypatch.setattr(train_step, "apply_update", no_update)
    r = tiny.run(harness, "nfs_fp32_train")
    assert not r["correct"] and r["checks"]["change_gap"]["value"] >= 0.99


def test_half_of_the_batch_left_out(monkeypatch):
    from bmcnet_esr_torch.training import train_step

    loss = train_step.sequence_loss

    def half(model, batch, *args, **kwargs):
        b = next(iter(batch.values())).shape[0]
        return loss(model, {k: v[: b // 2] for k, v in batch.items()}, *args, **kwargs)

    monkeypatch.setattr(train_step, "sequence_loss", half)
    r = tiny.run(harness, "nfs_fp32_train")
    assert not r["correct"], r["checks"]


def test_the_train_cell_is_correct_when_sound():
    r = tiny.run(harness, "nfs_fp32_train")
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["rgb_int8pall_infer", "rgb_bf16_infer"])
def test_the_control_is_not_correct(workload):
    control = harness.cell_files(workload)["cell"]["control"]
    sound = tiny.run(harness, workload)["checks"]["pred_err"]["value"]
    r = tiny.run(harness, workload, extra=control)
    low = r["checks"]["pred_err"]["value"]
    assert not r["correct"] and low > 3 * sound, (sound, low, _limits(workload))


@pytest.mark.cuda
def test_the_train_control_is_not_correct():
    """TF32 exists on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on an NVIDIA GPU only")
    control = harness.cell_files("nfs_fp32_train")["cell"]["control"]
    r = harness.run_cell("nfs_fp32_train", 2**31 + 3, 1.0, False, overrides=control)
    assert not r["correct"], json.dumps(r["checks"])
