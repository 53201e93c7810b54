"""The correctness check fails what it has to fail.

Each test drives the rest of a run on the CPU at width 0.0625 (the look for
a chip skipped) with the timed path broken underneath, or with the control
in the program's place, and sees ``correct`` come out false under the
configuration's own limits."""

import time

import pytest
import torch

from port_bench import harness
from port_bench.tests.test_bench_reference import (
    SEED,
    SMALL_TRAIN,
    small_config,
)

LINE = "line-4to16c"
TRAIN = "train-step-f32-b2-s16"


def run(cell_name, params):
    cell = harness.Cell(cell_name)
    fields, checks = harness.measure(
        cell, SEED, 0.0, False, "cpu", time.perf_counter(),
        config=small_config(cell), params=dict(cell.workload["params"],
                                               **params))
    return fields, checks


@pytest.fixture
def cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


LINE_PARAMS = {"pages": 2, "lines": [3, 3], "check_pages": 2}


def test_sound_page_run_is_correct():
    fields, _ = run(LINE, LINE_PARAMS)
    assert fields["correct"] and fields["failed"] == 0


def _patch_restore(monkeypatch, alter):
    from marconet_tpu_torch.models.pipeline import MARCONet
    orig = MARCONet.restore

    def restore(self, *args):
        return alter(orig(self, *args))

    monkeypatch.setattr(MARCONet, "restore", restore)


def test_altered_answers_fail(monkeypatch):
    # each line is handed its neighbour's answer
    _patch_restore(monkeypatch, lambda out: out._replace(
        sr=out.sr.roll(1, 0), priors=out.priors.roll(1, 0)))
    assert not run(LINE, LINE_PARAMS)[0]["correct"]


def test_half_the_batch_left_out_fails(monkeypatch):
    def half(out):
        b = out.sr.shape[0]
        sr, priors = out.sr.clone(), out.priors.clone()
        sr[b // 2:] = 0
        priors[b // 2:] = 0
        return out._replace(sr=sr, priors=priors)

    _patch_restore(monkeypatch, half)
    assert not run(LINE, LINE_PARAMS)[0]["correct"]


def test_page_control_fails():
    """The reference one precision below bf16 (fp8 operands) in the
    program's place."""
    cell = harness.Cell(LINE)
    drv = cell.driver(SEED, False, device="cpu", config=small_config(cell),
                      params=dict(cell.workload["params"], **LINE_PARAMS))
    drv.setup()
    drv.run(0.0)
    drv.free()
    checks = drv.check(rounding=cell.config["control"])
    assert not harness.judge(checks)


TRAIN_PARAMS = SMALL_TRAIN


def test_sound_training_run_is_correct(cpu_convs):
    assert run(TRAIN, TRAIN_PARAMS)[0]["correct"]


def test_unchanged_state_fails(cpu_convs, monkeypatch):
    from marconet_tpu_torch.train.train_step import MARCONetTrainer
    monkeypatch.setattr(MARCONetTrainer, "_update", lambda self, name: None)
    fields, checks = run(TRAIN, TRAIN_PARAMS)
    assert not fields["correct"]
    assert dict((n, v) for n, v, _ in checks)["change_norm_gap"] == 1.0


def test_half_the_training_batch_fails(cpu_convs, monkeypatch):
    from marconet_tpu_torch.train.train_step import (
        MARCONetTrainer,
        TrainBatch,
    )
    orig = MARCONetTrainer.train_step

    def half(self, batch, marks=None):
        return orig(self, TrainBatch(*(t[:1] for t in batch)), marks)

    monkeypatch.setattr(MARCONetTrainer, "train_step", half)
    assert not run(TRAIN, TRAIN_PARAMS)[0]["correct"]


def test_training_control_fails(cpu_convs):
    """The reference with its products' operands rounded to TF32 in the
    program's place."""
    cell = harness.Cell(TRAIN)
    drv = cell.driver(SEED, False, device="cpu", config=small_config(cell),
                      params=dict(cell.workload["params"], **TRAIN_PARAMS))
    drv.setup()
    drv.free()
    assert not harness.judge(drv.check(rounding=cell.config["control"]))
