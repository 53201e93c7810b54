"""The plain reference against marconet_tpu_torch at width 0.0625 on the
CPU, f32, from the same seeded weights: the comparison the benchmark makes
on the chip, at a size a test run holds."""

import pytest
import torch

from port_bench import harness

W = 0.0625
SEED = 2**31 + 12345


def small_config(cell, **extra):
    cfg = dict(cell.config, width=W, compute_dtype="float32", **extra)
    return cfg


@pytest.fixture
def cpu_convs():
    # oneDNN's strided 1x1 channels_last conv backward over 8 channels
    # corrupts the heap on this CPU build
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def page_run(cell_name, pages=3, **extra):
    cell = harness.Cell(cell_name)
    params = dict(cell.workload["params"], pages=pages, check_pages=pages,
                  **extra)
    drv = cell.driver(SEED, False, device="cpu", config=small_config(cell),
                      params=params)
    drv.setup()
    drv.run(0.0)
    drv.free()
    return drv


# the two page cells, and lines of 17-32 characters that the page server
# splits into two segments and stitches back
@pytest.mark.parametrize("cell,pages,extra", [
    ("line-4to16c", 3, {}),
    ("folder-17l", 1, {}),
    ("line-4to16c", 1, {"lines": [3, 3], "chars": [17, 32]})],
    ids=["line-4to16c", "folder-17l", "split-lines"])
def test_pages_equal_the_reference(cell, pages, extra):
    drv = page_run(cell, pages=pages, **extra)
    if extra:
        assert len(drv.seg_chars[0]) == 6
    checks = {n: v for n, v, _ in drv.check()}
    assert checks["bad_lines"] == 0
    # f32 on both sides: different summation orders only
    assert checks["sr_far64_pct"] == 0.0
    assert checks["prior_far64_pct"] == 0.0
    sr_mae = max(d[0] for d in drv.detail)
    prior_mae = max(d[2] for d in drv.detail)
    assert sr_mae < 0.01 and prior_mae < 0.01


# the training cell's step at 4 character slots a line, so the CPU holds it
SMALL_TRAIN = {"batches": 3, "slots": 4, "chars": [2, 4]}


def test_training_step_equals_the_reference(cpu_convs):
    cell = harness.Cell("train-step-f32-b2-s16")
    params = dict(cell.workload["params"], **SMALL_TRAIN)
    drv = cell.driver(SEED, False, device="cpu", config=small_config(cell),
                      params=params)
    drv.setup()
    drv.free()
    checks = {n: v for n, v, _ in drv.check()}
    assert checks["loss_gap"] < 1e-4
    assert checks["grad_norm_gap"] < 2e-3
    assert checks["change_norm_gap"] < 1e-2
