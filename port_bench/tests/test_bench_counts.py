"""The counts of operations and bytes, held to the reference's own work."""

import math

import pytest
import torch

from port_bench.counts import bytes as by
from port_bench.counts import flops, roofline
from port_bench.reference import nets
from port_bench.weights import make_weights

W = 0.0625


def _ctxs(width=W, seed=5):
    sd = make_weights({"encoder": nets.encoder_spec(width),
                       "prior": nets.prior_spec(width),
                       "srnet": nets.srnet_spec(width)}, seed, "cpu")
    return {k: nets.Ctx(v) for k, v in sd.items()}


def test_restore_flops_linear_in_characters():
    per = [flops.restore_line(n) for n in range(1, 17)]
    step = per[1] - per[0]
    assert all(math.isclose(b - a, step) for a, b in zip(per, per[1:]))
    # the published widths: ~685 GFLOP a line of one character, ~89 a
    # further character (torch.utils.flop_counter over the port)
    assert 600e9 < per[0] < 760e9
    assert 80e9 < step < 100e9


@pytest.mark.parametrize("n_chars", [1, 3])
def test_restore_flops_equal_the_reference_count(n_chars):
    ctxs = _ctxs()
    lq = torch.rand(1, 32, 512, 3) * 2 - 1
    labels = [[7 * i + 1 for i in range(n_chars)]]
    centers = [[(64 + 96 * i) / 512 for i in range(n_chars)]]
    counted = flops.count(lambda: nets.restore_lines(ctxs, lq, labels,
                                                     centers))
    assert counted == flops.restore_line(n_chars, W)


def test_train_step_flops_from_the_reference():
    """One reference step's count exceeds three forwards of the G nets
    over its lines (forward and backward of each), and is stable."""
    from port_bench.reference import train as ref_train
    from port_bench.traffic import train_steps

    torch.backends.mkldnn.enabled = False
    params = {"batches": 1, "batch": 2, "slots": 16, "chars": [4, 16],
              "box_px": [48, 120], "size_seed": 0}
    raw = train_steps.make_pool(params, 3)[0]
    batch = {k: torch.from_numpy(v)
             for k, v in ref_train.prepare_batch(*raw).items()}

    def count():
        ref = ref_train.Reference(make_weights(train_steps.specs(W), 3,
                                               "cpu"), W)
        return flops.count(ref.step, batch)

    ops = count()
    # the G nets' forward over the lines and all 32 slots, and its
    # backward (at least as much again)
    fwd = 2 * (flops.encoder(W) + flops.srnet_trunk(W)) + \
        32 * flops.prior(W)
    assert ops > 2 * fwd
    assert count() == ops


def test_k1_bytes_by_hand():
    # full width, one slot, bf16: 8 MLP sites of 512 and the 11 convs
    elems = 8 * 512 + 512 * 16 + 2 * (512 * 64 + 512 * 256 + 512 * 1024
                                      + 256 * 4096 + 128 * 16384)
    chans = 8 * 512 + 512 + 2 * (512 * 3 + 256 + 128)
    assert by.k1_bytes(1, 2) == (2 * elems + chans) * 2
    assert by.k1b_bytes(1, 4) == (3 * elems + chans) * 4
    assert by.k1_bytes(10, 2) - by.k1_bytes(9, 2) == 2 * elems * 2


def test_k2_bytes_by_hand():
    # one row, two windows side by side and one overlapping the first
    centers = [[48 / 512, 80 / 512, 56 / 512]]
    assert by.covered_columns(centers[0], 16, 512) == 64
    assert by.covered_columns(centers[0], 32, 1024) == 128
    d = 256
    want = (2 * 32 * 512 * d + 64 * 32 * d) * 2 + 3 * 4 * 4 \
        + (2 * 64 * 1024 * d + 128 * 64 * d) * 2 + 3 * 4 * 4
    assert by.k2_bytes(1, 4, centers, 2) == want


def test_edge_windows_are_clamped():
    assert by.covered_columns([0.0], 16, 512) == 16
    assert by.covered_columns([1.0], 16, 512) == 16


def test_roofline_by_hand():
    # 3.35 GB at 3.35 TB/s is 1 ms; 67 GFLOP at 67 TFLOP/s is 1 ms
    assert math.isclose(roofline.least_seconds(3.35e9), 1e-3)
    assert math.isclose(roofline.least_seconds(1e9, 67e9), 1e-3)
    assert math.isclose(roofline.share_pct(1e-3, 4e-3), 25.0)
    assert roofline.share_pct(1e-3, 0.0) is None
    assert math.isclose(roofline.mfu_pct(989e12, 2.0, 989e12), 50.0)
