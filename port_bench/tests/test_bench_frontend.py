"""The front-end cell's check and counts, and the data-parallel cell's
ranks, on the CPU.

The front-end cell runs at a size the CPU holds (YOLO11-m on letterboxes of
``imgsz`` 128, a small ConvNeXt-ViT, the restore at width 0.0625 in f32):
a sound run is correct; the control (TF32 in the front end's nets, fp8 in
the restore) in the program's place, and a program whose NMS keeps boxes
that overlap, are not. The operation counts equal
``torch.utils.flop_counter`` over the reference. Two gloo ranks run the
data-parallel driver through the harness and agree with the global
reference on every loss."""

import time

import pytest
import torch

from port_bench import harness
from port_bench.counts import flops
from port_bench.counts import frontend as counts
from port_bench.reference import frontend as rfe
from port_bench.reference import nets
from port_bench.tests.test_bench_reference import SEED, small_config
from port_bench.weights import make_weights

FE = "frontend-line-4to16c"
SMALL_OCR = {"depths": [1, 1, 1, 1], "dims": [8, 16, 24, 32],
             "vit_depth": 2, "vit_dim": 32, "vit_heads": 2,
             "vit_mlp_ratio": 4.0, "num_classes": 6736, "blank_index": 0,
             "seq_len": 20}
FE_PARAMS = {"pages": 4, "check_pages": 3}


def fe_config(cell, **frontend):
    cfg = small_config(cell)
    cfg["frontend"] = dict(cfg["frontend"], imgsz=128, max_det=20,
                           ocr=SMALL_OCR, **frontend)
    return cfg


def fe_run(seconds=0.5, **frontend):
    cell = harness.Cell(FE)
    return harness.measure(
        cell, SEED, seconds, False, "cpu", time.perf_counter(),
        config=fe_config(cell, **frontend),
        params=dict(cell.workload["params"], **FE_PARAMS))


def test_sound_frontend_run_is_correct():
    fields, checks = fe_run()
    assert fields["correct"] and fields["failed"] == 0
    got = {n: v for n, v, _ in checks}
    assert got["bad_lines"] == got["box_lines_off"] == 0
    assert got["segment_levels"] == 0
    assert got["sr_far64_pct"] == got["prior_far64_pct"] == 0.0


def test_frontend_control_fails():
    cell = harness.Cell(FE)
    drv = cell.driver(SEED, False, device="cpu", config=fe_config(cell),
                      params=dict(cell.workload["params"], **FE_PARAMS))
    drv.setup()
    drv.run(0.0)
    drv.free()
    checks = {n: (v, lim) for n, v, lim in
              drv.check(rounding=cell.config["control"])}
    assert not harness.judge([(n, v, lim) for n, (v, lim) in checks.items()])
    # each precision's own numbers: TF32 in the nets, fp8 in the restore
    assert checks["yolo_raw_gap"][0] > checks["yolo_raw_gap"][1]
    assert checks["sr_far64_pct"][0] > checks["sr_far64_pct"][1]


def test_overlapping_boxes_kept_fail(monkeypatch):
    """The program's NMS at IoU 0.9 where the configuration says 0.1."""
    from marconet_tpu_torch.models import frontend, yolo

    orig = yolo.nms_static

    def loose(boxes, scores, max_det=100, iou_thresh=0.1, conf_thresh=0.07):
        return orig(boxes, scores, max_det, 0.9, conf_thresh)

    monkeypatch.setattr(frontend, "nms_static", loose)
    fields, checks = fe_run(seconds=0.0)
    assert not fields["correct"]
    assert dict((n, v) for n, v, _ in checks)["box_lines_off"] > 0


@pytest.mark.parametrize("hw", [(32, 64), (64, 96)])
def test_yolo_count_equals_the_reference(hw):
    ctx = nets.Ctx(make_weights({"yolo": rfe.yolo_spec()}, 3, "cpu")["yolo"])
    x = torch.rand(1, *hw, 3)
    assert flops.count(lambda: rfe.yolo_forward(ctx, x)) == counts.yolo(*hw)


def test_recognizer_count_equals_the_reference():
    ctx = nets.Ctx(make_weights({"ocr": rfe.ocr_spec(SMALL_OCR)}, 3,
                                "cpu")["ocr"])
    x = torch.rand(2, 32, 4 * SMALL_OCR["seq_len"], 3)
    assert flops.count(lambda: rfe.ocr_forward(ctx, x, SMALL_OCR)) == \
        2 * counts.ocr(4 * SMALL_OCR["seq_len"], SMALL_OCR)


def test_published_sizes():
    """YOLO11-m at 640 x 640 (Ultralytics: 68.0 GFLOPs with its non-matmul
    work) and the ConvNeXt-T + 12-block ViT recognizer at 300 x 32."""
    ocr = harness.Cell(FE).config["frontend"]["ocr"]
    assert 60e9 < counts.yolo(640, 640) < 68e9
    assert 15e9 < counts.ocr(300, ocr) < 25e9
    assert counts.restore_lines(2, 7) == pytest.approx(
        flops.restore_line(3) + flops.restore_line(4))


def test_two_gloo_ranks_step_as_the_global_reference():
    """The data-parallel driver at two ranks on the CPU (the harness's
    process and one spawned rank): steps in the window, and the global
    losses of its first steps equal the reference's. At width 0.0625 the
    random LPIPS's all-zero feature vectors (normalized by
    ``rsqrt(sum + 1e-10)``) amplify the summation order of a batch into the
    SR net's gradients, so only the losses are held here."""
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    cell = harness.Cell("train-dp4-f32-b2-s16", bench=bench)
    params = dict(cell.workload["params"], world=2, batches=3, slots=4,
                  chars=[2, 4])
    with torch.backends.mkldnn.flags(enabled=False):
        fields, checks = harness.measure(
            cell, SEED, 1.0, False, "cpu", time.perf_counter(),
            config=small_config(cell), params=params)
    assert fields["attempted"] >= 1 and fields["failed"] == 0
    assert dict((n, v) for n, v, _ in checks)["loss_gap"] < 1e-5
