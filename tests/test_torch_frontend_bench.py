"""The port's front end (``marconet_tpu_torch.models.frontend``) and the
page server in front of it against the benchmark's plain reference
(``port_bench/reference/frontend.py`` and ``nets.py``), on the CPU in f32.

Both sides hold the same seeded weights (``port_bench.weights.make_weights``
over the reference's Ultralytics- and ModelScope-keyed specs): YOLO11-m at
its published widths on small letterboxes (``imgsz`` 128), a small
ConvNeXt-ViT, and the restore at width 0.0625. Compared: the letterbox and
OpenCV's resize and blur to the byte, YOLO before NMS, the kept boxes, the
masked windows, the recognizer's logits on the program's windows, each
box's character where the reference's logits decide it, and the restore
given the program's labels and locs; then the front end's spans and
counts, and the data-parallel cell's reference at one rank against the
training cell's.
"""

import numpy as np
import pytest
import torch

from marconet_tpu_torch.models import frontend as pfe
from marconet_tpu_torch.models.convnext_ocr import ConvNextViT, OCRConfig
from marconet_tpu_torch.models.yolo import YOLO11
from marconet_tpu_torch.utils import image
from port_bench.reference import frontend as rfe
from port_bench.reference import nets
from port_bench.reference import page as ref_page
from port_bench.weights import make_weights

OCR = {"depths": [1, 1, 1, 1], "dims": [8, 16, 24, 32], "vit_depth": 2,
       "vit_dim": 32, "vit_heads": 2, "vit_mlp_ratio": 4.0,
       "num_classes": 6736, "blank_index": 0, "seq_len": 20}
IMGSZ, MAX_DET = 128, 20
SEED = 2**31 + 23
WIDTH = 0.0625
# (height, width) of the seeded noise lines: 4, 7, 12 and 16 square
# characters at the LQ height, and a taller line the letterbox shrinks
LINES = ((32, 128), (32, 224), (32, 384), (32, 512), (48, 300))


def _line(i):
    h, w = LINES[i]
    return np.random.default_rng([SEED, i]).integers(
        0, 256, (h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def weights():
    torch.set_num_threads(1)
    return make_weights({"yolo": rfe.yolo_spec(), "ocr": rfe.ocr_spec(OCR)},
                        SEED, "cpu")


@pytest.fixture(scope="module")
def fe(weights):
    meta = dict(device="meta", generator=torch.Generator())
    yolo = YOLO11(nc=1, **meta)
    yolo.load_state_dict(weights["yolo"], strict=True, assign=True)
    cfg = {k: v for k, v in OCR.items()
           if k not in ("depths", "dims")}
    ocr = ConvNextViT(OCRConfig(depths=tuple(OCR["depths"]),
                                dims=tuple(OCR["dims"]), **cfg), **meta)
    ocr.load_state_dict(weights["ocr"], strict=True, assign=True)
    return pfe.CharacterFrontend(yolo, ocr, imgsz=IMGSZ, max_det=MAX_DET,
                                 device="cpu")


@pytest.fixture(scope="module")
def ctx(weights):
    return {k: nets.Ctx(v) for k, v in weights.items()}


def _ref_raw(ctx, img):
    padded, gain, pad = rfe.letterbox(img, IMGSZ)
    x = torch.from_numpy(padded[None].astype(np.float32) / 255.0)
    with torch.no_grad():
        b, s = rfe.yolo_forward(ctx["yolo"], x)
    return b[0].numpy(), s[0, :, 0].numpy(), gain, pad


def _windows(fe, img, boxes):
    segs = [pfe.mask_segment(img, boxes, j) for j in range(len(boxes))]
    width = fe.ocr.config.canonical_width
    return (np.stack([pfe.prepare_segment(s, width) for s, _ in segs]),
            [s for _, s in segs])


@pytest.mark.parametrize("hw", [(32, 128), (32, 512), (48, 300), (64, 40),
                                (20, 700)])
def test_letterbox_equals_the_reference(hw):
    img = np.random.default_rng(hw).integers(0, 256, hw + (3,),
                                             dtype=np.uint8)
    got, want = pfe.letterbox(img, IMGSZ), rfe.letterbox(img, IMGSZ)
    assert np.array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[0].shape[:2] == rfe.letterbox_shape(*hw, IMGSZ)


@pytest.mark.parametrize("src,dst", [((32, 128), (160, 640)),
                                     ((48, 300), (27, 170)),
                                     ((32, 77), (32, 300)),
                                     ((7, 513), (64, 64))])
def test_linear_resize_equals_the_reference(src, dst):
    img = np.random.default_rng(src + dst).integers(0, 256, src + (3,),
                                                    dtype=np.uint8)
    assert np.array_equal(image.resize_linear_u8(img, dst[1], dst[0]),
                          rfe.resize_linear(img, dst[1], dst[0]))


@pytest.mark.parametrize("w", [9, 40, 301])
def test_mask_blur_equals_the_reference(w):
    gen = np.random.default_rng(w)
    mask = np.zeros((32, w), np.uint8)
    for lo in gen.integers(0, w, 3):
        mask[:, lo:lo + gen.integers(1, 12)] = 255
    noise = gen.integers(0, 256, (17, w), dtype=np.uint8)
    for img in (mask, noise):
        assert np.array_equal(image.gaussian_blur_u8(img, 15),
                              rfe.gaussian_blur(img, 15))


@pytest.mark.parametrize("i", range(len(LINES)))
def test_yolo_before_nms_equals_the_reference(fe, ctx, i):
    img = _line(i)
    padded, _, _ = pfe.letterbox(img, IMGSZ)
    x = torch.from_numpy(padded[None].astype(np.float32) / 255.0)
    with torch.inference_mode():
        boxes, scores = fe.yolo(x)
    want_b, want_s, _, _ = _ref_raw(ctx, img)
    np.testing.assert_allclose(boxes[0].numpy(), want_b, rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(scores[0, :, 0].numpy(), want_s, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("i", range(len(LINES)))
def test_kept_boxes_equal_the_reference(fe, ctx, i):
    img = _line(i)
    got = fe.detect_boxes(img)
    want = rfe.line_boxes(*_ref_raw(ctx, img), img.shape[:2], fe.conf,
                          fe.iou, fe.max_det)
    assert got.shape == want.shape and len(got) >= 1
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("i", range(len(LINES)))
def test_masked_windows_equal_the_reference(fe, i):
    img = _line(i)
    boxes = fe.detect_boxes(img)
    got, starts = _windows(fe, img, boxes)
    width = fe.ocr.config.canonical_width
    want = [rfe.masked_window(img, boxes, j) for j in range(len(boxes))]
    assert starts == [s for _, s in want]
    assert np.array_equal(got, np.stack([rfe.recognizer_input(s, width)
                                         for s, _ in want]))


def test_masked_windows_of_many_boxes_equal_the_reference(fe):
    """Eight boxes, so the 5-box window slides; the first and last
    boxes widen by 12 px at the line's ends."""
    img = _line(3)
    boxes = np.array([(64 * k + 3, 2, 64 * k + 50, 30) for k in range(8)])
    got, starts = _windows(fe, img, boxes)
    want = [rfe.masked_window(img, boxes, j) for j in range(8)]
    assert starts == [s for _, s in want] == [0, 0, 0, 1, 2, 3, 3, 3]
    assert np.array_equal(got, np.stack([rfe.recognizer_input(
        s, fe.ocr.config.canonical_width) for s, _ in want]))


def test_recognizer_logits_and_characters_equal_the_reference(fe, ctx):
    img = _line(2)
    det = fe(img)
    segs, starts = _windows(fe, img, det.boxes)
    x = torch.from_numpy(rfe.normalize(segs))
    with torch.inference_mode():
        got = fe.ocr(x).numpy()
    with torch.no_grad():
        want = rfe.ocr_forward(ctx["ocr"], x, OCR).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    chars = rfe.box_chars([rfe.ctc_text(ids, ref_page.alphabet())
                           for ids in want.argmax(-1)], starts)
    top2 = np.sort(want, -1)[..., -2:]
    sure = ((top2[..., 1] - top2[..., 0]) > 1e-3).all(-1)
    assert sure.any()
    assert [c for c, s in zip(det.chars, sure) if s] == \
        [c for c, s in zip(chars, sure) if s]
    centers = det.locs[0::2].astype(np.float32).tolist()
    assert centers == rfe.center_locs(det.boxes, img.shape[0])


def test_restore_given_the_programs_labels_and_locs(fe):
    """The page server with the front end, at width 0.0625 in f32, against
    the reference's restore of the labels and locs the front end gave."""
    from marconet_tpu_torch.models.pipeline import MARCONet
    from marconet_tpu_torch.serve import TextPageRestorer

    specs = {"encoder": nets.encoder_spec(WIDTH),
             "prior": nets.prior_spec(WIDTH), "srnet": nets.srnet_spec(WIDTH)}
    sd = make_weights(specs, SEED, "cpu")
    net = MARCONet(WIDTH, device="cpu", seed=0)
    for name, s in sd.items():
        getattr(net, name).load_state_dict(s, strict=True)
    restorer = TextPageRestorer(net, frontend=fe)
    img = _line(1)
    res = restorer.restore_page(img, [(0, 0, img.shape[1], img.shape[0])])
    det = fe(img)
    chars = ref_page.alphabet()
    labels = [chars.find(c) for c in det.text if chars.find(c) >= 0][:16]
    assert res[0].text == "".join(chars[i] for i in labels) and labels
    x, show, _, _ = ref_page.prepare(img, "", [], chars)
    with torch.no_grad():
        sr, priors = nets.restore_lines(
            {k: nets.Ctx(v) for k, v in sd.items()},
            torch.from_numpy(x[None]), [labels],
            [det.locs[0:2 * len(labels):2].tolist()])
    want_sr = ref_page.pack_u8(sr[0, :, :show])
    want_pri = ref_page.pack_u8(priors[0])
    assert res[0].sr.shape == want_sr.shape
    assert res[0].priors.shape == want_pri.shape
    assert np.abs(res[0].sr.astype(int) - want_sr).max() <= 1
    assert np.abs(res[0].priors.astype(int) - want_pri).max() <= 1


def test_counts_and_spans_of_one_call(fe):
    """One line under ``torch.profiler``: one image, its kept boxes, one
    window a box and the recognizer's rows padded to a power of two; the
    three spans, one after another."""
    from port_bench import trace as bench_trace

    before = {k: getattr(fe, k) for k in ("images", "boxes", "segments",
                                          "ocr_rows")}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        det = fe(_line(4))
    n = len(det.boxes)
    assert n >= 1
    got = {k: getattr(fe, k) - v for k, v in before.items()}
    assert got == {"images": 1, "boxes": n, "segments": n,
                   "ocr_rows": 1 << (n - 1).bit_length()}
    # three windows run as four recognizer rows
    fe.recognize_segments([np.zeros((32, 50, 3), np.uint8)] * 3)
    assert fe.segments - before["segments"] == n + 3
    assert fe.ocr_rows - before["ocr_rows"] == got["ocr_rows"] + 4
    spans = [s for s in bench_trace.summarize(prof)["host_spans"]
             if s[2].startswith("frontend/")]
    assert [s[2] for s in spans] == ["frontend/detect", "frontend/mask",
                                     "frontend/recognize"]
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_data_parallel_reference_at_one_rank_is_the_training_cells():
    """``train_dp.GlobalReference`` over one rank's batch takes the step
    of ``reference/train.py``: the same losses and first gradients."""
    from port_bench.reference import train as ref_train
    from port_bench.traffic import train_dp, train_steps

    params = {"world": 1, "batches": 1, "batch": 2, "slots": 4,
              "chars": [2, 4], "box_px": [48, 120], "size_seed": 0}
    raw = train_dp.rank_pool(params, SEED, 0)[0]
    batch = {k: torch.from_numpy(v)
             for k, v in ref_train.prepare_batch(*raw).items()}
    with torch.backends.mkldnn.flags(enabled=False):
        one = ref_train.Reference(make_weights(train_steps.specs(WIDTH, 4),
                                               SEED, "cpu"), WIDTH)
        want = one.step(batch)
        ref = train_dp.GlobalReference(make_weights(
            train_steps.specs(WIDTH, 4), SEED, "cpu"), WIDTH)
        got = ref.global_step([batch])
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6)
    for name in one.opt:
        for g, w in zip(ref.first_moments(name), one.first_moments(name)):
            assert (g is None) == (w is None)
            if g is not None:
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-8)
