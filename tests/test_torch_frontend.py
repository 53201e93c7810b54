"""The port's front-end (``marconet_tpu_torch.models.{yolo, convnext_ocr,
frontend}`` and the loaders in ``convert``) against the JAX package's.

Both sides hold the same weights: ``tests/yolo_oracle.fabricate_yolo_sd``
(ultralytics yolo11m keys, one class) and ``tests/ocr_spec.
modelscope_ocr_state_spec`` (a small ModelScope ConvNextViT), loaded by
the JAX converters and by the port's strict loaders. Inputs are made with
numpy from a seed; everything runs on the CPU in f32. cv2's IPP layer is
switched off while the JAX side resizes and blurs (fixture ``no_ipp``), so
the host helpers are held to the byte.
"""

import json

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from marconet_tpu.convert.ocr_import import (
    ConversionError as JaxConversionError,
    convert_modelscope_ocr,
)
from marconet_tpu.convert.yolo_import import convert_yolo11
from marconet_tpu.models import convnext_ocr as jocr
from marconet_tpu.models import frontend as jfrontend
from marconet_tpu.models import yolo as jyolo
from marconet_tpu_torch import convert
from marconet_tpu_torch.models import convnext_ocr, frontend, yolo
from marconet_tpu_torch.utils import image
from tests.ocr_spec import modelscope_ocr_state_spec
from tests.yolo_oracle import fabricate_yolo_sd

torch.set_num_threads(1)


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.fixture(scope="module")
def yolo_sd():
    return fabricate_yolo_sd(np.random.default_rng(11))


@pytest.fixture(scope="module")
def yolos(yolo_sd):
    """(JAX variables, port YOLO11) at the same fabricated weights."""
    variables = jax.tree.map(jnp.asarray, convert_yolo11(yolo_sd))
    net = yolo.YOLO11(device="cpu", generator=_gen())
    net.load_state_dict({k: torch.from_numpy(v) for k, v in yolo_sd.items()},
                        strict=True)
    return variables, net


@pytest.fixture(scope="module")
def ocrs():
    """(spec state dict, JAX variables and config, port ConvNextViT)."""
    sd = modelscope_ocr_state_spec(np.random.default_rng(7))
    variables, jcfg = convert_modelscope_ocr(sd)
    psd, cfg = convert.ocr_state_from_modelscope(sd)
    net = convnext_ocr.ConvNextViT(cfg, device="cpu", generator=_gen())
    net.load_state_dict(psd, strict=True)
    return sd, jax.tree.map(jnp.asarray, variables), jcfg, net


# ---------------------------------------------------------------------------
# YOLO11
# ---------------------------------------------------------------------------


def test_yolo_matches_jax(yolos):
    """Whole forward at the input of ``tests/test_frontend.py::
    TestYOLOFullGraphOracle``, with its tolerances: scores rtol 2e-4, atol
    2e-4; boxes (pixels) rtol 2e-4, atol 2e-2."""
    variables, net = yolos
    x = np.random.default_rng(11).uniform(0, 1, (1, 64, 256, 3)) \
        .astype(np.float32)
    want_b, want_s = jax.jit(jyolo.YOLO11(nc=1).apply)(variables,
                                                       jnp.asarray(x))
    with torch.no_grad():
        got_b, got_s = net(torch.from_numpy(x))
    assert got_b.shape == (1, 32 * 8 + 16 * 4 + 8 * 2, 4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               rtol=2e-4, atol=2e-2)


def test_decode_dfl_matches_jax():
    """Three levels of random raw logits (the port takes them NCHW, JAX
    NHWC); rtol / atol 1e-5 as ``test_dfl_decode_matches_torch``."""
    rng = np.random.default_rng(2)
    shapes = ((4, 6), (2, 3), (1, 2))
    braw = [rng.standard_normal((2, h, w, 4 * yolo.REG_MAX))
            .astype(np.float32) for h, w in shapes]
    craw = [rng.standard_normal((2, h, w, 1)).astype(np.float32)
            for h, w in shapes]
    want = jyolo.decode_dfl([jnp.asarray(b) for b in braw],
                            [jnp.asarray(c) for c in craw], (8, 16, 32), 1)
    got = yolo.decode_dfl(
        [torch.from_numpy(b).permute(0, 3, 1, 2) for b in braw],
        [torch.from_numpy(c).permute(0, 3, 1, 2) for c in craw],
        (8, 16, 32), 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_nms_matches_jax(seed):
    """Random boxes, a quarter below the confidence threshold, heavy
    overlaps: the kept rows (boxes, scores, count) equal the JAX ones.
    Only valid rows are compared: the -1 ties among masked scores may put
    other invalid boxes into the top-k slots."""
    rng = np.random.default_rng(seed)
    n = 300
    cx, cy = rng.uniform(0, 640, n), rng.uniform(0, 96, n)
    w, h = rng.uniform(5, 60, n), rng.uniform(5, 60, n)
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     -1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[rng.random(n) < 0.25] *= 0.05
    jb, js, jv = map(np.asarray, jyolo.nms_static(jnp.asarray(boxes),
                                                  jnp.asarray(scores)))
    pb, ps, pv = (t.numpy() for t in yolo.nms_static(
        torch.from_numpy(boxes), torch.from_numpy(scores)))
    assert pv.sum() == jv.sum() > 0
    np.testing.assert_array_equal(pb[pv > 0], jb[jv > 0])
    np.testing.assert_array_equal(ps[pv > 0], js[jv > 0])
    assert (ps[pv == 0] == 0).all()


def test_nms_suppresses_and_thresholds():
    """The JAX package's hand case (``test_nms_static``)."""
    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [50, 0, 60, 10],
                          [100, 0, 110, 10]], dtype=torch.float32)
    scores = torch.tensor([0.9, 0.8, 0.5, 0.05])
    b, s, valid = yolo.nms_static(boxes, scores, max_det=4, iou_thresh=0.3,
                                  conf_thresh=0.07)
    assert valid.sum() == 2
    assert {tuple(k) for k in b[valid > 0][:, :2].int().tolist()} == \
        {(0, 0), (50, 0)}


def test_yolo_from_jax_inverts_convert(yolo_sd):
    back = convert.yolo_from_jax(convert_yolo11(yolo_sd))
    assert set(back) == set(yolo_sd)
    for k, v in yolo_sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_load_yolo_checkpoint(yolo_sd, tmp_path):
    """An ultralytics-style export (``num_batches_tracked`` counters, the
    DFL projection, a ``state_dict`` container) loads strictly; a wrong
    DFL projection or an extra layer is refused."""
    sd = {k: torch.from_numpy(v) for k, v in yolo_sd.items()}
    extra = {k.replace("running_mean", "num_batches_tracked"):
             torch.tensor(7) for k in sd if k.endswith("running_mean")}
    dfl = {"model.23.dfl.conv.weight": torch.arange(16.0).view(1, 16, 1, 1)}
    path = tmp_path / "yolo11m_character_sd.pth"
    torch.save({"state_dict": {**sd, **extra, **dfl}}, path)
    net = yolo.YOLO11(device="meta", generator=_gen())
    net.load_state_dict(convert.load_yolo_checkpoint(str(path)), strict=True,
                        assign=True)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)

    torch.save({**sd, "model.23.dfl.conv.weight": torch.ones(1, 16, 1, 1)},
               path)
    with pytest.raises(convert.ConversionError, match="dfl"):
        convert.load_yolo_checkpoint(str(path))
    torch.save({**sd, "model.24.conv.weight": torch.zeros(1)}, path)
    with pytest.raises(RuntimeError, match="model.24"):
        yolo.YOLO11(device="meta", generator=_gen()).load_state_dict(
            convert.load_yolo_checkpoint(str(path)), strict=True,
            assign=True)


# ---------------------------------------------------------------------------
# ConvNextViT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [64, 200, 32])
def test_ocr_matches_jax(ocrs, width):
    """Logits at the checkpoint's canonical width (64: the positional
    embedding as it is), a wider non-canonical one (interpolated) and a
    narrower one (antialiased shrink); rtol / atol 2e-4 as
    ``TestModelScopeOCRConverter::test_matches_torch_oracle``."""
    _, variables, jcfg, net = ocrs
    x = np.random.default_rng(width).uniform(-1, 1, (2, 32, width, 3)) \
        .astype(np.float32)
    want = jocr.ConvNextViT(config=jcfg).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (2, width // 4, jcfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_ocr_config_matches_jax(ocrs):
    sd, _, jcfg, net = ocrs
    cfg = net.config
    for field in jcfg.__dataclass_fields__:
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.canonical_width == jcfg.canonical_width == 64
    _, jcfg4 = convert_modelscope_ocr(sd, num_heads=4)
    _, cfg4 = convert.ocr_state_from_modelscope(sd, num_heads=4)
    assert cfg4.vit_heads == jcfg4.vit_heads == 4


def test_convnext_ocr_factory_matches_jax():
    """The weight-free recognizer over the alphabet: the JAX factory's
    config (blank last), with the positional length the port needs."""
    got = convnext_ocr.ConvNeXtOCR(seq_len=17, device="meta",
                                   generator=_gen()).config
    want = jocr.ConvNeXtOCR().config
    for field in want.__dataclass_fields__:
        if field != "seq_len":
            assert getattr(got, field) == getattr(want, field), field
    assert got.blank_index == got.num_classes - 1 == 6735


def test_ocr_loader_is_strict(ocrs):
    """An extra key or a missing one raises in both packages."""
    sd = ocrs[0]
    extra = {**sd, "recognizer.surprise.weight": np.zeros(3, np.float32)}
    missing = {k: v for k, v in sd.items()
               if k != "recognizer.blocks.0.attn.proj.bias"}
    for bad, what in ((extra, "unmapped"), (missing, "missing")):
        with pytest.raises(JaxConversionError, match=what):
            convert_modelscope_ocr(bad)
        with pytest.raises(convert.ConversionError, match=what):
            convert.ocr_state_from_modelscope(bad)


def test_ocr_from_jax_and_load_ocr_checkpoint(ocrs, tmp_path):
    """``ocr_from_jax`` gives the loader's state dict back; a saved export
    with a manifest loads with its head count."""
    sd, variables, _, net = ocrs
    back = convert.ocr_from_jax(jax.tree.map(np.asarray, variables))
    want = net.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    path = tmp_path / "ocr_convnext_sd.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    (tmp_path / "ocr_key_manifest.json").write_text(
        json.dumps({"__meta__": {"num_heads": 2}}))
    loaded, cfg = convert.load_ocr_checkpoint(str(path))
    assert cfg.vit_heads == 2 and set(loaded) == set(want)


def test_ctc_decode_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 12, 9)).astype(np.float32)
    logits[:, 3:5, 4] += 9.0                        # a repeat
    for kw in ({"charset": "abcdefgh", "blank": 0, "offset": 1},
               {"charset": "abcdefghi", "blank": 8},
               {"charset": "abcdefgh", "offset": 1}):
        assert convnext_ocr.decode_ctc(logits, **kw) == \
            jocr.decode_ctc(logits, **kw)
    assert convnext_ocr.decode_ctc(logits) == jocr.decode_ctc(logits)


# ---------------------------------------------------------------------------
# host helpers: byte-exact against cv2 (IPP off)
# ---------------------------------------------------------------------------


def test_resize_linear_u8_matches_cv2(no_ipp):
    """60 random shrinks and enlargements, 1, 3 and 4 channels."""
    rng = np.random.default_rng(0)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(1, 150, 2))
        oh, ow = (int(v) for v in rng.integers(1, 700, 2))
        c = int(rng.choice([1, 3, 4]))
        img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        got = image.resize_linear_u8(img, ow, oh)
        np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("ksize", [9, 15, 21])
def test_gaussian_blur_u8_matches_cv2(no_ipp, ksize):
    """Random and two-level images from 1 x 1 up, sigma 0."""
    rng = np.random.default_rng(ksize)
    for i in range(30):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        if i % 2:
            img = np.where(img > 127, 255, 0).astype(np.uint8)
        np.testing.assert_array_equal(
            image.gaussian_blur_u8(img, ksize),
            cv2.GaussianBlur(img, (ksize, ksize), 0))


@pytest.mark.parametrize("auto", [True, False])
def test_letterbox_matches_jax(no_ipp, auto):
    rng = np.random.default_rng(0)
    for h, w in ((100, 400), (64, 2000), (33, 517), (640, 640), (31, 1999),
                 (200, 100), (48, 300)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got, gr, gpad = frontend.letterbox(img, 640, auto=auto)
        want, wr, wpad = jfrontend.letterbox(img, 640, auto=auto)
        assert (gr, gpad) == (wr, wpad)
        np.testing.assert_array_equal(got, want)


def _boxes(rng, n: int, width: int, height: int):
    x = np.sort(rng.integers(0, width - 10, n))
    return [[int(a), int(rng.integers(0, 4)),
             int(min(a + rng.integers(6, 40), width)), height]
            for a in x]


def test_mask_segment_matches_jax(no_ipp):
    """Every box of lines with 1-9 boxes (windows at both edges, the 5-box
    window in the middle, all-text segments): byte-exact segments and the
    same window starts."""
    rng = np.random.default_rng(1)
    for n in (1, 3, 5, 6, 9):
        img = rng.integers(0, 256, (40, 320, 3), dtype=np.uint8)
        boxes = _boxes(rng, n, 320, 40)
        for j in range(n):
            got, gs = frontend.mask_segment(img, boxes, j)
            want, ws = jfrontend.mask_segment(img, boxes, j)
            assert gs == ws
            np.testing.assert_array_equal(got, want)
    full = [[0, 0, 320, 40]]                      # no background pixel
    np.testing.assert_array_equal(frontend.mask_segment(img, full, 0)[0],
                                  jfrontend.mask_segment(img, full, 0)[0])


@pytest.mark.parametrize("canonical", [None, 64, 128])
def test_prepare_segment_matches_jax(no_ipp, canonical):
    rng = np.random.default_rng(2)
    for w in (5, 40, 64, 300, 801):
        seg = rng.integers(0, 256, (48, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            frontend.prepare_segment(seg, canonical),
            jfrontend.prepare_segment(seg, canonical))


# ---------------------------------------------------------------------------
# the whole front-end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frontends(yolos, ocrs):
    variables, ynet = yolos
    _, ovars, jcfg, onet = ocrs
    return (jfrontend.CharacterFrontend(variables, ovars, ocr_config=jcfg),
            frontend.CharacterFrontend(ynet, onet, device="cpu"))


def _line(seed: int, h: int, w: int):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("seed,h,w", [(3, 48, 300), (5, 40, 900)])
def test_frontend_matches_jax(no_ipp, frontends, seed, h, w):
    """Boxes within 1 pixel (the JAX package's f32 box coordinates differ
    by float rounding and are truncated to int; measured: equal), chars
    and text equal, locs within 1 px / 512 of the height-32 geometry."""
    jfe, pfe = frontends
    img = _line(seed, h, w)
    want, got = jfe(img), pfe(img)
    assert len(got.boxes) == len(want.boxes) > 0
    assert np.abs(got.boxes - want.boxes).max() <= 1
    assert got.chars == want.chars and got.text == want.text
    assert got.x_centers == want.x_centers
    np.testing.assert_allclose(got.locs, want.locs, rtol=0,
                               atol=32 / h / 512)


def test_batched_recognizer_matches_per_segment(frontends):
    """Batched ``recognize_segments`` (power-of-two padding) equals the
    per-segment path and the JAX package's."""
    jfe, pfe = frontends
    rng = np.random.default_rng(3)
    segs = [rng.integers(0, 256, (48, w, 3), dtype=np.uint8)
            for w in (40, 90, 130, 60, 75)]
    batched = pfe.recognize_segments(segs)
    assert batched == [pfe.recognize_segment(s) for s in segs]
    assert batched == jfe.recognize_segments(segs)
    assert pfe.recognize_segments([]) == []
    bare = frontend.CharacterFrontend(None, device="cpu")
    assert bare.recognize_segments(segs[:2]) == ["", ""]


def test_from_checkpoints(frontends, yolo_sd, ocrs, tmp_path):
    """The file names the JAX package searches; strict loads; a vocabulary
    sets the class offset; without a YOLO file it raises, without OCR
    files recognition is off."""
    _, pfe = frontends
    torch.save({k: torch.from_numpy(v) for k, v in yolo_sd.items()},
               tmp_path / "yolo11m_character_sd.pth")
    bare = frontend.CharacterFrontend.from_checkpoints(str(tmp_path),
                                                       device="cpu")
    assert bare.ocr is None
    torch.save({k: torch.from_numpy(v) for k, v in ocrs[0].items()},
               tmp_path / "ocr_convnext_sd.pth")
    fe = frontend.CharacterFrontend.from_checkpoints(str(tmp_path),
                                                     device="cpu")
    img = _line(3, 48, 300)
    got, want = fe(img), pfe(img)
    np.testing.assert_array_equal(got.boxes, want.boxes)
    assert got.text == want.text
    (tmp_path / "ocr_vocab.txt").write_text("".join(
        f"{c}\n" for c in "abcdefghijklmnopqrstuvwxyz0123456789"[:30]))
    fe = frontend.CharacterFrontend.from_checkpoints(str(tmp_path),
                                                     device="cpu")
    assert fe.ocr_offset == 37 - 30 and len(fe.ocr_charset) == 30
    with pytest.raises(FileNotFoundError):
        frontend.CharacterFrontend.from_checkpoints(str(tmp_path / "none"),
                                                    device="cpu")
