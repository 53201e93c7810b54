"""The port's page server (``marconet_tpu_torch.serve``), its alphabet
helpers and ``MARCONet.encode`` / ``interpolate_styles`` against the JAX
package's.

Both sides hold the same weights: one JAX init at ``width=0.0625``,
exported with ``marconet_tpu_torch.convert.*_from_jax`` into the port
(strict ``load_state_dict``). Inputs are made with numpy from a seed;
everything runs on the CPU in f32, where the port's kernel wrappers take
their plain versions. cv2's IPP layer is switched off while the JAX side
preprocesses, so both sides feed the nets the same bytes (see
``tests/test_torch_image.py``).
"""

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from marconet_tpu import alphabet as jalphabet
from marconet_tpu import serve as jserve
from marconet_tpu.models.pipeline import MARCONet as JaxMARCONet
from marconet_tpu_torch import alphabet, serve
from marconet_tpu_torch.convert import (
    encoder_from_jax,
    prior_from_jax,
    srnet_from_jax,
)
from marconet_tpu_torch.models.pipeline import MARCONet
from marconet_tpu_torch.ops import resize
from marconet_tpu_torch.utils import image as timage

torch.set_num_threads(1)

WIDTH = 0.0625
# f32 restore, port vs JAX: sr within atol 5e-3 on [-1, 1]
# (tests/test_torch_pipeline.py), i.e. 0.64 of a uint8 level, so packed
# pixels may differ by one level; measured on the page below: 1.2e-4 of
# the sr pixels and 3.7e-4 of the prior pixels at most, one level each
SR_MAX_LEVELS, SR_SHARE = 1, 2e-3


@pytest.fixture(scope="module")
def nets():
    jnet = JaxMARCONet(width=WIDTH)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(11))
    as_np = jax.tree.map(np.asarray, params)
    net = MARCONet(width=WIDTH, device="cpu")
    net.encoder.load_state_dict(encoder_from_jax(as_np.encoder), strict=True)
    net.prior.load_state_dict(prior_from_jax(as_np.prior), strict=True)
    net.srnet.load_state_dict(srnet_from_jax(as_np.srnet), strict=True)
    return jnet, params, net


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


def _page(seed: int = 0):
    """Two lines on a noise page, the second over-wide (3 segments), with
    known texts and character boxes."""
    rng = np.random.default_rng(seed)
    page = rng.integers(0, 255, (300, 3000, 3)).astype(np.uint8)
    boxes = [(0, 0, 900, 64), (0, 100, 3000, 164)]
    wide = [(60 + 480 * i, 8, 420 + 480 * i, 56) for i in range(6)]
    return page, boxes, ["AB", "CDEFGH"], [None, wide]


def _levels(a: np.ndarray, b: np.ndarray):
    d = np.abs(a.astype(int) - b.astype(int))
    return int(d.max()), float((d > 0).mean())


def test_restore_page_matches_jax(nets, no_ipp):
    """One page, both servers, bucket 4 (one chunk of the 4 segments):
    texts, shapes and uint8 pixels of each stitched line; sr within
    ``SR_MAX_LEVELS`` on at most ``SR_SHARE`` of the pixels, priors too."""
    jnet, params, net = nets
    page, boxes, texts, char_boxes = _page()
    want = jserve.TextPageRestorer(jnet, params, buckets=(4,)).restore_page(
        page, boxes, texts=texts, char_boxes=char_boxes)
    got = serve.TextPageRestorer(net, buckets=(4,)).restore_page(
        page, boxes, texts=texts, char_boxes=char_boxes)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.text == w.text
        assert g.sr.shape == w.sr.shape and g.sr.dtype == np.uint8
        assert g.priors.shape == w.priors.shape
        for a, b in ((g.sr, w.sr), (g.priors, w.priors)):
            levels, share = _levels(a, b)
            assert levels <= SR_MAX_LEVELS and share <= SR_SHARE, \
                (levels, share)
    # 3 segments x 1000 px at h=64: each shows 4 * 500 px of x4 output
    assert got[1].sr.shape == (128, 3 * 2000, 3)
    assert got[1].text == "CDEFGH" and got[1].priors.shape[0] == 6


def test_chunking_invariance(nets):
    """Five requests in chunks of 2 (three double-buffered chunks, the last
    of one row) and in one chunk of 8 give the same results in the same order
    (batch rows are independent; the CPU's f32 sums may differ in order
    by batch size, so a pixel may move by one level on < 1e-3 of them,
    as ``tests/test_serve.py`` allows)."""
    _, _, net = nets
    rng = np.random.default_rng(2)
    reqs = [serve.LineRequest(
        image=rng.integers(0, 255, (64, 800, 3)).astype(np.uint8),
        text="ABC") for _ in range(5)]
    chunked = serve.TextPageRestorer(net, buckets=(2,)).restore_lines(reqs)
    whole = serve.TextPageRestorer(net, buckets=(8,)).restore_lines(reqs)
    assert len(chunked) == len(whole) == 5
    for c, w in zip(chunked, whole):
        assert c.text == w.text and c.sr.shape == w.sr.shape
        for a, b in ((c.sr, w.sr), (c.priors, w.priors)):
            levels, share = _levels(a, b)
            assert levels <= 1 and share < 1e-3


def test_prep_resizes_once_to_lq_height(nets, monkeypatch):
    """The page server resizes each request once, to height 32, and makes
    no 128-high display copy: a line's ``sr`` is cropped to
    ``show_width`` of its shape."""
    _, _, net = nets
    cubic = timage.resize_cubic_u8
    heights = []

    def spy(img, factor=None, size=None):
        out = cubic(img, factor, size)
        heights.append(out.shape[0])
        return out

    monkeypatch.setattr(timage, "resize_cubic_u8", spy)
    rng = np.random.default_rng(6)
    shapes = [(32, 100), (48, 301), (32, 129), (48, 150)]
    reqs = [serve.LineRequest(
        image=rng.integers(0, 255, (h, w, 3)).astype(np.uint8), text="AB")
        for h, w in shapes]
    out = serve.TextPageRestorer(net, buckets=(2,)).restore_lines(reqs)
    assert heights == [timage.LQ_HEIGHT] * len(reqs)
    assert [r.sr.shape for r in out] == [
        (128, timage.show_width(h, w), 3) for h, w in shapes]


class _SpyNet:
    """The net as the page server sees it, recording the rows of each
    ``restore`` call."""

    def __init__(self, net):
        self.net, self.device, self.rows = net, net.device, []

    def restore(self, lq, labels, locs, char_mask):
        rows = {int(t.shape[0]) for t in (lq, labels, locs, char_mask)}
        assert len(rows) == 1, rows
        self.rows += rows
        return self.net.restore(lq, labels, locs, char_mask)


@pytest.mark.parametrize("n, buckets, want_rows, whole_buckets", [
    (17, serve.DEFAULT_BUCKETS, [17], (32,)),
    (5, (4,), [4, 1], (8,)),
])
def test_chunks_restore_at_their_rows(nets, n, buckets, want_rows,
                                      whole_buckets):
    """A chunk restores at the rows it holds, not padded to its bucket:
    17 requests under the default buckets are one call of 17 rows, 5 at
    ``buckets=(4,)`` calls of 4 and 1. The results equal one chunk's
    within ``test_chunking_invariance``'s tolerance, in the same order."""
    _, _, net = nets
    rng = np.random.default_rng(5)
    reqs = [serve.LineRequest(
        image=rng.integers(0, 255, (32, 32 * k, 3)).astype(np.uint8),
        text="ABCDEFGH"[:k]) for k in rng.integers(1, 9, n)]
    spy, whole_spy = _SpyNet(net), _SpyNet(net)
    restorer = serve.TextPageRestorer(spy, buckets=buckets)
    got = restorer.restore_lines(reqs)
    whole = serve.TextPageRestorer(whole_spy, buckets=whole_buckets
                                   ).restore_lines(reqs)
    assert spy.rows == want_rows and whole_spy.rows == [n]
    assert restorer.rows == restorer.rows_real == n
    assert len(got) == len(whole) == n
    for g, w, r in zip(got, whole, reqs):
        assert g.text == w.text == r.text and g.sr.shape == w.sr.shape
        assert g.priors.shape == w.priors.shape == (len(r.text), 128, 128, 3)
        for a, b in ((g.sr, w.sr), (g.priors, w.priors)):
            levels, share = _levels(a, b)
            assert levels <= 1 and share < 1e-3


def test_page_requests_match_jax():
    """Segments, texts, boxes and groups of a split page equal the JAX
    package's, and a split without character boxes refuses alike."""
    rng = np.random.default_rng(1)
    page = rng.integers(0, 255, (100, 3000, 3)).astype(np.uint8)
    boxes = [(0, 0, 3000, 64), (10, 0, 700, 90)]
    cb = [[(50, 0, 150, 60), (850, 0, 950, 60), (1050, 0, 1150, 60),
           (1850, 0, 1950, 60), (2050, 0, 2150, 60), (2920, 0, 2980, 60)],
          None]
    texts = ["ABCDEF", "xy"]
    got, got_groups = serve.TextPageRestorer(None)._page_requests(
        page, boxes, texts=texts, char_boxes=cb)
    want, want_groups = jserve.TextPageRestorer(None, None)._page_requests(
        page, boxes, texts=texts, char_boxes=cb)
    assert got_groups == want_groups == [[0, 1, 2], [3]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.image, w.image)
        assert g.text == w.text
        assert (g.boxes is None) == (w.boxes is None)
        if g.boxes is not None:
            np.testing.assert_array_equal(np.asarray(g.boxes, float),
                                          np.asarray(w.boxes, float))
    assert [r.text for r in got] == ["AB", "CD", "EF", "xy"]
    # segments without text go to a front-end, per segment
    fe = serve.TextPageRestorer(None, frontend=object())
    reqs, _ = fe._page_requests(page, boxes[:1], texts=None, char_boxes=None)
    assert len(reqs) == 3 and all(r.text is None for r in reqs)
    for restorer in (serve.TextPageRestorer(None),
                     jserve.TextPageRestorer(None, None)):
        with pytest.raises(ValueError, match="char_boxes"):
            restorer._page_requests(page, boxes, texts=texts,
                                    char_boxes=None)


@pytest.mark.parametrize("shape", [(64, 3000), (64, 900), (40, 641),
                                   (17, 1000)])
def test_split_wide_line_matches_jax(shape):
    img = np.zeros(shape + (3,), np.uint8)
    got = serve.split_wide_line(img)
    want = jserve.split_wide_line(img)
    assert [(s.shape, o) for s, o in got] == [(s.shape, o) for s, o in want]


def test_pack_uint8_is_exact():
    """The port's on-device packing equals the JAX package's and the host
    formula, for f32 and bf16 inputs."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.3, 1.3, (2, 8, 8, 3)).astype(np.float32)
    x[0, 0, 0] = [-1.0, 1.0, 0.0]
    host = np.floor(np.clip(x * 0.5 + 0.5, 0.0, 1.0) * 255.0
                    + 0.5).astype(np.uint8)
    got = serve._pack_uint8(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jserve._pack_uint8(jnp.asarray(x))))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        serve._pack_uint8(xb).numpy(),
        np.asarray(jserve._pack_uint8(jnp.asarray(x, jnp.bfloat16))))


class _CountingNet:
    """A stand-in pipeline that counts its restores."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = 0

    def restore(self, *args):
        self.calls += 1
        raise AssertionError("restore must not run")


def test_requests_checked_before_dispatch():
    """A too-wide third request, or one without text and front-end, is
    refused before the first chunk runs (the JAX server raises only when
    it reaches the request); the messages are the JAX package's."""
    rng = np.random.default_rng(3)
    ok = [serve.LineRequest(image=rng.integers(0, 255, (64, 800, 3))
                            .astype(np.uint8), text="AB")
          for _ in range(2)]
    wide = serve.LineRequest(image=np.zeros((32, 600, 3), np.uint8),
                             text="AB")
    no_text = serve.LineRequest(image=np.zeros((32, 100, 3), np.uint8))
    for bad, msg in ((wide, "wider than 512"),
                     (no_text, "no text and no front-end")):
        net = _CountingNet()
        with pytest.raises(ValueError, match=msg):
            serve.TextPageRestorer(net, buckets=(1,)).restore_lines(
                ok + [bad])
        assert net.calls == 0


def test_frontend_requests(nets):
    """Requests without text go through a duck-typed front-end; the text
    comes back from its labels."""
    _, _, net = nets

    class Det:
        text, locs = "AB", np.array([0.1, 0.02, 0.3, 0.02], np.float32)

    seen = []

    def frontend(image):
        seen.append(image.shape)
        return Det()

    rng = np.random.default_rng(4)
    reqs = [serve.LineRequest(image=rng.integers(0, 255, (40, 300, 3))
                              .astype(np.uint8)) for _ in range(3)]
    out = serve.TextPageRestorer(net, frontend=frontend,
                                 buckets=(4,)).restore_lines(reqs)
    assert len(seen) == 3
    assert [r.text for r in out] == ["AB"] * 3
    assert all(r.priors.shape == (2, 128, 128, 3) for r in out)


def test_alphabet_helpers_match_jax():
    rng = np.random.default_rng(8)
    chars = alphabet.alphabet()
    text = "".join(chars[i] for i in rng.integers(0, len(chars), 40))
    text += "☃ Z\x00"                       # out of the alphabet too
    assert alphabet.labels_from_text(text) == \
        jalphabet.labels_from_text(text)
    for t in range(4):
        preds = rng.integers(0, 6736, 24)
        preds[3:6] = preds[2]                    # repeats
        preds[10:12] = alphabet.BLANK_INDEX      # blanks
        logits = rng.normal(size=(24, 6736)).astype(np.float32)
        logits[np.arange(24), preds] += 100.0
        assert alphabet.collapse_ctc_labels(logits) == \
            jalphabet.collapse_ctc_labels(logits)


def test_encode_matches_jax(nets):
    """Tolerances of ``test_torch_models.test_encoder_matches_jax``."""
    jnet, params, net = nets
    lq = np.random.default_rng(9).uniform(-1, 1, (2, 32, 512, 3)) \
        .astype(np.float32)
    want = jax.jit(jnet.encode)(params, jnp.asarray(lq))
    got = net.encode(torch.from_numpy(lq))
    for g, w, (rtol, atol) in zip(got, want, ((2e-3, 2e-3), (2e-3, 2e-4),
                                               (2e-3, 2e-3))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


def test_interpolate_styles_matches_jax(nets):
    """(S, N, 128, 128, 3) glyph priors over blends of two styles, within
    the prior's image tolerance (rtol 1e-3, atol 2e-3,
    ``test_torch_models.test_prior_matches_jax``)."""
    jnet, params, net = nets
    rng = np.random.default_rng(10)
    w1, w2 = rng.normal(size=(2, net.encoder.w_dim)).astype(np.float32)
    labels = rng.integers(0, 6735, 3).astype(np.int32)
    weights = np.linspace(0, 1, 4).astype(np.float32)
    want = jnet.interpolate_styles(params, *map(jnp.asarray,
                                                (w1, w2, labels, weights)))
    got = net.interpolate_styles(*map(torch.from_numpy,
                                      (w1, w2, labels, weights)))
    assert got.shape == (4, 3, 128, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=2e-3)


@pytest.mark.parametrize("shape", [(5, 2, 3, 4), (1, 3, 4, 4)])
def test_upsample_split_matches_whole(monkeypatch, shape):
    """Batches whose upsampled output would pass PyTorch's INT_MAX limit
    run in pieces; pieces join to the whole, in the input's layout."""
    x = torch.from_numpy(np.random.default_rng(12).normal(size=shape)
                         .astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    whole = resize.upsample2x_bilinear(x)
    monkeypatch.setattr(resize, "MAX_OUTPUT_ELEMENTS", 2 * 4 * x[0].numel())
    split = resize.upsample2x_bilinear(x)
    assert split.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(split, whole, rtol=0, atol=0)
