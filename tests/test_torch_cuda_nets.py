"""The port's nets and entry points on the card, against the CPU.

Marked ``cuda``: these need an NVIDIA Hopper GPU and skip elsewhere (the
decision is taken in a fixture, never at import). The machine with the
card has no JAX, cv2 or PIL, so this file imports only torch, numpy and
the port; run it there beside the kernel tests, without the suite's
JAX-configuring conftest:

    python -m pytest tests/test_torch_cuda.py tests/test_torch_cuda_nets.py --noconftest -q

Every test runs at the published widths, in f32 with TF32 off unless it
names bf16 (bf16 compute over f32 parameters, as serving runs). On the
card the nets run the hand-written kernels; on the CPU the same weights
run their plain twins, so a card-vs-CPU comparison holds the kernels in
place. The limits:

- ``restore`` (B=1, 4 slots, 3 valid): rtol 2e-3, atol 5e-3 (``sr``,
  ``priors``) and 2e-3 (``w``), those of
  ``tests/test_convert.py::test_full_pipeline_chain_matches_torch``;
- the page server: each chunk's results equal ``_pack_uint8`` of
  ``restore`` on it; chunking moves an f32 page by at most
  ``PAGE_INVARIANCE_MAX`` levels on ``PAGE_INVARIANCE_SHARE`` of pixels;
- ``train_step`` (B=1, 4 slots): losses within ``PARITY_LOSS_TOL``, each
  net's gradient within ``PARITY_GRAD_TOL`` (relative L2), the encoder's
  with cuDNN off within ``PARITY_NATIVE_ENCODER_TOL``;
- two data-parallel ranks against one process: losses within
  ``PARITY_LOSS_TOL``'s rtol, gradients within ``PARITY_GRAD_TOL_DP``;
- a bf16 step against an f32 one at the reduced size: losses within
  ``BF16_LOSS_TOL``, each net's gradient within ``BF16_GRAD_RTOL``.

``RESTORE_LAUNCHES`` and ``TRAIN_LAUNCHES`` are the kernel launches of one
restore and one training step: every test that runs a whole restore or
step holds the port's launch counters to them exactly.
"""

import copy
import gc
import hashlib
import math
import multiprocessing as mp
import os
import queue
import socket
import traceback
import warnings

import numpy as np
import pytest
import torch

from marconet_tpu_torch.alphabet import BLANK_INDEX, alphabet
from marconet_tpu_torch.cli import test_sr as cli_test_sr
from marconet_tpu_torch.dryrun import seeded_batch
from marconet_tpu_torch.data.batch_prep import prepare_train_batch
from marconet_tpu_torch.models.convnext_ocr import ConvNextViT, OCRConfig
from marconet_tpu_torch.models.frontend import (
    CharacterFrontend,
    letterbox,
    mask_segment,
    prepare_segment,
)
from marconet_tpu_torch.models import pipeline
from marconet_tpu_torch.models.pipeline import GRAPH_MAX_ROWS, MARCONet
from marconet_tpu_torch.models.yolo import YOLO11, BatchNorm, nms_static
from marconet_tpu_torch.ops.conv3x3 import conv3x3_same
from marconet_tpu_torch.ops.fused_act import (
    fused_leaky_relu,
    fused_leaky_relu_bwd,
)
from marconet_tpu_torch.ops.sft_writeback import (
    sft_writeback,
    sft_writeback_bwd,
)
from marconet_tpu_torch.parallel import distributed
from marconet_tpu_torch.serve import TextPageRestorer, _pack_uint8
from marconet_tpu_torch.train.config import load_config
from marconet_tpu_torch.train.loop import train
from marconet_tpu_torch.train.train_step import (
    NETS,
    MARCONetTrainer,
    TrainBatch,
    TrainConfig,
)
from marconet_tpu_torch.utils.png import read_png, write_png

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FONT_DIR = os.path.join(ROOT, "tests", "data", "fonts")

WRAPPERS = {"fused_leaky_relu": fused_leaky_relu,
            "fused_leaky_relu_bwd": fused_leaky_relu_bwd,
            "sft_writeback": sft_writeback,
            "sft_writeback_bwd": sft_writeback_bwd,
            "conv3x3_same": conv3x3_same}
# one training step: 19 StyledConv / style-MLP activations in the prior
# (forward and backward), two SFT scales in the SR net; no model calls K3
TRAIN_LAUNCHES = {"fused_leaky_relu": 19, "fused_leaky_relu_bwd": 19,
                  "sft_writeback": 2, "sft_writeback_bwd": 2,
                  "conv3x3_same": 0}
# one restore (serving): no backward kernel, no K3
RESTORE_LAUNCHES = {"fused_leaky_relu": 19, "fused_leaky_relu_bwd": 0,
                    "sft_writeback": 2, "sft_writeback_bwd": 0,
                    "conv3x3_same": 0}
# the kernels of the training path by the names of their templates
KERNEL_NAMES = {"fused_leaky_relu": "fused_lrelu_fwd_kernel",
                "fused_leaky_relu_bwd": "fused_lrelu_bwd_kernel",
                "sft_writeback": "sft_writeback_kernel",
                "sft_writeback_bwd": "sft_writeback_bwd_kernel"}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    gc.collect()
    torch.cuda.empty_cache()


def _counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def _launched(fn):
    """(``fn()``, the kernel launches it made)."""
    before = _counts()
    out = fn()
    return out, {k: v - before[k] for k, v in _counts().items()}


def _times(launches: dict, n: int) -> dict:
    return {k: v * n for k, v in launches.items()}


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm())


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _lines(gen: np.random.Generator, batch: int, slots: int,
           n_valid: int, centers):
    """Restore inputs: seeded LQ lines with ``n_valid`` characters at
    ``centers``."""
    lq = torch.from_numpy(gen.uniform(-1, 1, (batch, 32, 512, 3))
                          .astype(np.float32))
    labels = np.full((batch, slots), BLANK_INDEX, np.int64)
    labels[:, :n_valid] = gen.integers(0, BLANK_INDEX, (batch, n_valid))
    locs = np.zeros((batch, 2 * slots), np.float32)
    locs[:, 0:2 * n_valid:2] = centers
    locs[:, 1:2 * n_valid:2] = 0.03
    mask = np.zeros((batch, slots), np.float32)
    mask[:, :n_valid] = 1.0
    return lq, torch.from_numpy(labels), torch.from_numpy(locs), \
        torch.from_numpy(mask)


def test_restore_matches_cpu(dev):
    """Full-width f32 ``restore``: the card (kernels) against the CPU
    (plain versions), same seeded weights."""
    cpu_net = MARCONet(dtype=torch.float32, device="cpu", seed=0)
    gpu_net = MARCONet(dtype=torch.float32, device=dev, seed=1)
    gpu_net.load_state_dict(cpu_net.state_dict())
    inputs = _lines(np.random.default_rng(1), 1, 4, 3, [0.1, 0.45, 0.8])
    want = cpu_net.restore(*inputs)
    got, launched = _launched(lambda: gpu_net.restore(*inputs))
    assert launched == RESTORE_LAUNCHES
    for name, atol in (("sr", 5e-3), ("priors", 5e-3), ("w", 2e-3)):
        torch.testing.assert_close(getattr(got, name).float().cpu(),
                                   getattr(want, name), rtol=2e-3,
                                   atol=atol)


# ---------------------------------------------------------------------------
# CUDA graphs of small restores (bf16 compute over f32 parameters)
# ---------------------------------------------------------------------------

OUTPUTS = ("sr", "priors", "logits", "pred_locs", "w")


def _bf16_line(seed: int, slots: int, rows: int = 1):
    n_valid = max(1, slots - 1)
    centers = (np.arange(n_valid) + 0.5) / n_valid
    return _lines(np.random.default_rng(seed), rows, slots, n_valid,
                  centers)


def _eager(net, inputs, monkeypatch):
    """``net.restore(*inputs)`` with graphs off."""
    with monkeypatch.context() as m:
        m.setattr(pipeline, "GRAPH_MAX_ROWS", 0)
        return net.restore(*inputs)


def _assert_equal(got, want):
    for name in OUTPUTS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("slots", [4, 8, 16])
def test_graphed_restore_equals_eager(dev, slots, monkeypatch):
    """One row at 4, 8 and 16 slots: the first call (eager on a side
    stream, then the capture) and two replays equal the eager restore bit
    for bit, and each makes exactly ``RESTORE_LAUNCHES``."""
    net = MARCONet(dtype=torch.bfloat16, device=dev, seed=0)
    inputs = _bf16_line(slots, slots)
    want = _eager(net, inputs, monkeypatch)
    first, launched = _launched(lambda: net.restore(*inputs))
    assert launched == RESTORE_LAUNCHES
    assert (net.graph_captures, net.graph_replays) == (1, 0)
    _assert_equal(first, want)
    for k in range(2):
        got, launched = _launched(lambda: net.restore(*inputs))
        assert launched == RESTORE_LAUNCHES
        _assert_equal(got, want)
    assert (net.graph_captures, net.graph_replays) == (1, 2)
    assert list(net._graphs) == [(1, slots)]


def test_graph_capture_with_event_hooks(dev, monkeypatch):
    """Forward hooks that record CUDA events around each net, as the
    benchmark's traced run registers them, do not stop the capture; the
    replay still equals the eager restore."""
    net = MARCONet(dtype=torch.bfloat16, device=dev, seed=0)
    log, handles = [], []
    for name in ("encoder", "prior", "srnet"):
        mod = getattr(net, name)

        def pre(mod, args):
            mod._start = torch.cuda.Event(enable_timing=True)
            mod._start.record()

        def post(mod, args, out, name=name):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            log.append((name, mod._start, end))

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    inputs = _bf16_line(3, 8)
    try:
        first = net.restore(*inputs)
        assert net.graph_captures == 1
        assert [n for n, _, _ in log[:3]] == ["encoder", "prior", "srnet"]
        got = net.restore(*inputs)
        assert net.graph_replays == 1
    finally:
        for h in handles:
            h.remove()
    want = _eager(net, inputs, monkeypatch)
    _assert_equal(first, want)
    _assert_equal(got, want)


def test_graphs_read_loaded_weights(dev, monkeypatch):
    """``load_state_dict`` after the capture copies into the parameters the
    graphs read: the next replay gives the new weights' eager output."""
    net = MARCONet(dtype=torch.bfloat16, device=dev, seed=0)
    other = MARCONet(dtype=torch.bfloat16, device=dev, seed=1)
    inputs = _bf16_line(4, 4)
    old = net.restore(*inputs)
    net.restore(*inputs)
    net.load_state_dict(other.state_dict())
    got = net.restore(*inputs)
    assert (net.graph_captures, net.graph_replays) == (1, 2)
    want = _eager(other, inputs, monkeypatch)
    _assert_equal(got, want)
    assert not torch.equal(got.sr, old.sr)


def test_replays_do_not_alias(dev):
    """Two consecutive replays return tensors of their own: the second
    neither shares storage with the first nor changes it."""
    net = MARCONet(dtype=torch.bfloat16, device=dev, seed=0)
    net.restore(*_bf16_line(5, 8))
    a = net.restore(*_bf16_line(6, 8))
    kept = {name: getattr(a, name).clone() for name in OUTPUTS}
    b = net.restore(*_bf16_line(7, 8))
    assert net.graph_replays == 2
    for name in OUTPUTS:
        ta, tb = getattr(a, name), getattr(b, name)
        assert ta.untyped_storage().data_ptr() != \
            tb.untyped_storage().data_ptr(), name
        assert torch.equal(ta, kept[name]), name
    assert not torch.equal(a.sr, b.sr)


def test_chunk_above_cap_stays_eager(dev):
    """``GRAPH_MAX_ROWS + 1`` rows run eagerly, call after call."""
    net = MARCONet(dtype=torch.bfloat16, device=dev, seed=0)
    inputs = _bf16_line(8, 4, rows=GRAPH_MAX_ROWS + 1)
    for _ in range(2):
        _, launched = _launched(lambda: net.restore(*inputs))
        assert launched == RESTORE_LAUNCHES
    assert (net.graph_captures, net.graph_replays) == (0, 0)
    assert not net._graphs


# ---------------------------------------------------------------------------
# the page server
# ---------------------------------------------------------------------------

PAGE_LINES = 48
# chunking invariance in f32 (TF32 off): cuDNN picks its algorithms by
# batch size, so sums are taken in other orders, which moves f32 outputs
# by ~4e-4 of [-1, 1] (0.05 of a level). In bf16 the same reordering moves
# the random-weight nets' outputs by tens of levels, so bf16 is not held.
# The share's limit is 4x the 5.06e-4 measured on an H100 (pixels whose
# f32 value lies within 4e-4 of a rounding boundary flip by one level).
PAGE_INVARIANCE_MAX = 1          # uint8 levels
PAGE_INVARIANCE_SHARE = 2e-3     # of pixels that may differ


def _page(gen: np.random.Generator) -> tuple:
    """A seeded page of ``PAGE_LINES`` line crops stacked down a noise
    page: heights 40-72 px; widths at height 32 of 64-500 px, and 530-1400
    px for a quarter of the lines (split into 2-3 segments); each line's
    text is 2-4 alphabet characters in its first third, 5-8 in the second
    and 9-16 in the last (so chunks of 16 segments use 4, 8 and 16 slots),
    with evenly spaced character boxes."""
    chars = alphabet()
    heights = gen.integers(40, 73, PAGE_LINES)
    wide = np.zeros(PAGE_LINES, bool)
    wide[gen.permutation(PAGE_LINES)[:PAGE_LINES // 4]] = True
    w32 = np.where(wide, gen.integers(530, 1401, PAGE_LINES),
                   gen.integers(64, 501, PAGE_LINES))
    widths = w32 * heights // 32
    third = np.arange(PAGE_LINES) * 3 // PAGE_LINES
    n_chars = np.choose(third, [gen.integers(2, 5, PAGE_LINES),
                                gen.integers(5, 9, PAGE_LINES),
                                gen.integers(9, 17, PAGE_LINES)])
    page = gen.integers(0, 256, (int(heights.sum()), int(widths.max()), 3),
                        dtype=np.uint8)
    boxes, texts, char_boxes = [], [], []
    y = 0
    for h, w, n in zip(heights.tolist(), widths.tolist(), n_chars.tolist()):
        boxes.append((0, y, w, y + h))
        texts.append("".join(chars[i] for i in
                             gen.integers(0, BLANK_INDEX, n)))
        edges = np.linspace(0.0, w, n + 1)
        char_boxes.append([(edges[i] + 1.0, 2.0, edges[i + 1] - 1.0,
                            h - 2.0) for i in range(n)])
        y += h
    return page, boxes, texts, char_boxes


def test_page_server_bf16(dev):
    """``TextPageRestorer`` over a bf16-compute net with f32 parameters
    (as ``cli/serve_demo.py`` and the serve configuration run it) on the
    seeded page: one result per line box with its stitched width, text
    and priors; ``restore_lines`` with ``buckets=(16,)`` in chunks of 4,
    8 and 16 slots, each chunk's results equal to ``_pack_uint8`` of
    ``restore`` on it; exact launches a chunk; no host synchronisation
    inside ``restore``."""
    net = MARCONet(dtype=torch.bfloat16, device=dev, seed=0)
    page, line_boxes, texts, char_boxes = _page(np.random.default_rng(6))
    server = TextPageRestorer(net)
    lines16 = TextPageRestorer(net, buckets=(16,))
    segments, groups = lines16._page_requests(page, line_boxes, texts,
                                              char_boxes)
    n_seg = len(segments)
    assert sum(len(g) > 1 for g in groups) > 0

    results, launched = _launched(lambda: server.restore_page(
        page, line_boxes, texts, char_boxes))
    assert server.chunks == -(-n_seg // server.max_rows)
    assert launched == _times(RESTORE_LAUNCHES, server.chunks)
    assert len(results) == len(line_boxes)
    for res, idxs, text in zip(results, groups, texts):
        # each segment shows round(width * 128 / height) columns, <= 2048
        want_w = sum(min(int(round(segments[j].image.shape[1] * 128
                                   / segments[j].image.shape[0])), 2048)
                     for j in idxs)
        assert res.sr.shape == (128, want_w, 3) and res.sr.dtype == np.uint8
        assert res.text == text
        assert res.priors.shape == (len(text), 128, 128, 3)

    res16, launched = _launched(lambda: lines16.restore_lines(segments))
    assert lines16.chunks == -(-n_seg // 16)
    assert launched == _times(RESTORE_LAUNCHES, lines16.chunks)
    slots = []
    for c, start in enumerate(range(0, n_seg, 16)):
        chunk = lines16._chunk(segments[start:start + 16])
        slots.append(chunk.inputs[1].shape[1])
        out = net.restore(*chunk.inputs)
        sr = _pack_uint8(out.sr).cpu().numpy()
        priors = _pack_uint8(out.priors).cpu().numpy()
        for i, r in enumerate(res16[start:start + 16]):
            assert np.array_equal(r.sr, sr[i, :, :r.sr.shape[1]]), (c, i)
            assert np.array_equal(r.priors, priors[i, :r.priors.shape[0]])
    assert set(slots) == {4, 8, 16}

    # a host synchronisation inside restore would serialise the loop
    chunk = lines16._chunk(segments[:16])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _pack_uint8(net.restore(*chunk.inputs).sr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()]
    assert not syncs


def test_page_chunking_invariance_f32(dev):
    """The page's lines of up to 8 characters in f32: the default cap (one
    chunk) against chunks of 16 rows. (All 48 lines at 16 slots in f32
    would not fit in 80 GB.)"""
    page, line_boxes, texts, char_boxes = _page(np.random.default_rng(6))
    keep = [i for i, t in enumerate(texts) if len(t) <= 8]
    line_boxes, texts, char_boxes = ([seq[i] for i in keep] for seq in
                                     (line_boxes, texts, char_boxes))
    net = MARCONet(dtype=torch.float32, device=dev, seed=0)
    whole = TextPageRestorer(net)
    res = whole.restore_page(page, line_boxes, texts, char_boxes)
    res16 = TextPageRestorer(net, buckets=(16,)).restore_page(
        page, line_boxes, texts, char_boxes)
    assert whole.chunks == 1
    diff = np.concatenate([np.abs(a.sr.astype(int) - b.sr.astype(int))
                           .ravel() for a, b in zip(res, res16)])
    assert int(diff.max()) <= PAGE_INVARIANCE_MAX
    assert float((diff > 0).mean()) <= PAGE_INVARIANCE_SHARE


# f32, TF32 off: a prior batch of 88 slots against one of 8, so cuDNN may
# take other algorithms and sum in other orders
INTERP_S, INTERP_N = 11, 8
INTERP_TOL = 1e-4


def test_interpolate_styles_endpoints(dev):
    """``interpolate_styles`` at full width in f32, 11 blends of 8 labels
    between the styles of two encoded lines: its endpoints against
    ``generate_priors`` at each style."""
    net = MARCONet(dtype=torch.float32, device=dev, seed=0)
    gen = np.random.default_rng(7)
    lq = torch.from_numpy(gen.uniform(-1, 1, (2, 32, 512, 3))
                          .astype(np.float32))
    _, _, w = net.encode(lq)
    labels = torch.from_numpy(gen.integers(0, BLANK_INDEX, INTERP_N))
    imgs = net.interpolate_styles(w[0], w[1], labels,
                                  torch.linspace(0.0, 1.0, INTERP_S))
    assert tuple(imgs.shape) == (INTERP_S, INTERP_N, 128, 128, 3)
    assert bool(torch.isfinite(imgs).all())
    with torch.inference_mode():
        for i, style in ((0, w[1]), (-1, w[0])):   # weight 0: w2; 1: w1
            pri = net.generate_priors(style[None], labels[None].to(dev))
            assert _max_abs(imgs[i], pri.image.permute(0, 2, 3, 1)) \
                <= INTERP_TOL


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# card vs CPU, f32, TF32 off: losses rtol 1e-3 / atol 1e-4 (full-width
# reductions in another order); each net's gradient (the G phase's for
# encoder, prior and SR net, the D and SRD phases' for the discriminators)
# by relative L2 norm. The SR net's 1e-2 is the f32 sensitivity of its
# masked GroupNorm / AdaIN statistics (the CPU suite holds it to 1e-2
# against JAX). The encoder's 1e-2 on the cuDNN path: one ReLU input in
# its trunk lies within f32 rounding of 0 and cuDNN's f32 forward puts it
# on the other side, which reroutes the gradient through that unit. The
# port's own math is held tighter: the encoder's gradient with PyTorch's
# native CUDA convolutions within 1e-3.
PARITY_SLOTS = 4
PARITY_LOSS_TOL = (1e-3, 1e-4)
PARITY_GRAD_TOL = {"encoder": 1e-2, "prior": 1e-3, "srnet": 1e-2,
                   "net_d": 1e-3, "net_srd": 1e-3}
PARITY_NATIVE_ENCODER_TOL = 1e-3
# two ranks' summed gradients against one process's
PARITY_GRAD_TOL_DP = 1e-2


def _train_arrays(gen: np.random.Generator, batch: int, slots: int):
    """A training batch from seeded random GT lines and ink masks, 3 valid
    characters per line, through the port's ``prepare_train_batch``."""
    w = 128 * slots
    gt = gen.uniform(-1, 1, (batch, 128, w, 3)).astype(np.float32)
    ink = (gen.uniform(0, 1, (batch, 128, w, 3)) > 0.7).astype(np.float32)
    lq = gen.uniform(-1, 1, (batch, 32, w // 4, 3)).astype(np.float32)
    labels = np.full((batch, slots), BLANK_INDEX, np.int64)
    box = np.zeros((batch, 2 * slots), np.float32)
    for i in range(batch):
        labels[i, :3] = gen.integers(0, BLANK_INDEX, 3)
        lefts = np.sort(gen.uniform(0.0, 0.8, 3))
        box[i, 0:6:2] = lefts
        box[i, 1:6:2] = lefts + 0.05
    return prepare_train_batch(gt, ink, labels, box, lq)


def _grads(trainer, net: str) -> torch.Tensor:
    return torch.cat([p.grad.float().cpu().ravel()
                      for _, p in trainer.net(net).named_parameters()])


def test_train_step_matches_cpu(dev):
    """One full-width f32 ``train_step`` (B=1, 4 slots, random LPIPS
    explicitly allowed) on the card against the CPU from the same state:
    every loss term, each net's gradient, every parameter with a gradient
    moved by the optimizer; then the G phase again with
    cuDNN off, its encoder gradient held tighter."""
    kw = dict(max_chars=PARITY_SLOTS, allow_random_lpips=True)
    cpu = MARCONetTrainer(TrainConfig(), device="cpu", seed=0, **kw)
    gpu = MARCONetTrainer(TrainConfig(), device=dev, seed=1, **kw)
    start = copy.deepcopy(cpu.state_dict())
    gpu.load_state_dict(start)
    gpu.lpips.load_state_dict(cpu.lpips.state_dict())
    arrays = _train_arrays(np.random.default_rng(3), 1, PARITY_SLOTS)
    # oneDNN off on the CPU: its strided 1x1 conv backward has crashed
    # PyTorch's CPU build; the native convolutions compute the same
    with torch.backends.mkldnn.flags(enabled=False):
        want = cpu.train_step(TrainBatch.from_numpy(arrays, "cpu"))
    params = {f"{n}.{k}": p for n in NETS
              for k, p in gpu.net(n).named_parameters()}
    before = {k: p.detach().clone() for k, p in params.items()}
    got, launched = _launched(
        lambda: gpu.train_step(TrainBatch.from_numpy(arrays, dev)))
    assert launched == TRAIN_LAUNCHES
    # Adam's first update is about lr * sign(g): every parameter tensor
    # with a gradient entry above 100 x its eps moved
    for key, p in params.items():
        assert p.grad is not None, key
        assert not bool((p.grad.abs() > 1e-6).any()) or not torch.equal(
            p.detach(), before[key]), f"{key} did not move"
    del before
    rtol, atol = PARITY_LOSS_TOL
    for key, w in want.items():
        assert abs(float(got[key]) - float(w)) <= atol + rtol * abs(
            float(w)), key
    rel = {net: _rel_l2(_grads(gpu, net), _grads(cpu, net))
           for net in PARITY_GRAD_TOL}
    assert all(rel[net] <= tol for net, tol in PARITY_GRAD_TOL.items()), rel

    gpu.load_state_dict(start)
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        gpu.g_phase(TrainBatch.from_numpy(arrays, dev))
    assert _rel_l2(_grads(gpu, "encoder"), _grads(cpu, "encoder")) \
        <= PARITY_NATIVE_ENCODER_TOL


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_one_rank_nccl_step(dev, monkeypatch):
    """One full-width ``train_step`` under a one-rank NCCL group: the G, D
    and SRD phases each all-reduce their gradients (a sum over one rank
    leaves them as they were), with the exact launches of a step."""
    calls = []
    reduce_grads = distributed.all_reduce_grads

    def checked(params, *args, **kwargs):
        params = [p for p in params if p.grad is not None]
        before = [p.grad.clone() for p in params]
        n = reduce_grads(params, *args, **kwargs)
        calls.append((n, all(torch.equal(a, p.grad)
                             for a, p in zip(before, params))))
        return n

    monkeypatch.setattr(distributed, "all_reduce_grads", checked)
    arrays = seeded_batch(np.random.default_rng(12), 2, 16, (3, 9))
    assert distributed.maybe_initialize(f"localhost:{_free_port()}", 1, 0,
                                        backend="nccl", device=dev)
    try:
        assert torch.distributed.get_backend() == "nccl"
        trainer = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                                  allow_random_lpips=True)
        metrics, launched = _launched(lambda: trainer.train_step(
            TrainBatch.from_numpy(arrays, dev)))
        torch.cuda.synchronize()
    finally:
        distributed.shutdown()
    assert launched == TRAIN_LAUNCHES
    assert len(calls) == 3 and all(n > 0 and same for n, same in calls)
    assert all(math.isfinite(float(v)) for v in metrics.values())


DP_WORLD = 2              # ranks sharing the one card over gloo
# valid characters of the global batch's rows: rank 0 holds 8, rank 1 20,
# so per-rank masked means would not be the global batch's
DP_COUNTS = (3, 5, 8, 12)
DP_RANK_TIMEOUT_S = 600


def _grad_vector(trainer, net: str) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for _, p in sorted(
        trainer.net(net).named_parameters()) if p.grad is not None])


def _state_digest(trainer) -> str:
    """SHA-256 of every net's parameters and buffers (spectral u / v
    included), in a fixed order."""
    h = hashlib.sha256()
    for net in NETS:
        for k, v in sorted(trainer.net(net).state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_rank(rank: int, init: str, arrays, ref_path: str, out_q) -> None:
    """One rank of :func:`test_two_ranks_match_one_process`, in a spawned
    process on the one card."""
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        distributed.maybe_initialize(init, DP_WORLD, rank, backend="gloo",
                                     device=dev)
        try:
            trainer = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                                      allow_random_lpips=True)
            for net in NETS:
                distributed.broadcast_module_state(trainer.net(net))
            local = distributed.local_batch_slice(arrays, len(arrays["lq"]))
            metrics, launched = _launched(lambda: trainer.train_step(
                TrainBatch.from_numpy(local, dev)))
            out = {"launches": launched,
                   "metrics": {k: float(v) for k, v in metrics.items()},
                   "valid": float(local["char_valid"].sum())}
            ref = torch.load(ref_path, map_location=dev, weights_only=True)
            out["grad_rel_l2"] = {
                net: _rel_l2(_grad_vector(trainer, net), ref["grads"][net])
                for net in NETS}
            del ref
            out["digest"] = _state_digest(trainer)
            distributed.barrier()
        finally:
            distributed.shutdown()
        out_q.put((rank, out))
    except Exception:
        out_q.put((rank, traceback.format_exc()))


def test_two_ranks_match_one_process(dev, tmp_path):
    """Two spawned ranks sharing the card over gloo with CUDA tensors (NCCL
    refuses two ranks on one device), each on its half of one seeded
    global batch of 4 whose halves hold 8 and 20 valid characters, one
    full-width ``train_step`` each, against one process's step at batch 4
    (run first and freed): the losses, each net's summed gradient, both
    ranks' nets equal after the step, the launches of a step on each."""
    arrays = seeded_batch(np.random.default_rng(11), len(DP_COUNTS), 16,
                          DP_COUNTS)
    one = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                          allow_random_lpips=True)
    want = {k: float(v) for k, v in one.train_step(
        TrainBatch.from_numpy(arrays, dev)).items()}
    ref_path = str(tmp_path / "reference.pt")
    torch.save({"grads": {net: _grad_vector(one, net).cpu()
                          for net in NETS}}, ref_path)
    del one
    gc.collect()
    torch.cuda.empty_cache()

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    init = "file://" + str(tmp_path / "rendezvous")
    procs = [ctx.Process(target=_dp_rank,
                         args=(r, init, arrays, ref_path, out_q))
             for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < DP_WORLD:
            try:
                rank, out = out_q.get(timeout=DP_RANK_TIMEOUT_S)
            except queue.Empty:
                pytest.fail(f"ranks {sorted(results)} of {DP_WORLD} "
                            f"reported in {DP_RANK_TIMEOUT_S} s")
            assert not isinstance(out, str), f"rank {rank} failed:\n{out}"
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    ranks = [results[r] for r in range(DP_WORLD)]
    assert ranks[0]["valid"] != ranks[1]["valid"]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for out in ranks:
        assert out["launches"] == TRAIN_LAUNCHES
        for k, w in want.items():
            assert math.isclose(out["metrics"][k], w,
                                rel_tol=PARITY_LOSS_TOL[0],
                                abs_tol=PARITY_LOSS_TOL[1]), k
        assert all(err <= PARITY_GRAD_TOL_DP
                   for err in out["grad_rel_l2"].values()), out["grad_rel_l2"]


# the bf16 step against the f32 step from one state and batch at the CPU
# suite's reduced size (width 0.0625, 4 slots, B=2): each loss term within
# BF16_LOSS_TOL = (rtol, atol) of its f32 value, each net's gradient within
# BF16_GRAD_RTOL relative L2 of its f32 one. Bounds: about twice the
# largest bf16-vs-f32 distances seen at that size, on the CPU over two
# seeds and on an H100 (700 W): loss terms within 4.7 % of their value +
# 1e-4 (the hinge terms near 0; the others within 0.83 %); gradients'
# relative L2: encoder 0.18-0.34, SR net 0.04-0.38, prior 0.055-0.082,
# discriminators 0.005-0.018. Random-weight nets in bf16 cross ReLU and
# leaky-ReLU boundaries the f32 nets do not, which moves the encoder's and
# SR net's gradients most
BF16_PARITY = dict(width=0.0625, max_chars=4)
BF16_LOSS_TOL = (0.1, 1e-4)
BF16_GRAD_RTOL = {"encoder": 0.7, "prior": 0.2, "srnet": 0.75,
                  "net_d": 0.05, "net_srd": 0.05}


def test_bf16_step_near_f32_step(dev):
    """One bf16 and one f32 step on the card from one seeded state and
    batch at the reduced size: losses within ``BF16_LOSS_TOL``, each net's
    gradient within ``BF16_GRAD_RTOL``."""
    arrays = _train_arrays(np.random.default_rng(17), 2,
                           BF16_PARITY["max_chars"])
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        trainer = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                                  allow_random_lpips=True, dtype=dtype,
                                  **BF16_PARITY)
        metrics = trainer.train_step(TrainBatch.from_numpy(arrays, dev))
        out[dtype] = ({k: float(v) for k, v in metrics.items()},
                      {n: _grads(trainer, n) for n in NETS})
    (l32, g32), (lbf, gbf) = out[torch.float32], out[torch.bfloat16]
    rtol, atol = BF16_LOSS_TOL
    for k, want in l32.items():
        assert abs(lbf[k] - want) <= atol + rtol * abs(want), (k, lbf[k],
                                                                want)
    rel = {n: _rel_l2(gbf[n], g32[n]) for n in NETS}
    assert all(rel[n] <= BF16_GRAD_RTOL[n] for n in NETS), rel


def test_bf16_step_runs_bf16_kernels_over_f32_state(dev):
    """One profiled full-width step of ``MARCONetTrainer(dtype=bf16)``
    (bf16 compute over f32 parameters and Adam states): every K1 / K1b /
    K2 / K2 backward launch is the kernel's bf16 instantiation, and every
    parameter, gradient, buffer and Adam state is f32 afterwards."""
    from torch.profiler import ProfilerActivity, profile

    trainer = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                              allow_random_lpips=True, dtype=torch.bfloat16)
    batch = TrainBatch.from_numpy(
        seeded_batch(np.random.default_rng(18), 2, 16, (8, 8)), dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        metrics, launched = _launched(lambda: trainer.train_step(batch))
        torch.cuda.synchronize()
    assert launched == TRAIN_LAUNCHES
    assert all(math.isfinite(float(v)) for v in metrics.values())
    for wrapper, kernel in KERNEL_NAMES.items():
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        assert len(names) == TRAIN_LAUNCHES[wrapper], (kernel, names)
        assert all("bfloat16" in n for n in names), sorted(set(names))
    for name in NETS:
        net = trainer.net(name)
        for key, p in net.named_parameters():
            assert p.dtype == torch.float32, (name, key)
            assert p.grad is None or p.grad.dtype == torch.float32, key
        for key, b in net.named_buffers():
            assert b.dtype == torch.float32, (name, key)
        for st in trainer.optimizers[name].state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype \
                == torch.float32, name


# ---------------------------------------------------------------------------
# the front-end: YOLO11-m + ConvNextViT
# ---------------------------------------------------------------------------

# the seed of the front-end's random weights and the detect head's class
# bias, chosen so that each line gives FE_BOXES[i] boxes (1 to 16): at
# -2.0 every anchor scores above the 0.07 threshold by at least 0.043 and
# NMS keeps 6 and 5 of them, on the card and on its machine's CPU (torch
# 2.11; torch's CPU generator draws other weights in other versions, so
# the counts belong to that machine)
FE_SEED = 0
FE_CLS_BIAS = -2.0
FE_BOXES = (6, 5)
FE_LINES = ((64, 1024), (48, 700))     # (height, width) of each line
FE_LINE_SEED = 8
# the recognizer's positional embedding: 75 tokens, a canonical input of
# 300 x 32 (a 5-box window of square characters squeezed or padded to it);
# the released model's length is not in the repository
OCR_SEQ_LEN = 75
# card (cuDNN, TF32 off) against CPU, f32: YOLO before NMS with the
# tolerances of tests/test_frontend.py's whole-graph oracle (scores rtol /
# atol 2e-4; boxes rtol 2e-4, atol 2e-2 px); recognizer logits within
# OCR_LOGIT_TOL, and ids equal wherever the CPU's top-2 margin exceeds
# twice that
YOLO_TOL = {"scores": (2e-4, 2e-4), "boxes": (2e-4, 2e-2)}
OCR_LOGIT_TOL = 1e-3


def _fe_lines() -> list:
    gen = np.random.default_rng(FE_LINE_SEED)
    return [gen.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in FE_LINES]


def _write_frontend_checkpoints(path: str) -> None:
    """Seeded full-size front-end weights, saved as the files
    ``CharacterFrontend.from_checkpoints`` looks for: YOLO11-m (one class)
    with BatchNorm statistics drawn as ``tests/yolo_oracle.py`` draws them
    (at their init, activations fade over the 23 layers and every anchor
    scores the same to 1e-5) and the class bias set to ``FE_CLS_BIAS``;
    the default ``OCRConfig`` recognizer under ModelScope's
    ``recognizer.`` prefix; and the alphabet as its vocabulary (class 0
    the blank)."""
    g = torch.Generator().manual_seed(FE_SEED)
    det = YOLO11(nc=1, device="cpu", generator=g)
    with torch.no_grad():
        for m in det.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(
                    0.5 + 0.5 * torch.randn(c, generator=g).abs())
        for head in det.model[23].cv3:
            head[2].bias.fill_(FE_CLS_BIAS)
    torch.save(det.state_dict(),
               os.path.join(path, "yolo11m_character_sd.pth"))
    ocr = ConvNextViT(OCRConfig(seq_len=OCR_SEQ_LEN), device="cpu",
                      generator=g)
    torch.save({f"recognizer.{k}": v for k, v in ocr.state_dict().items()},
               os.path.join(path, "ocr_convnext_sd.pth"))
    with open(os.path.join(path, "ocr_vocab.txt"), "w",
              encoding="utf-8") as f:
        f.writelines(f"{c}\n" for c in alphabet())


def test_frontend_matches_cpu(dev, tmp_path):
    """``CharacterFrontend`` at full size (YOLO11-m, ConvNeXt-T + 12 ViT
    blocks over 6736 classes) from seeded ``torch.save``d checkpoints, on
    the card and on the CPU over two seeded lines: YOLO before NMS, the
    same kept boxes (``FE_BOXES`` a line), int boxes within 1 px,
    recognizer logits, and ids where the margin allows."""
    _write_frontend_checkpoints(str(tmp_path))
    gpu = CharacterFrontend.from_checkpoints(str(tmp_path), device=dev)
    cpu = CharacterFrontend.from_checkpoints(str(tmp_path), device="cpu")
    counts = []
    for img in _fe_lines():
        padded, _, _ = letterbox(img, gpu.imgsz)
        x = torch.from_numpy(padded[None].astype(np.float32) / 255.0)
        with torch.inference_mode():
            got, want = gpu.yolo(x.to(dev)), cpu.yolo(x)
            for name, g, w in zip(("boxes", "scores"), got, want):
                rtol, atol = YOLO_TOL[name]
                torch.testing.assert_close(g.cpu(), w, rtol=rtol, atol=atol)
            kept = []
            for net_out in (got, want):
                top, _, valid = nms_static(
                    net_out[0][0], net_out[1][0, :, 0], gpu.max_det,
                    gpu.iou, gpu.conf)
                kept.append(top[valid > 0].cpu())
        # the same boxes kept, in the same score order
        torch.testing.assert_close(kept[0], kept[1], rtol=YOLO_TOL["boxes"][0],
                                   atol=YOLO_TOL["boxes"][1])
        boxes_g, boxes_c = gpu.detect_boxes(img), cpu.detect_boxes(img)
        assert boxes_g.shape == boxes_c.shape
        assert len(boxes_g) == 0 or np.abs(boxes_g - boxes_c).max() <= 1
        counts.append(len(boxes_g))

        segs = [mask_segment(img, boxes_c, j)[0] for j in range(len(boxes_c))]
        prep = np.stack([prepare_segment(s, gpu.ocr.config.canonical_width)
                         for s in segs]).astype(np.float32)
        prep = torch.from_numpy((prep / 255.0 - 0.5) / 0.5)
        with torch.inference_mode():
            lg, lc = gpu.ocr(prep.to(dev)).cpu(), cpu.ocr(prep)
        top2 = lc.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > 2 * OCR_LOGIT_TOL
        assert _max_abs(lg, lc) <= OCR_LOGIT_TOL
        assert bool((lg.argmax(-1) == lc.argmax(-1))[sure].all())
    assert counts == list(FE_BOXES)


# ---------------------------------------------------------------------------
# the CUDA defaults of the entry points
# ---------------------------------------------------------------------------

def test_test_sr_cli_on_the_card(dev, tmp_path):
    """``cli/test_sr.main`` with ``-m`` and its CUDA default on one seeded
    PNG line at full width (random weights: no checkpoint): its collage
    decodes at its shape, with the launches of its two restores."""
    lines, out = tmp_path / "lines", tmp_path / "out"
    lines.mkdir()
    h, w = FE_LINES[1]
    write_png(str(lines / "line_AbC3.png"), _fe_lines()[1])
    done, launched = _launched(lambda: cli_test_sr.main(
        ["-i", str(lines), "-o", str(out), "-m", "--ckpt_dir",
         str(tmp_path)]))
    assert [(name, text) for name, text, _ in done] == [
        ("line_AbC3.png", "AbC3")]
    assert launched == _times(RESTORE_LAUNCHES, done[0][2])
    assert read_png(str(out / "line_AbC3_AbC3.png")).shape == (
        4 * 128, round(w * 128 / h), 3)


def test_train_loop_two_steps(dev, tmp_path, monkeypatch):
    """``train.loop.train`` from ``options/train.yml`` at full width with
    its CUDA default, one spawned worker drawing in the fixture font, two
    steps: finite losses and the exact launches of each step."""
    config = load_config(os.path.join(ROOT, "options", "train.yml"))
    loop = config.loop
    loop.experiments_root = str(tmp_path)
    loop.num_workers = 1
    loop.print_freq, loop.val_freq, loop.save_freq = 1, 0, 10 ** 9
    loop.allow_random_lpips = True
    loop.font_dir = FONT_DIR
    steps = []
    step = MARCONetTrainer.train_step

    def counted(self, *args, **kwargs):
        metrics, launched = _launched(lambda: step(self, *args, **kwargs))
        steps.append((launched, {k: float(v) for k, v in metrics.items()}))
        return metrics

    monkeypatch.setattr(MARCONetTrainer, "train_step", counted)
    trainer = train(config, max_steps=2)
    assert trainer.step == 2 and len(steps) == 2
    for launched, losses in steps:
        assert launched == TRAIN_LAUNCHES
        assert all(math.isfinite(v) for v in losses.values()), losses
