"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA Hopper GPU and skip elsewhere (the
decision is taken in a fixture, never at import). The machine with the
card has no JAX, so this file imports only torch and the port; run it
there without the suite's JAX-configuring conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(or with ``tests/test_torch_cuda_nets.py`` beside it).

Every kernel does its math in f32 and rounds once, like its plain
version. K1, K1b and K2 sum nothing, so their comparisons are exact; K3
(``conv3x3_same``) sums 9 * CI products in another order than its plain
version, so it is held within one bf16 ulp in bf16 and within 1e-5 of the
largest value in f32 (the limits of ``chip_smoke.py`` phase 4), on each
of its three kernels: the FMA one for every f32 input, the TMA + wgmma
one where ``conv3x3_path`` picks it in bf16 and the general mma.sync one
for every other bf16 input. The backward kernels (K1b and the
write-back's) are also driven through autograd, to show that gradients
reach the inputs through both kernels. The nets and entry points that
run these kernels are held against the CPU on the card by
``tests/test_torch_cuda_nets.py``.
"""

import numpy as np
import pytest
import torch

from marconet_tpu_torch.ops.conv3x3 import (
    _conv3x3_mma_sync,
    conv3x3_path,
    conv3x3_same,
    conv3x3_same_plain,
)
from marconet_tpu_torch.ops.fused_act import (
    fused_leaky_relu,
    fused_leaky_relu_bwd,
    fused_leaky_relu_bwd_plain,
    fused_leaky_relu_plain,
)
from marconet_tpu_torch.ops.sft_writeback import (
    sft_writeback,
    sft_writeback_bwd,
    sft_writeback_bwd_plain,
    sft_writeback_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda", 0)


DTYPES = [torch.float32, torch.bfloat16]


# (rows, C) or NCHW channels_last; C = 33, 7, 5, 17 and 1 take K1's
# one-element path, C = 512 (the style MLP) and 8 its 16-byte path
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (1000, 33),
                                   (2, 5, 3, 3), (4, 13, 9, 17),
                                   (128, 512), (3, 8, 11, 7)])
def test_fused_leaky_relu_matches_plain(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(0)
    if len(shape) == 2:
        x = torch.randn(shape, device=dev, generator=g)
    else:   # NCHW view of NHWC storage: channels_last
        n, c, h, w = shape
        x = torch.randn(n, h, w, c, device=dev, generator=g).permute(
            0, 3, 1, 2)
    x = x.to(dtype)
    bias = torch.randn(x.shape[1], device=dev, generator=g)
    before = fused_leaky_relu.launches
    got = fused_leaky_relu(x, bias)
    torch.cuda.synchronize()
    assert fused_leaky_relu.launches == before + 1
    assert got.stride() == x.stride()
    torch.testing.assert_close(got, fused_leaky_relu_plain(x, bias),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_leaky_relu_misaligned_view(dev, dtype):
    """A 2-D view one element past an aligned address: C = 64 would take
    K1's 16-byte path, the pointer sends it to the one-element path;
    bit-exact."""
    g = torch.Generator(device=dev).manual_seed(4)
    buf = torch.randn(257 * 64 + 1, device=dev, generator=g).to(dtype)
    x = buf[1:].view(257, 64)
    assert x.data_ptr() % 16 != 0
    bias = torch.randn(x.shape[1], device=dev, generator=g)
    before = fused_leaky_relu.launches
    got = fused_leaky_relu(x, bias)
    torch.cuda.synchronize()
    assert fused_leaky_relu.launches == before + 1
    torch.testing.assert_close(got, fused_leaky_relu_plain(x, bias),
                               rtol=0, atol=0)


def test_fused_leaky_relu_raises_on_layouts(dev):
    with pytest.raises(ValueError):
        fused_leaky_relu(torch.zeros(2, 8, 4, 4, device=dev),
                         torch.zeros(8, device=dev))
    with pytest.raises(ValueError):
        fused_leaky_relu(torch.zeros(4, 8, device=dev, dtype=torch.float16),
                         torch.zeros(8, device=dev))


def _lrelu_input(dev, dtype, shape, g):
    if len(shape) == 2:
        x = torch.randn(shape, device=dev, generator=g)
    else:   # NCHW view of NHWC storage: channels_last
        n, c, h, w = shape
        x = torch.randn(n, h, w, c, device=dev, generator=g).permute(
            0, 3, 1, 2)
    return x.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (1000, 33),
                                   (2, 5, 3, 3), (4, 13, 9, 17)])
def test_fused_leaky_relu_backward_matches_plain(dev, dtype, shape):
    """K1b through autograd: dx equals the plain twin bit for bit, db is
    the f32 sum of dx over the rows rounded to x's dtype, as the JAX
    package rounds it (rtol 1e-5: summation order)."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = _lrelu_input(dev, dtype, shape, g).requires_grad_()
    bias = torch.randn(x.shape[1], device=dev, generator=g,
                       requires_grad=True)
    # a cotangent in the default (not channels_last) layout: the backward
    # must take it as it comes
    cot = torch.randn(x.shape, device=dev, generator=g).to(dtype)
    before = fused_leaky_relu_bwd.launches
    fused_leaky_relu(x, bias).backward(cot)
    torch.cuda.synchronize()
    assert fused_leaky_relu_bwd.launches == before + 1
    want_dx = fused_leaky_relu_bwd_plain(x.detach(), bias.detach(), cot)
    torch.testing.assert_close(x.grad, want_dx, rtol=0, atol=0)
    axes = (0,) if x.dim() == 2 else (0, 2, 3)
    want_db = want_dx.float().sum(dim=axes).to(dtype).to(bias.dtype)
    torch.testing.assert_close(bias.grad, want_db, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_leaky_relu_backward_misaligned_view(dev, dtype):
    """K1b with x one element past an aligned address (C = 64 would take
    the 16-byte path; the pointer sends it to the one-element path), then
    with g so: bit-exact."""
    g = torch.Generator(device=dev).manual_seed(5)
    buf = torch.randn(2, 257 * 64 + 1, device=dev, generator=g).to(dtype)
    x0, g0 = (buf[i, :-1].view(257, 64) for i in range(2))
    x1, g1 = (buf[i, 1:].view(257, 64) for i in range(2))
    bias = torch.randn(64, device=dev, generator=g)
    for x, cot in ((x1, g0), (x0, g1)):
        before = fused_leaky_relu_bwd.launches
        got = fused_leaky_relu_bwd(x, bias, cot)
        torch.cuda.synchronize()
        assert fused_leaky_relu_bwd.launches == before + 1
        torch.testing.assert_close(
            got, fused_leaky_relu_bwd_plain(x, bias, cot), rtol=0, atol=0)


def test_fused_leaky_relu_gradcheck(dev):
    """Gradients reach x and bias through K1 and K1b: autograd against
    finite differences of the kernel itself (f32, eps 1e-2 steps the
    pre-activation well away from the kink; inputs kept off 0)."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(6, 5, device=dev, generator=g)
    x = (x + 0.5 * torch.sign(x)).requires_grad_()
    bias = torch.zeros(5, device=dev, requires_grad=True)
    assert torch.autograd.gradcheck(fused_leaky_relu, (x, bias), eps=1e-2,
                                    atol=1e-2, rtol=1e-2)


def _writeback_case(dev, dtype, b, h, w, c, s, win, seed):
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(1)
    canvas = torch.randn(b, h, w, c, device=dev, generator=g).to(dtype)
    res = torch.randn(b, s, h, win, c, device=dev, generator=g).to(dtype)
    # starts past the right edge, lengths past win (clamped), invalid slots
    x1 = rng.integers(0, w + 3, (b, s))
    length = rng.integers(-1, win + 3, (b, s))
    valid = rng.integers(0, 2, (b, s))
    x1, length, valid = (torch.tensor(a, dtype=torch.int32, device=dev)
                         for a in (x1, length, valid))
    return canvas, res, x1, length, valid


WRITEBACK_SHAPES = [
    (1, 1, 1, 1, 1, 1),
    (2, 3, 77, 48, 5, 13),        # no alignment anywhere
    (3, 8, 100, 300, 16, 32),     # C above one thread tile, ragged
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,s,win", WRITEBACK_SHAPES)
def test_sft_writeback_matches_plain(dev, dtype, b, h, w, c, s, win):
    canvas, res, x1, length, valid = _writeback_case(
        dev, dtype, b, h, w, c, s, win, b * 1000 + w)
    before = sft_writeback.launches
    got = sft_writeback(canvas, res, x1, length, valid)
    torch.cuda.synchronize()
    assert sft_writeback.launches == before + 1
    torch.testing.assert_close(
        got, sft_writeback_plain(canvas, res, x1, length, valid),
        rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,s,win", WRITEBACK_SHAPES)
def test_sft_writeback_backward_matches_plain(dev, dtype, b, h, w, c, s,
                                             win):
    """The write-back's backward kernel through autograd: d res equals the
    autograd of the plain version bit for bit; d canvas is g."""
    canvas, res, x1, length, valid = _writeback_case(
        dev, dtype, b, h, w, c, s, win, b * 2000 + w)
    canvas.requires_grad_()
    res.requires_grad_()
    cot = torch.randn(canvas.shape, device=dev).to(dtype)
    before = sft_writeback_bwd.launches
    sft_writeback(canvas, res, x1, length, valid).backward(cot)
    torch.cuda.synchronize()
    assert sft_writeback_bwd.launches == before + 1
    torch.testing.assert_close(
        res.grad, sft_writeback_bwd_plain(cot, x1, length, valid, win),
        rtol=0, atol=0)
    torch.testing.assert_close(canvas.grad, cot, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sft_writeback_backward_misaligned_grad(dev, dtype):
    """The backward kernel with g one element past an aligned address (C =
    48 would take the 16-byte path): bit-exact to the plain version."""
    _, _, x1, length, valid = _writeback_case(dev, dtype, 2, 3, 77, 48, 5,
                                              13, 11)
    buf = torch.randn(2 * 3 * 77 * 48 + 1, device=dev).to(dtype)
    grad = buf[1:].view(2, 3, 77, 48)
    assert grad.data_ptr() % 16 != 0
    before = sft_writeback_bwd.launches
    got = sft_writeback_bwd(grad, x1, length, valid, 13)
    torch.cuda.synchronize()
    assert sft_writeback_bwd.launches == before + 1
    torch.testing.assert_close(
        got, sft_writeback_bwd_plain(grad, x1, length, valid, 13), rtol=0,
        atol=0)


def test_sft_writeback_gradcheck(dev):
    """Gradients reach canvas and res through K2 and its backward (f64 is
    not a kernel dtype, so f32 with finite-difference steps of 1e-2: the
    function is linear in both, so the check is tight anyway)."""
    canvas, res, x1, length, valid = _writeback_case(
        dev, torch.float32, 2, 2, 19, 3, 4, 6, 7)

    def f(canvas, res):
        return sft_writeback(canvas, res, x1, length, valid)

    assert torch.autograd.gradcheck(
        f, (canvas.requires_grad_(), res.requires_grad_()), eps=1e-2,
        atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("op", ["gather_windows", "gather_windows_per_slot",
                                "resample2tap"])
def test_window_ops_differentiate_on_cuda(dev, op):
    """The SFT window gathers and the char-crop resample, forward and
    input gradient on the card against the same ops on the CPU: autograd's
    index scatter-add sums overlapping windows (rtol 1e-6, atol 1e-6:
    order of the atomic adds)."""
    from marconet_tpu_torch.ops import window

    rng = np.random.default_rng(9)
    b, n, h, wp, c, win = 2, 5, 3, 48, 4, 16
    if op == "resample2tap":
        x = rng.standard_normal((b, h, wp, c)).astype(np.float32)
        idx = rng.integers(0, wp, (b, n, win)).astype(np.int32)
        w0 = rng.uniform(0, 1, (b, n, win)).astype(np.float32)
        extra = (idx, w0)
    else:
        shape = (b, n, h, wp, c) if op.endswith("per_slot") else (b, h, wp, c)
        x = rng.standard_normal(shape).astype(np.float32)
        starts = rng.integers(0, wp - win + 1, (b, n)).astype(np.int32)
        starts[0, :2] = [3, 5]                    # overlapping windows
        extra = (starts, win)
    cot = rng.standard_normal((b, n, h, win, c)).astype(np.float32)
    fn = getattr(window, op)
    outs = []
    for d in ("cpu", dev):
        xt = torch.from_numpy(x).to(d).requires_grad_()
        args = [torch.from_numpy(a).to(d) if isinstance(a, np.ndarray)
                else a for a in extra]
        y = fn(xt, *args)
        (y * torch.from_numpy(cot).to(d)).sum().backward()
        outs.append((y.detach().cpu(), xt.grad.cpu()))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-6, atol=1e-6)


# (N, H, W, CI, CO): one pixel, ragged channels (the scalar-load path),
# CI and CO multiples of 8 (16-byte loads) with a partial channel tile,
# and the TPU kernel's test shape
K3_SHAPES = [(1, 1, 1, 5, 3), (3, 7, 13, 40, 24), (2, 9, 64, 300, 130),
             (1, 17, 5, 8, 136), (2, 8, 8, 256, 128)]


def _k3_inputs(dev, dtype, shape):
    n, h, w, ci, co = shape
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(n, h, w, ci, device=dev, generator=g).to(dtype)
    k = torch.randn(3, 3, ci, co, device=dev, generator=g) / (9 * ci) ** 0.5
    return x, k.to(dtype)


def _assert_k3_close(got, x, k):
    want = conv3x3_same_plain(x, k).float()
    d = (got.float() - want).abs()
    if x.dtype == torch.bfloat16:
        # one ulp of max(|plain|, rms(plain) / 16), as chip_smoke.py holds
        floor = float(want.square().mean().sqrt()) / 16
        _, e = torch.frexp(want.abs().clamp_min(floor))
        assert bool((d <= torch.ldexp(torch.ones_like(d), e - 8)).all())
    else:
        assert float(d.max()) <= 1e-5 * float(want.abs().max())


def _launched_once(before: dict, path: str) -> dict:
    """``launches_by_path`` after one launch on ``path``."""
    return {p: n + (p == path) for p, n in before.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_conv3x3_matches_plain(dev, dtype, shape):
    x, k = _k3_inputs(dev, dtype, shape)
    path = conv3x3_path(tuple(x.shape), tuple(k.shape), dtype, True)
    assert path == ("fma" if dtype == torch.float32 else "mma_sync")
    before = conv3x3_same.launches
    by_path = dict(conv3x3_same.launches_by_path)
    got = conv3x3_same(x, k)
    torch.cuda.synchronize()
    assert conv3x3_same.launches == before + 1
    assert conv3x3_same.launches_by_path == _launched_once(by_path, path)
    assert got.shape == shape[:3] + (shape[4],) and got.dtype == dtype
    _assert_k3_close(got, x, k)


# (N, H, W, CI, CO) in f32, all on the FMA kernel: three CO tiles (CO =
# 264), a partial M tile, H = 1 and W = 1, CI = 3 and 6 (scalar A loads),
# CO % 4 != 0 (scalar B copies and stores), both scalar, a long K (CI =
# 512), and one 64 x 64 SFT window
K3_F32_SHAPES = [(1, 8, 8, 64, 264), (1, 5, 7, 16, 32), (2, 1, 37, 8, 16),
                 (2, 23, 1, 8, 16), (2, 9, 11, 3, 8), (1, 12, 12, 6, 20),
                 (1, 9, 9, 16, 30), (1, 7, 6, 5, 9), (1, 8, 8, 512, 64),
                 (1, 64, 64, 256, 256)]


@pytest.mark.parametrize("shape", K3_F32_SHAPES)
def test_conv3x3_f32_fma_matches_plain(dev, shape):
    x, k = _k3_inputs(dev, torch.float32, shape)
    before = dict(conv3x3_same.launches_by_path)
    got = conv3x3_same(x, k)
    torch.cuda.synchronize()
    assert conv3x3_same.launches_by_path == _launched_once(before, "fma")
    assert got.shape == shape[:3] + (shape[4],)
    _assert_k3_close(got, x, k)


def test_conv3x3_f32_misaligned_input(dev):
    """An x view at storage offset 1: the FMA kernel's scalar loads."""
    x, k = _k3_inputs(dev, torch.float32, (2, 16, 16, 64, 128))
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    x1 = buf[1:].view(x.shape)
    x1.copy_(x)
    assert x1.data_ptr() % 16 != 0
    before = dict(conv3x3_same.launches_by_path)
    got = conv3x3_same(x1, k)
    torch.cuda.synchronize()
    assert conv3x3_same.launches_by_path == _launched_once(before, "fma")
    _assert_k3_close(got, x1, k)


def test_conv3x3_general_kernel_refuses_f32(dev):
    x, k = _k3_inputs(dev, torch.float32, (1, 8, 8, 16, 16))
    before = dict(conv3x3_same.launches_by_path)
    with pytest.raises(ValueError):
        _conv3x3_mma_sync(x, k)
    assert conv3x3_same.launches_by_path == before


# (N, H, W, CI, CO) that the rule sends to the TMA + wgmma kernel: one K
# block, two tile rows of 64, a partial CO tile, one window of the SFT
# stack, a CI tail past 64 with two CO tiles, whole 128-pixel rows, and odd
# numbers of 128-pixel tiles (the last cluster's second CTA stores nothing)
WGMMA_SHAPES = [(2, 32, 32, 64, 64), (1, 64, 64, 128, 256),
                (3, 16, 16, 256, 136), (1, 32, 32, 256, 256),
                (1, 16, 16, 72, 264), (2, 1, 128, 64, 64),
                (3, 1, 128, 64, 64), (3, 8, 16, 64, 520)]


@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_conv3x3_wgmma_matches_plain(dev, shape):
    x, k = _k3_inputs(dev, torch.bfloat16, shape)
    assert conv3x3_path(tuple(x.shape), tuple(k.shape), x.dtype,
                        True) == "wgmma"
    before = dict(conv3x3_same.launches_by_path)
    got = conv3x3_same(x, k)
    torch.cuda.synchronize()
    assert conv3x3_same.launches_by_path == _launched_once(before, "wgmma")
    assert got.shape == shape[:3] + (shape[4],)
    _assert_k3_close(got, x, k)


@pytest.mark.parametrize("shape", WGMMA_SHAPES[:2])
def test_conv3x3_general_kernel_on_wgmma_shapes(dev, shape):
    """The general kernel, called past the rule, agrees on the shapes the
    rule gives to wgmma: the two designs compute one function."""
    x, k = _k3_inputs(dev, torch.bfloat16, shape)
    before = dict(conv3x3_same.launches_by_path)
    got = _conv3x3_mma_sync(x, k)
    torch.cuda.synchronize()
    assert conv3x3_same.launches_by_path == _launched_once(before,
                                                           "mma_sync")
    _assert_k3_close(got, x, k)


def test_conv3x3_misaligned_input_takes_general_kernel(dev):
    x, k = _k3_inputs(dev, torch.bfloat16, (1, 32, 32, 64, 64))
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    x1 = buf[1:].view(x.shape)
    x1.copy_(x)
    before = dict(conv3x3_same.launches_by_path)
    got = conv3x3_same(x1, k)
    torch.cuda.synchronize()
    assert conv3x3_same.launches_by_path["mma_sync"] == \
        before["mma_sync"] + 1
    _assert_k3_close(got, x1, k)


@pytest.mark.parametrize("bad", ["float16", "x strided", "w strided"])
def test_conv3x3_raises_without_launching(dev, bad):
    x, k = _k3_inputs(dev, torch.float32, (2, 6, 6, 16, 8))
    if bad == "float16":
        x, k = x.half(), k.half()
    elif bad == "x strided":
        x = x[:, :, ::2]
    else:
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    before = conv3x3_same.launches
    with pytest.raises(ValueError):
        conv3x3_same(x, k)
    assert conv3x3_same.launches == before
