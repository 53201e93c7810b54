"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA Hopper GPU and skip elsewhere (the
decision is taken in a fixture, never at import). The machine with the
card has no JAX, so this file imports only torch and the port; run it
there without the suite's JAX-configuring conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Every kernel does its math in f32 and rounds once, like its plain
version, so every comparison is exact. The backward kernels (K1b and the
write-back's) are also driven through autograd, to show that gradients
reach the inputs through both kernels.
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (1000, 33),
                                   (2, 5, 3, 3), (4, 13, 9, 17)])
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
    the f32 sum of dx over the rows (rtol 1e-5: summation order)."""
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
    torch.testing.assert_close(bias.grad, want_dx.float().sum(dim=axes),
                               rtol=1e-5, atol=1e-5)


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
