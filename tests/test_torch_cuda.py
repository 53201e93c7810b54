"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA Hopper GPU and skip elsewhere (the
decision is taken in a fixture, never at import). The machine with the
card has no JAX, so this file imports only torch and the port; run it
there without the suite's JAX-configuring conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Both kernels do their math in f32 and round once, like their plain
versions, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from marconet_tpu_torch.ops.fused_act import (
    fused_leaky_relu,
    fused_leaky_relu_plain,
)
from marconet_tpu_torch.ops.sft_writeback import (
    sft_writeback,
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,s,win", [
    (1, 1, 1, 1, 1, 1),
    (2, 3, 77, 48, 5, 13),        # no alignment anywhere
    (3, 8, 100, 300, 16, 32),     # C above one thread tile, ragged
])
def test_sft_writeback_matches_plain(dev, dtype, b, h, w, c, s, win):
    rng = np.random.default_rng(b * 1000 + w)
    g = torch.Generator(device=dev).manual_seed(1)
    canvas = torch.randn(b, h, w, c, device=dev, generator=g).to(dtype)
    res = torch.randn(b, s, h, win, c, device=dev, generator=g).to(dtype)
    # starts past the right edge, lengths past win (clamped), invalid slots
    x1 = rng.integers(0, w + 3, (b, s))
    length = rng.integers(-1, win + 3, (b, s))
    valid = rng.integers(0, 2, (b, s))
    x1, length, valid = (torch.tensor(a, dtype=torch.int32, device=dev)
                         for a in (x1, length, valid))
    before = sft_writeback.launches
    got = sft_writeback(canvas, res, x1, length, valid)
    torch.cuda.synchronize()
    assert sft_writeback.launches == before + 1
    torch.testing.assert_close(
        got, sft_writeback_plain(canvas, res, x1, length, valid),
        rtol=0, atol=0)
