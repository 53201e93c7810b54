"""The port's ``conv3x3_same`` (K3's plain version on the CPU) against the
JAX package's Pallas kernel in interpret mode and XLA's conv.

Inputs are made with numpy from a seed and go through both sides on the
CPU. The port's wrapper takes its plain version for CPU tensors, which is
what these cases pin; the CUDA kernel is held against the same plain
version on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from marconet_tpu.ops.pallas_conv import conv3x3_same as jax_conv3x3_same
from marconet_tpu_torch.ops.conv3x3 import (
    conv3x3_path,
    conv3x3_same,
    conv3x3_same_plain,
)

torch.set_num_threads(1)


def _inputs(shape, seed):
    """``TestPallasConv``'s recipe: x ~ 0.3 N(0, 1), w ~ 0.05 N(0, 1)."""
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, h, w, ci)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((3, 3, ci, co)) * 0.05).astype(np.float32)
    return x, k


def _xla_conv(x, k):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")))


@pytest.mark.parametrize("shape", [(2, 8, 8, 256, 128),
                                   (1, 8, 16, 512, 256)])
def test_matches_jax_kernel_and_xla(shape):
    """f32 at ``TestPallasConv``'s shapes, within its rtol / atol 1e-4,
    against the Pallas kernel (interpret mode) and ``lax.conv``."""
    x, k = _inputs(shape, seed=sum(shape))
    got = conv3x3_same(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    assert got.shape == shape[:3] + (shape[4],) and got.dtype == np.float32
    pallas = np.asarray(jax_conv3x3_same(jnp.asarray(x), jnp.asarray(k),
                                         interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _xla_conv(x, k), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(3, 7, 13, 40, 24), (2, 9, 5, 300, 130),
                                   (1, 1, 1, 5, 3), (2, 2, 3, 7, 1)])
def test_ragged_shapes_match_xla(shape):
    """Channel counts the TPU kernel's 256 / 128 blocks do not take, and
    windows of 1 or 2 pixels (where taps fall wholly outside): against
    ``lax.conv`` only, rtol / atol 1e-4."""
    x, k = _inputs(shape, seed=sum(shape))
    got = conv3x3_same(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, _xla_conv(x, k), rtol=1e-4, atol=1e-4)


def _bf16_ulps(got: np.ndarray, want: np.ndarray, floor_div: float = 16):
    """|got - want| in bf16 ulps of max(|want|, rms(want) / 16), the
    measure ``chip_smoke.py`` holds K3 to."""
    floor = np.sqrt(np.mean(want.astype(np.float64) ** 2)) / floor_div
    _, e = np.frexp(np.maximum(np.abs(want), floor))
    return np.abs(got - want) / np.ldexp(1.0, e - 8)


def test_bf16_within_one_ulp_of_jax_kernel():
    """bf16 in, f32 sums, one rounding: the port and the Pallas kernel
    (interpret mode) round one f32 sum each, in different orders, so they
    may differ by one bf16 ulp and no more."""
    shape = (2, 8, 8, 512, 128)
    x, k = _inputs(shape, seed=3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    kt = torch.from_numpy(k).to(torch.bfloat16)
    got = conv3x3_same(xt, kt)
    assert got.dtype == torch.bfloat16
    want = jax_conv3x3_same(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(k, jnp.bfloat16), interpret=True)
    assert want.dtype == jnp.bfloat16
    ulps = _bf16_ulps(got.float().numpy(),
                      np.asarray(want.astype(jnp.float32)))
    assert ulps.max() <= 1.0, ulps.max()


def test_plain_is_the_cpu_path():
    """On CPU tensors the wrapper is the plain version, launches nothing
    and builds no autograd graph (K3 is forward-only)."""
    x, k = _inputs((1, 4, 5, 6, 7), seed=0)
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k)
    before = conv3x3_same.launches
    got = conv3x3_same(xt, kt)
    assert conv3x3_same.launches == before
    assert not got.requires_grad
    torch.testing.assert_close(got, conv3x3_same_plain(xt, kt).detach(),
                               rtol=0, atol=0)


def test_f32_cpu_tensors_launch_no_kernel():
    """f32 at a shape the rule gives to the FMA kernel on the card: on CPU
    tensors the wrapper still runs the plain version and no path counts a
    launch."""
    x, k = _inputs((2, 8, 8, 16, 8), seed=1)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    assert conv3x3_path(tuple(xt.shape), tuple(kt.shape), xt.dtype,
                        True) == "fma"
    before = dict(conv3x3_same.launches_by_path)
    got = conv3x3_same(xt, kt)
    assert conv3x3_same.launches_by_path == before
    torch.testing.assert_close(got, conv3x3_same_plain(xt, kt),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["rank", "taps", "channels", "dtype"])
def test_rejects_bad_arguments(bad):
    x = torch.zeros(1, 4, 4, 8)
    k = torch.zeros(3, 3, 8, 2)
    if bad == "rank":
        x = x[0]
    elif bad == "taps":
        k = torch.zeros(1, 1, 8, 2)
    elif bad == "channels":
        k = torch.zeros(3, 3, 6, 2)
    else:
        k = k.double()
    with pytest.raises(ValueError):
        conv3x3_same(x, k)


BF16, F32 = torch.bfloat16, torch.float32
SFT_SHAPES = [(128, 64, 64, 512, 256), (128, 64, 64, 256, 256),
              (128, 32, 32, 512, 256), (128, 32, 32, 256, 256)]
RAGGED_SHAPES = [(1, 1, 1, 5, 3), (3, 7, 13, 40, 24), (2, 9, 64, 300, 130),
                 (1, 17, 5, 8, 136), (2, 8, 8, 256, 128), (2, 9, 5, 300, 130),
                 (2, 2, 3, 7, 1), (1, 4, 5, 6, 7)]


@pytest.mark.parametrize("shape,dtype,aligned,want", [
    # the SFT window convs of a serving batch
    *[(s, BF16, True, "wgmma") for s in SFT_SHAPES],
    # the shapes the CPU and card tests use for the general kernel
    *[(s, BF16, True, "mma_sync") for s in RAGGED_SHAPES],
    # every f32 input takes the FMA kernel: the SFT shapes, a ragged
    # shape, a misaligned pointer, CI % 4 != 0 and an empty input
    (SFT_SHAPES[0], F32, True, "fma"),
    (SFT_SHAPES[3], F32, True, "fma"),
    ((3, 7, 13, 40, 24), F32, True, "fma"),
    (SFT_SHAPES[0], F32, False, "fma"),
    ((1, 4, 32, 6, 256), F32, True, "fma"),
    ((1, 4, 0, 64, 64), F32, True, "fma"),
    # a misaligned bf16 pointer keeps the general kernel
    (SFT_SHAPES[0], BF16, False, "mma_sync"),
    # boundaries of the rule: W dividing 128, H a multiple of 128 / W,
    # CI and CO multiples of 8
    ((2, 8, 16, 64, 64), BF16, True, "wgmma"),       # W = 16, 8 rows a tile
    ((3, 1, 128, 64, 64), BF16, True, "wgmma"),      # W = 128, one row
    ((1, 128, 1, 8, 8), BF16, True, "wgmma"),        # W = 1, 128 rows
    ((2, 6, 32, 64, 64), BF16, True, "mma_sync"),    # H = 6, not 4k
    ((1, 12, 16, 64, 64), BF16, True, "mma_sync"),   # H = 12, not 8k
    ((1, 4, 256, 64, 64), BF16, True, "mma_sync"),   # W = 256 > 128
    ((1, 8, 48, 64, 64), BF16, True, "mma_sync"),    # 128 % 48 != 0
    ((1, 4, 32, 64, 256), BF16, True, "wgmma"),      # CI = 64
    ((1, 4, 32, 72, 256), BF16, True, "wgmma"),      # CI tail zero-filled
    ((1, 4, 32, 60, 256), BF16, True, "mma_sync"),   # CI % 8 != 0
    ((1, 4, 32, 256, 8), BF16, True, "wgmma"),       # CO = 8
    ((1, 4, 32, 256, 136), BF16, True, "wgmma"),     # partial CO tile
    ((1, 4, 32, 256, 12), BF16, True, "mma_sync"),   # CO % 8 != 0
    ((1, 4, 0, 64, 64), BF16, True, "mma_sync"),     # empty
])
def test_conv3x3_path_rule(shape, dtype, aligned, want):
    """The rule that picks K3's CUDA kernel: the FMA kernel for every f32
    input, TMA + wgmma for bf16 inputs that TMA can tile, the general
    mma.sync kernel for every other bf16 input."""
    n, h, w, ci, co = shape
    assert conv3x3_path((n, h, w, ci), (3, 3, ci, co), dtype, aligned) == want
