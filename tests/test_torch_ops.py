"""The port's ops (``marconet_tpu_torch.ops``) against the JAX package's.

Each case makes its inputs with numpy from a seed, runs the JAX function
(or flax module, initialized by JAX and exported to the port's layout) and
its port counterpart on the CPU in f32, and compares. Tolerances are those
of the matching case in ``tests/test_ops.py``. JAX tensors are NHWC; the
port's are NCHW views in channels_last memory format of the same data.

Kernel K1 (``fused_leaky_relu``) is held against the JAX package's own
reference, ``fused_leaky_relu(..., use_pallas=False)``: its Pallas kernel
has no interpret mode. On CPU tensors the port's wrapper takes its plain
version, which is what these cases pin; the CUDA kernel is compared with
the same plain version on the card by ``tests/test_torch_cuda.py`` (and
``chip_smoke.py`` phase 3), and in the whole nets by
``tests/test_torch_cuda_nets.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from marconet_tpu.ops import fused_act as jfa
from marconet_tpu.ops import layers as jl
from marconet_tpu.ops import modconv as jm
from marconet_tpu.ops import resize as jr
from marconet_tpu.ops import window as jw
from marconet_tpu_torch.convert import (
    modulated_from_jax,
    res_block_from_jax,
    sn_conv_from_jax,
)
from marconet_tpu_torch.ops import fused_act as tfa
from marconet_tpu_torch.ops import layers as tl
from marconet_tpu_torch.ops import modconv as tm
from marconet_tpu_torch.ops import resize as tr
from marconet_tpu_torch.ops import window as tw

torch.set_num_threads(1)


def gen(seed: int = 0) -> torch.Generator:
    """The explicit generator every port constructor takes."""
    return torch.Generator().manual_seed(seed)

def to_port(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC array -> NCHW channels_last tensor (same memory order)."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def from_port(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().numpy()


def np_vars(variables):
    return jax.tree.map(np.asarray, variables)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def f32(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


# ---------------------------------------------------------------------------
# K1: fused bias + LeakyReLU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(128, 64), (2, 6, 5, 32)])
def test_fused_leaky_relu_plain_matches_jax(rng, shape):
    x = f32(rng, *shape)
    b = f32(rng, shape[-1])
    want = np.asarray(jfa.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b),
                                           use_pallas=False))
    xt = torch.from_numpy(x) if len(shape) == 2 else to_port(x)
    got = tfa.fused_leaky_relu_plain(xt, torch.from_numpy(b))
    got = got.numpy() if len(shape) == 2 else from_port(got)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fused_leaky_relu_wrapper_on_cpu_takes_plain(rng):
    x = to_port(f32(rng, 2, 4, 4, 16))
    b = torch.from_numpy(f32(rng, 16))
    before = tfa.fused_leaky_relu.launches
    got = tfa.fused_leaky_relu(x, b)
    torch.testing.assert_close(got, tfa.fused_leaky_relu_plain(x, b),
                               rtol=0, atol=0)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert tfa.fused_leaky_relu.launches == before  # no kernel on CPU


def test_fused_leaky_relu_rejects_layouts(rng):
    b = torch.zeros(16)
    with pytest.raises(ValueError):          # NCHW-contiguous 4-D
        tfa.fused_leaky_relu(torch.zeros(2, 16, 4, 4), b)
    with pytest.raises(ValueError):          # transposed 2-D view
        tfa.fused_leaky_relu(torch.zeros(16, 8).T, b)
    with pytest.raises(ValueError):          # bias of the wrong width
        tfa.fused_leaky_relu(torch.zeros(8, 16), torch.zeros(8))


def test_fused_leaky_relu_plain_rounds_once_in_bf16(rng):
    """bf16 in: math in f32 and a single rounding, as the kernel does."""
    x = torch.from_numpy(f32(rng, 64, 32)).bfloat16()
    b = torch.from_numpy(f32(rng, 32))
    v = x.float() + b.bfloat16().float()
    want = (torch.where(v >= 0, v, v * 0.2) * np.sqrt(2.0)).bfloat16()
    got = tfa.fused_leaky_relu_plain(x, b)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# ops/layers.py
# ---------------------------------------------------------------------------


def test_leaky_relu_and_swish(rng):
    x = f32(rng, 4, 33)
    np.testing.assert_allclose(tl.leaky_relu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.leaky_relu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tl.swish(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.swish(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lr_mul,activation", [(1.0, None),
                                               (0.01, "fused_lrelu")])
def test_equal_linear(rng, lr_mul, activation):
    x = f32(rng, 5, 24)
    jmod = jl.EqualLinear(16, lr_mul=lr_mul, activation=activation)
    v = np_vars(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    v["params"]["bias"] = f32(rng, 16, s=0.5)   # non-trivial bias
    mod = tl.EqualLinear(24, 16, lr_mul=lr_mul, activation=activation,
                         generator=gen())
    mod.load_state_dict({"weight": t(v["params"]["kernel"].T),
                         "bias": t(v["params"]["bias"])})
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    got = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pixel_norm(rng):
    x = f32(rng, 6, 32)
    want = np.asarray(jl.PixelNorm().apply({}, jnp.asarray(x)))
    got = tl.PixelNorm()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _col_mask(rng, b, w):
    lengths = rng.integers(1, w + 1, b)
    return (np.arange(w)[None, :] < lengths[:, None]).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_group_norm(rng, masked):
    x = f32(rng, 3, 5, 12, 64, s=2.0) + 0.5
    gamma, beta = f32(rng, 64, s=0.3) + 1.0, f32(rng, 64, s=0.2)
    mask = _col_mask(rng, 3, 12) if masked else None
    jmask = None if mask is None else jnp.asarray(mask[:, None, :, None])
    want = np.asarray(jl.group_norm(jnp.asarray(x), jnp.asarray(gamma),
                                    jnp.asarray(beta), 2, mask=jmask))
    tmask = None if mask is None else torch.from_numpy(mask[:, None, None])
    got = from_port(tl.group_norm(to_port(x), t(gamma), t(beta), 2,
                                  mask=tmask))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_group_norm_module_groups():
    assert tl.GroupNorm(64).num_groups == 2
    assert tl.GroupNorm(16).num_groups == 1   # one group below 32 channels


@pytest.mark.parametrize("stride", [1, 2])
def test_snconv(rng, stride):
    x = f32(rng, 2, 8, 10, 6)
    jmod = jl.SNConv(12, strides=(stride, stride))
    v = np_vars(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    v["params"]["bias"] = f32(rng, 12, s=0.1)
    # eval mode, as the JAX module (update_stats=False): stored u and v
    mod = tl.SNConv(6, 12, stride=stride, generator=gen()).eval()
    mod.load_state_dict(sn_conv_from_jax(v["params"], v["spectral"]))
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    got = from_port(mod(to_port(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_snconv_init_aligns_sigma():
    """15 power iterations at init bring sigma close to the top singular
    value (within 1%: a random u/v pair would give a far smaller sigma,
    which blows up the random-weight SR path)."""
    g = torch.Generator().manual_seed(3)
    mod = tl.SNConv(32, 48, generator=g)
    w_mat = mod.weight_orig.detach().reshape(48, -1)
    sigma = float(torch.dot(mod.weight_u, w_mat @ mod.weight_v))
    true_sigma = float(torch.linalg.svdvals(w_mat)[0])
    assert true_sigma * 0.99 <= sigma <= true_sigma * (1 + 1e-6)


def test_conv_1x1(rng):
    x = f32(rng, 2, 4, 7, 12)
    jmod = jl.Conv(8, kernel_size=(1, 1), padding="VALID")
    v = np_vars(jmod.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    v["params"]["bias"] = f32(rng, 8, s=0.1)
    mod = tl.Conv(12, 8, 1, generator=gen())
    mod.load_state_dict({
        "weight": t(np.transpose(v["params"]["kernel"], (3, 2, 0, 1))),
        "bias": t(v["params"]["bias"])})
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(from_port(mod(to_port(x))), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cin,cout,masked", [(32, 32, False),
                                             (64, 32, False),
                                             (64, 32, True)])
def test_res_text_block(rng, cin, cout, masked):
    x = f32(rng, 3, 6, 10, cin)
    mask = _col_mask(rng, 3, 10) if masked else None
    jmask = None if mask is None else jnp.asarray(mask[:, None, :, None])
    if mask is not None:
        x = x * mask[:, None, :, None]
    jmod = jl.ResTextBlockV2(cout)
    v = np_vars(jmod.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    mod = tl.ResTextBlockV2(cin, cout, generator=gen()).eval()  # as JAX
    mod.load_state_dict(res_block_from_jax(v["params"], v["spectral"]))
    want = np.asarray(jmod.apply(v, jnp.asarray(x), mask=jmask))
    tmask = None if mask is None else torch.from_numpy(mask[:, None, None])
    got = from_port(mod(to_port(x), mask=tmask))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_mean_std_and_adain(rng, masked):
    prior = f32(rng, 3, 5, 9, 16, s=1.5)
    lq = f32(rng, 3, 5, 9, 16) + 0.3
    mask = _col_mask(rng, 3, 9) if masked else None
    jmask = None if mask is None else jnp.asarray(mask[:, None, :, None])
    tmask = None if mask is None else torch.from_numpy(mask[:, None, None])
    jmean, jstd = jl.masked_mean_std(jnp.asarray(lq), jmask)
    mean, std = tl.masked_mean_std(to_port(lq), tmask)
    np.testing.assert_allclose(mean.numpy()[:, :, 0, 0],
                               np.asarray(jmean)[:, 0, 0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(std.numpy()[:, :, 0, 0],
                               np.asarray(jstd)[:, 0, 0], rtol=1e-4,
                               atol=1e-5)
    want = np.asarray(jl.adaptive_instance_norm(
        jnp.asarray(prior), jnp.asarray(lq), jmask, jmask))
    got = from_port(tl.adaptive_instance_norm(to_port(prior), to_port(lq),
                                              tmask, tmask))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# ops/resize.py and ops/modconv.py
# ---------------------------------------------------------------------------


def test_upsample2x_bilinear(rng):
    x = f32(rng, 2, 5, 7, 4)
    want = np.asarray(jr.upsample2x_bilinear(jnp.asarray(x)))
    got = from_port(tr.upsample2x_bilinear(to_port(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("upsample", [False, True])
def test_styled_conv(rng, upsample):
    x = f32(rng, 2, 4, 4, 16)
    style = f32(rng, 2, 32)
    jmod = jm.StyledConv(24, upsample=upsample)
    v = np_vars(jmod.init(jax.random.PRNGKey(6), jnp.asarray(x),
                          jnp.asarray(style)))
    v["params"]["bias"] = f32(rng, 24, s=0.1)
    v["params"]["act_bias"] = f32(rng, 24, s=0.1)
    mod = tm.StyledConv(16, 24, 32, upsample=upsample, generator=gen())
    mod.load_state_dict(modulated_from_jax(v["params"]))
    want = np.asarray(jmod.apply(v, jnp.asarray(x), jnp.asarray(style)))
    got = mod(to_port(x), torch.from_numpy(style))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(from_port(got), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("with_skip", [False, True])
def test_to_rgb(rng, with_skip):
    x = f32(rng, 2, 8, 8, 16)
    style = f32(rng, 2, 32)
    skip = f32(rng, 2, 4, 4, 3) if with_skip else None
    jmod = jm.ToRGB(upsample=True)
    jskip = None if skip is None else jnp.asarray(skip)
    v = np_vars(jmod.init(jax.random.PRNGKey(8), jnp.asarray(x),
                          jnp.asarray(style), jskip))
    v["params"]["bias"] = f32(rng, 3, s=0.1)
    mod = tm.ToRGB(16, 32, upsample=True, generator=gen())
    mod.load_state_dict(modulated_from_jax(v["params"]))
    want = np.asarray(jmod.apply(v, jnp.asarray(x), jnp.asarray(style),
                                 jskip))
    got = mod(to_port(x), torch.from_numpy(style),
              None if skip is None else to_port(skip))
    np.testing.assert_allclose(from_port(got), want, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# ops/window.py
# ---------------------------------------------------------------------------


def test_gather_windows(rng):
    canvas = f32(rng, 2, 3, 40, 5)
    # in range, at the right end, and past it (clamped as dynamic_slice)
    starts = np.array([[0, 13, 32, 39], [5, 31, 2, 20]], np.int32)
    want = np.asarray(jw.gather_windows(jnp.asarray(canvas),
                                        jnp.asarray(starts), 8))
    got = tw.gather_windows(torch.from_numpy(canvas),
                            torch.from_numpy(starts), 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_windows_per_slot(rng):
    t5 = f32(rng, 2, 4, 3, 24, 5)
    starts = np.array([[0, 7, 16, 20], [3, 12, 1, 16]], np.int32)
    want = np.asarray(jw.gather_windows_per_slot(jnp.asarray(t5),
                                                 jnp.asarray(starts), 8))
    got = tw.gather_windows_per_slot(torch.from_numpy(t5),
                                     torch.from_numpy(starts), 8).numpy()
    np.testing.assert_array_equal(got, want)
