"""Gradients of the port's ops against ``jax.grad`` of the JAX package's.

- K1 / K1b: ``fused_leaky_relu`` (the autograd Function, which on CPU
  tensors runs both plain twins) against ``jax.grad`` of
  ``marconet_tpu.ops.fused_leaky_relu``, in ``x`` and the bias, 2-D and
  channels_last 4-D.
- K2 backward: the write-back's plain backward inside ``sft_fusion``
  against ``jax.grad`` of the JAX ``SFTFusion`` (whose training path
  differentiates its XLA write-back), in the canvas, the priors and every
  parameter, on the three center sets of ``tests/test_torch_sft.py``.
- The plain backward against an independent numpy routing of the
  cotangent, at overlapping, truncated and invalid slots.
- ``resample2tap``, ``gather_windows`` / ``gather_windows_per_slot`` and
  ``resize_bilinear``: forward and input gradient against the JAX ops
  (custom VJPs / ``jax.image.resize``).
Everything on the CPU in f32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from marconet_tpu.models import srnet as jsrnet
from marconet_tpu.ops import fused_leaky_relu as jax_fused_lrelu
from marconet_tpu.ops import window as jwin
from marconet_tpu_torch.convert import res_block_from_jax, sn_stack_from_jax
from marconet_tpu_torch.models import srnet as tsrnet
from marconet_tpu_torch.ops import layers as tl
from marconet_tpu_torch.ops import window as twin
from marconet_tpu_torch.ops.fused_act import fused_leaky_relu
from marconet_tpu_torch.ops.resize import resize_bilinear
from marconet_tpu_torch.ops.sft_writeback import (
    sft_writeback,
    sft_writeback_bwd_plain,
)

torch.set_num_threads(1)


def gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("shape", [(37, 16), (2, 9, 7, 16)])
def test_fused_leaky_relu_grad_matches_jax(shape):
    """dx, db and the forward: rtol 1e-6, atol 1e-6 (db: a sum over rows,
    rtol 1e-5)."""
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)   # NHWC for 4-D
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)

    def jloss(x, b):
        return (jax_fused_lrelu(x, b) * cot).sum()

    jy = np.asarray(jax_fused_lrelu(jnp.asarray(x), jnp.asarray(b)))
    jdx, jdb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(b))

    def to_port(a):   # NHWC -> NCHW channels_last view
        t = torch.from_numpy(a)
        return t.permute(0, 3, 1, 2) if t.dim() == 4 else t

    def to_jax(t):
        return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()

    xt = to_port(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = fused_leaky_relu(xt, bt)
    (y * to_port(cot)).sum().backward()
    np.testing.assert_allclose(to_jax(y.detach()), jy, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_jax(xt.grad), np.asarray(jdx), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jdb), rtol=1e-5,
                               atol=1e-5)


def test_writeback_backward_plain_routes_to_winner():
    """d res = g at the winning slot's window column, 0 elsewhere (numpy
    reference of last-valid-writer-wins); exact."""
    rng = np.random.default_rng(3)
    b, s, h, w, c, win = 2, 6, 3, 40, 5, 8
    x1 = rng.integers(-2, w + 2, (b, s)).astype(np.int32)
    length = rng.integers(-1, win + 2, (b, s)).astype(np.int32)
    valid = rng.integers(0, 2, (b, s)).astype(np.int32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    want = np.zeros((b, s, h, win, c), np.float32)
    for i in range(b):
        for x in range(w):
            winner = -1
            for k in range(s):
                lk = min(max(length[i, k], 0), win)
                if valid[i, k] > 0 and x1[i, k] <= x < x1[i, k] + lk:
                    winner = k
            if winner >= 0:
                want[i, winner, :, x - x1[i, winner]] = g[i, :, x]
    got = sft_writeback_bwd_plain(*map(torch.from_numpy,
                                       (g, x1, length, valid)), win)
    np.testing.assert_array_equal(got.numpy(), want)

    canvas = torch.zeros(b, h, w, c, requires_grad=True)
    res = torch.zeros(b, s, h, win, c, requires_grad=True)
    sft_writeback(canvas, res, *map(torch.from_numpy,
                                    (x1, length, valid))).backward(
        torch.from_numpy(g))
    np.testing.assert_array_equal(res.grad.numpy(), want)
    np.testing.assert_array_equal(canvas.grad.numpy(), g)


CENTER_SETS = {
    "interior": [0.1, 0.35, 0.62, 0.9],
    "truncated_edges": [0.01, 0.5, 0.99],
    "overlap": [0.3, 0.317, 0.335, 0.36],
}


@pytest.fixture(scope="module")
def sft_setup():
    """JAX SFTFusion at C=16 in training mode and the port's modules."""
    c, hw, h, width, n = 16, 16, 16, 256, 16
    rng = np.random.default_rng(13)
    canvas = jnp.asarray(rng.standard_normal((1, h, width, c)) * 0.3,
                         jnp.float32)
    priors = jnp.asarray(rng.standard_normal((1, n, h, 2 * hw, c)) * 0.3,
                         jnp.float32)
    v = jax.tree.map(np.asarray, jsrnet.SFTFusion(
        half_width=hw, features=c).init(
            jax.random.PRNGKey(3), canvas, priors,
            jnp.zeros((1, 2 * n)), jnp.ones((1, n))))
    return v, (c, hw, h, width, n)


@pytest.mark.parametrize("case", sorted(CENTER_SETS))
def test_sft_fusion_grad_matches_jax(sft_setup, case):
    """Gradients through the write-back's backward, in training mode:
    canvas and prior gradients and every parameter's, relative L2 under
    1e-3 each (masked GroupNorm / AdaIN statistics in f32)."""
    v, (c, hw, h, width, n) = sft_setup
    rng = np.random.default_rng(14)
    canvas = (rng.standard_normal((1, h, width, c)) * 0.3).astype(np.float32)
    priors = (rng.standard_normal((1, n, h, 2 * hw, c)) * 0.3
              ).astype(np.float32)
    cot = rng.standard_normal((1, h, width, c)).astype(np.float32)
    centers = CENTER_SETS[case]
    locs = np.zeros((1, 2 * n), np.float32)
    locs[0, 0:2 * len(centers):2] = centers
    locs[0, 1::2] = 0.03
    mask = np.zeros((1, n), np.float32)
    mask[0, :len(centers)] = 1.0

    jmod = jsrnet.SFTFusion(half_width=hw, features=c, update_stats=True)

    def jloss(params, canvas, priors):
        out, _ = jmod.apply({"params": params, "spectral": v["spectral"]},
                            canvas, priors, jnp.asarray(locs),
                            jnp.asarray(mask), mutable=["spectral"])
        return (out * cot).sum()

    gp, gc, gpr = jax.grad(jloss, argnums=(0, 1, 2))(
        v["params"], jnp.asarray(canvas), jnp.asarray(priors))
    gp = jax.tree.map(np.asarray, gp)

    p, s = v["params"], v["spectral"]
    fuse = tl.ResTextBlockV2(2 * c, c, generator=gen())
    fuse.load_state_dict(res_block_from_jax(p["fuse"], s["fuse"]))
    scale, shift = (tsrnet.SNStack(c, c, generator=gen()),
                    tsrnet.SNStack(c, c, generator=gen()))
    scale.load_state_dict(sn_stack_from_jax(p["scale"], s["scale"]))
    shift.load_state_dict(sn_stack_from_jax(p["shift"], s["shift"]))
    for m in (fuse, scale, shift):
        m.train()
    canvas_t = torch.from_numpy(canvas).permute(0, 3, 1, 2).requires_grad_()
    priors_t = torch.from_numpy(priors.reshape(n, h, 2 * hw, c)).permute(
        0, 3, 1, 2).requires_grad_()
    out = tsrnet.sft_fusion(canvas_t, priors_t, torch.from_numpy(locs),
                            torch.from_numpy(mask), half_width=hw,
                            fuse=fuse, scale=scale, shift=shift)
    (out.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()

    def rel(got, want):
        return np.linalg.norm(got - want) / np.linalg.norm(want)

    assert rel(canvas_t.grad.permute(0, 2, 3, 1).numpy(),
               np.asarray(gc)) < 1e-3
    assert rel(priors_t.grad.permute(0, 2, 3, 1).numpy(),
               np.asarray(gpr).reshape(n, h, 2 * hw, c)) < 1e-3
    for name, mod, jp in (("fuse", fuse, gp["fuse"]),
                          ("scale", scale, gp["scale"]),
                          ("shift", shift, gp["shift"])):
        want = (res_block_from_jax if name == "fuse" else
                sn_stack_from_jax)(jp, s[name])
        for k, prm in mod.named_parameters():
            w = want[k].numpy()
            if np.linalg.norm(w) > 1e-6:     # AdaIN cancels some exactly
                assert rel(prm.grad.numpy(), w) < 1e-3, f"{name}.{k}"


def test_resample2tap_matches_jax():
    """Forward and the image gradient: rtol 1e-6, atol 1e-6; the edge
    crops take the 2-tap path, interior ones copy."""
    from marconet_tpu.data.batch_prep import _crop_taps

    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 6, 512, 3)).astype(np.float32)
    taps = [_crop_taps(cx, width=512) for cx in (30, 200, 250, 500)]
    idx = np.stack([t[0] for t in taps]).reshape(2, 2, 128)
    w0 = np.stack([t[1] for t in taps]).reshape(2, 2, 128)
    cot = rng.standard_normal((2, 2, 6, 128, 3)).astype(np.float32)

    def jloss(img):
        return (jwin.resample2tap(img, jnp.asarray(idx), jnp.asarray(w0))
                * cot).sum()

    want = np.asarray(jwin.resample2tap(*map(jnp.asarray, (img, idx, w0))))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(img)))
    imt = torch.from_numpy(img).requires_grad_()
    got = twin.resample2tap(imt, torch.from_numpy(idx), torch.from_numpy(w0))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(imt.grad.numpy(), want_g, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("per_slot", [False, True])
def test_gather_windows_grad_matches_jax(per_slot):
    """Forward exact; gradient (overlapping windows add) rtol 1e-6."""
    rng = np.random.default_rng(5 + per_slot)
    b, n, h, wp, c, win = 2, 5, 3, 48, 4, 16
    starts = rng.integers(0, wp - win + 1, (b, n)).astype(np.int32)
    starts[0, :2] = [3, 5]                        # overlap
    shape = (b, n, h, wp, c) if per_slot else (b, h, wp, c)
    x = rng.standard_normal(shape).astype(np.float32)
    cot = rng.standard_normal((b, n, h, win, c)).astype(np.float32)
    jfn = jwin.gather_windows_per_slot if per_slot else jwin.gather_windows
    tfn = twin.gather_windows_per_slot if per_slot else twin.gather_windows

    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(starts), win))
    want_g = np.asarray(jax.grad(lambda x: (jfn(
        x, jnp.asarray(starts), win) * cot).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = tfn(xt, torch.from_numpy(starts), win)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("size", [64, 32])
def test_resize_bilinear_matches_jax_image_resize(size):
    """``jax.image.resize(..., "bilinear")`` antialiases when shrinking:
    forward and gradient, rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(size)
    x = rng.uniform(-1, 1, (3, 128, 128, 3)).astype(np.float32)
    cot = rng.standard_normal((3, size, size, 3)).astype(np.float32)

    def jresize(x):
        return jax.image.resize(x, (3, size, size, 3), method="bilinear")

    want = np.asarray(jresize(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda x: (jresize(x) * cot).sum())(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = resize_bilinear(xt, (size, size))
    (got.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), want_g,
                               rtol=1e-5, atol=1e-6)
