"""The port's training losses against ``marconet_tpu.train.losses``.

Each case makes its inputs with numpy from a seed, evaluates the JAX loss
and the port's on the CPU in f32, and compares the values (rtol 1e-5,
atol 1e-6: the same f32 arithmetic, reassociated) and the gradients with
respect to the prediction (same tolerance, scaled by the gradient's
largest entry; CTC's gradient rtol 1e-4, since both sides run their
log-space forward-backward recursions in their own order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from marconet_tpu.train import losses as JL
from marconet_tpu_torch.alphabet import BLANK_INDEX
from marconet_tpu_torch.train import losses as TL

torch.set_num_threads(1)


def _ctc_inputs(rng, classes, blank, t=16, s=4):
    logits = rng.standard_normal((3, t, classes)).astype(np.float32) * 2
    labels = np.full((3, s), blank, np.int64)
    labels[0, :3] = [1, 5, 2]
    labels[1, :4] = [7, 7, 3, 9]         # a repeat needs a blank between
    # row 2 is all blank: empty target, divided by max(len, 1)
    return (logits, labels), {"blank": blank}


def _pair(rng, shape=(2, 4, 6, 6, 3)):
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


def _mask(rng, shape=(2, 4, 1, 1, 1)):
    m = (rng.uniform(0, 1, shape) > 0.4).astype(np.float32)
    m.flat[0] = 1.0
    return m


def _cw(rng, n=5):
    c = rng.uniform(0.1, 0.9, (2, n)).astype(np.float32)
    w = rng.uniform(0.01, 0.08, (2, n)).astype(np.float32)
    return np.stack([c, w], -1).reshape(2, 2 * n)


# name -> (loss name, inputs from rng: (args, kwargs)); the first arg is
# the one differentiated
CASES = {
    "ctc_small_alphabet": ("ctc_loss",
                           lambda r: _ctc_inputs(r, 20, 19)),
    "ctc_full_alphabet": ("ctc_loss",
                          lambda r: _ctc_inputs(r, BLANK_INDEX + 1,
                                                BLANK_INDEX)),
    "text_ce": ("text_ce_loss", lambda r: (
        (r.standard_normal((2, 5, 10)).astype(np.float32),
         r.integers(0, 10, (2, 5))), {"num_classes": 10})),
    "l1": ("l1_loss", lambda r: (_pair(r), {"weight": 20.0})),
    "l1_masked": ("l1_loss", lambda r: (_pair(r) + (_mask(r),),
                                        {"weight": 10.0})),
    "smooth_l1": ("smooth_l1_loss", lambda r: (
        tuple(a * 3 for a in _pair(r, (4, 7))), {})),
    "smooth_l1_masked": ("smooth_l1_loss", lambda r: (
        tuple(a * 3 for a in _pair(r, (4, 7))) + (_mask(r, (4, 1)),), {})),
    "masked_mean": ("masked_mean", lambda r: (
        (_pair(r)[0], _mask(r)), {})),
    "hinge_g": ("hinge_g_loss", lambda r: ((_pair(r, (3, 5))[0],), {})),
    "hinge_g_masked": ("hinge_g_loss", lambda r: (
        (_pair(r, (2, 4, 9))[0], _mask(r, (2, 4, 1))), {})),
    "hinge_d": ("hinge_d_loss", lambda r: (_pair(r, (3, 5)), {})),
    "hinge_d_masked": ("hinge_d_loss", lambda r: (
        _pair(r, (2, 4, 9)) + (_mask(r, (2, 4, 1)), _mask(r, (2, 4, 1))),
        {})),
    "soft_iou": ("soft_iou_loss", lambda r: (_pair(r), {})),
    "soft_iou_masked": ("soft_iou_loss", lambda r: (
        _pair(r) + (_mask(r),), {})),
    "box_iou": ("box_iou_loss", lambda r: (
        (_cw(r), _cw(r), _mask(r, (2, 5))), {})),
    "lr_to_center_width": ("lr_to_center_width", lambda r: (
        (np.sort(r.uniform(0, 1, (2, 8)).astype(np.float32)),), {})),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_jax(case):
    name, make = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    args, kwargs = make(rng)
    jfn, tfn = getattr(JL, name), getattr(TL, name)

    want = np.asarray(jfn(*map(jnp.asarray, args), **kwargs))
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    targs[0].requires_grad_(targs[0].is_floating_point())
    got = tfn(*targs, **kwargs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)

    if not targs[0].requires_grad:
        return

    def jsum(x0):
        return jnp.sum(jfn(x0, *map(jnp.asarray, args[1:]), **kwargs))

    want_g = np.asarray(jax.grad(jsum)(jnp.asarray(args[0])))
    got.sum().backward()
    scale = max(np.abs(want_g).max(), 1e-12)
    rtol = 1e-4 if name == "ctc_loss" else 1e-5
    np.testing.assert_allclose(targs[0].grad.numpy(), want_g, rtol=rtol,
                               atol=1e-6 * scale)
