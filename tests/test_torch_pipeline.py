"""The port's ``MARCONet.restore`` against the JAX package's, end to end.

Both sides hold the same weights: a JAX init at ``width=0.0625`` is
exported with ``marconet_tpu_torch.convert.*_from_jax`` and loaded into
the port with a strict ``load_state_dict``. Inputs are made with numpy
from a seed; everything runs on the CPU in f32, where the port's kernel
wrappers take their plain versions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from marconet_tpu.models.pipeline import MARCONet as JaxMARCONet
from marconet_tpu_torch.convert import (
    encoder_from_jax,
    prior_from_jax,
    srnet_from_jax,
)
from marconet_tpu_torch.models.pipeline import MARCONet

torch.set_num_threads(1)

WIDTH = 0.0625


@pytest.fixture(scope="module")
def nets():
    jnet = JaxMARCONet(width=WIDTH)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(7))
    as_np = jax.tree.map(np.asarray, params)
    net = MARCONet(width=WIDTH, device="cpu")
    net.encoder.load_state_dict(encoder_from_jax(as_np.encoder),
                                strict=True)
    net.prior.load_state_dict(prior_from_jax(as_np.prior), strict=True)
    net.srnet.load_state_dict(srnet_from_jax(as_np.srnet), strict=True)
    return jnet, params, net


def _inputs(n_valid: int, batch: int = 2, slots: int = 16):
    rng = np.random.default_rng(n_valid * 100 + slots)
    lq = rng.uniform(-1, 1, (batch, 32, 512, 3)).astype(np.float32)
    labels = rng.integers(0, 6735, (batch, slots)).astype(np.int32)
    locs = np.zeros((batch, 2 * slots), np.float32)
    # spread centers with overlap and both truncated edges
    locs[:, 0::2] = np.linspace(0.005, 0.995, slots)
    locs[:, 1::2] = 0.03
    mask = np.zeros((batch, slots), np.float32)
    mask[:, :n_valid] = 1.0
    return lq, labels, locs, mask


@pytest.mark.parametrize("slots,n_valid", [(16, 3), (16, 16), (8, 8)])
def test_restore_matches_jax(nets, slots, n_valid):
    """All five outputs, for 16 and 8 slots. Tolerances: sr, priors and w
    those of ``tests/test_convert.py::test_full_pipeline_chain_matches_torch``
    (rtol 2e-3; atol 5e-3, 5e-3, 2e-3); logits and locs those of
    ``test_encoder_conversion_end_to_end`` (rtol 2e-3; atol 2e-3, 2e-4)."""
    jnet, params, net = nets
    lq, labels, locs, mask = _inputs(n_valid, slots=slots)
    want = jnet.restore(params, *map(jnp.asarray, (lq, labels, locs, mask)))
    got = net.restore(*map(torch.from_numpy, (lq, labels, locs, mask)))

    assert got.sr.shape == (2, 128, 2048, 3)
    assert got.priors.shape == (2, slots, 128, 128, 3)
    tol = {"sr": (2e-3, 5e-3), "priors": (2e-3, 5e-3),
           "logits": (2e-3, 2e-3), "pred_locs": (2e-3, 2e-4),
           "w": (2e-3, 2e-3)}
    for name, (rtol, atol) in tol.items():
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=rtol, atol=atol, err_msg=name)


def test_default_device_is_cuda():
    """With no device named the pipeline runs on CUDA; without a card it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MARCONet(width=WIDTH)


def test_restore_checks_inputs(nets):
    _, _, net = nets
    lq, labels, locs, mask = map(torch.from_numpy, _inputs(3))
    with pytest.raises(ValueError):
        net.restore(lq[:, :16], labels, locs, mask)
    with pytest.raises(ValueError):
        net.restore(lq, torch.cat([labels, labels], 1), locs, mask)
