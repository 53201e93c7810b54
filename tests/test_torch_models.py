"""The port's three networks against the JAX package's, and the state-dict
plumbing between them.

- Encoder, prior generator and SR net at ``width=0.0625``: one JAX init
  of the three (``MARCONet.init``) is exported with ``*_from_jax`` and
  loaded strictly into the port, and both run the same numpy inputs on the
  CPU in f32. Tolerances are those of the matching ``tests/test_convert.py``
  end-to-end cases.
- At full width, the reference-keyed state dicts that
  ``tests/torch_functional_oracle.build_*_state`` fabricate load strictly
  (no forward pass), the parameter counts match the reference's, and
  ``*_from_jax`` inverts ``marconet_tpu.convert.convert_*`` exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from marconet_tpu.convert import convert_encoder, convert_prior, convert_srnet
from marconet_tpu.models import (
    StructurePriorGenerator as JaxPrior,
    StructurePriorSRNet as JaxSRNet,
    TextContextEncoder as JaxEncoder,
)
from marconet_tpu.models.pipeline import MARCONet as JaxMARCONet
from marconet_tpu_torch.convert import (
    encoder_from_jax,
    load_reference_pth,
    prior_from_jax,
    srnet_from_jax,
)
from marconet_tpu_torch.models.encoder import TextContextEncoder
from marconet_tpu_torch.models.prior import StructurePriorGenerator
from marconet_tpu_torch.models.srnet import StructurePriorSRNet
from tests import torch_functional_oracle as oracle

torch.set_num_threads(1)

WIDTH = 0.0625


def gen(seed: int = 0) -> torch.Generator:
    """The explicit generator every port constructor takes."""
    return torch.Generator().manual_seed(seed)

def np_vars(variables):
    return jax.tree.map(np.asarray, variables)


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().numpy()


def n_params(module) -> int:
    return sum(p.numel() for p in module.parameters())


# ---------------------------------------------------------------------------
# reduced width, against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_vars():
    """One jitted JAX init of all three nets at reduced width, as numpy."""
    params = jax.jit(JaxMARCONet(width=WIDTH).init)(jax.random.PRNGKey(5))
    return np_vars(params)


def test_encoder_matches_jax(jax_vars):
    rng = np.random.default_rng(21)
    lq = rng.uniform(-1, 1, (2, 32, 512, 3)).astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(JaxEncoder(width=WIDTH).apply)(
        jax_vars.encoder, jnp.asarray(lq))]

    enc = TextContextEncoder(width=WIDTH, generator=gen())
    enc.load_state_dict(encoder_from_jax(jax_vars.encoder), strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(lq).permute(0, 3, 1, 2))
    tols = ((2e-3, 2e-3), (2e-3, 2e-4), (2e-3, 2e-3))  # logits, locs, w
    for name, g, w, (rtol, atol) in zip(("logits", "locs", "w"), got, want,
                                        tols):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol,
                                   err_msg=name)


def test_prior_matches_jax(jax_vars):
    rng = np.random.default_rng(22)
    styles = rng.standard_normal((3, 32)).astype(np.float32)
    labels = np.array([1, 17, 6735], np.int32)
    want = jax.jit(JaxPrior(width=WIDTH, style_dim=32).apply)(
        jax_vars.prior, jnp.asarray(styles), jnp.asarray(labels))

    prior = StructurePriorGenerator(style_dim=32, width=WIDTH,
                                    generator=gen())
    prior.load_state_dict(prior_from_jax(jax_vars.prior), strict=True)
    with torch.no_grad():
        got = prior(torch.from_numpy(styles),
                    torch.from_numpy(labels).long())
    # image / rgb: rtol 1e-3, atol 2e-3; features: rtol 1e-3, atol 2e-2
    # (test_prior_conversion_end_to_end)
    for name in ("image", "rgb64", "rgb32", "feat64", "feat32"):
        atol = 2e-2 if name.startswith("feat") else 2e-3
        np.testing.assert_allclose(nhwc(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-3, atol=atol, err_msg=name)


def test_srnet_matches_jax(jax_vars):
    rng = np.random.default_rng(23)
    n = 16
    lq = rng.uniform(-1, 1, (1, 32, 512, 3)).astype(np.float32)
    p64 = (rng.standard_normal((1, n, 64, 64, 16)) * 0.3).astype(np.float32)
    p32 = (rng.standard_normal((1, n, 32, 32, 32)) * 0.3).astype(np.float32)
    locs = np.zeros((1, 2 * n), np.float32)
    locs[0, 0:8:2] = [0.1, 0.35, 0.62, 0.9]
    locs[0, 1::2] = 0.03
    mask = np.zeros((1, n), np.float32)
    mask[0, :4] = 1.0
    args = (lq, p64, p32, locs, mask)
    want = np.asarray(jax.jit(JaxSRNet(dim=16).apply)(
        jax_vars.srnet, *map(jnp.asarray, args)))

    # eval mode, as the JAX net (update_stats=False): stored u and v
    net = StructurePriorSRNet(dim=16, prior_channels=32,
                              generator=gen()).eval()
    net.load_state_dict(srnet_from_jax(jax_vars.srnet), strict=True)

    def flat(p):    # (1, N, H, W, C) -> (N, C, H, W) channels_last
        return torch.from_numpy(p[0]).permute(0, 3, 1, 2)

    with torch.no_grad():
        got = net(torch.from_numpy(lq).permute(0, 3, 1, 2), flat(p64),
                  flat(p32), torch.from_numpy(locs), torch.from_numpy(mask))
    assert got.shape == (1, 3, 128, 2048)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# full width: strict loads, parameter counts, round trips
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_states():
    rng = np.random.default_rng(0)
    return {"encoder": oracle.build_encoder_state(rng),
            "prior": oracle.build_prior_state(rng, num_classes=64),
            "srnet": oracle.build_srnet_state(rng)}


def _strict_load(module, sd):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                           strict=True)
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_encoder_full_width_loads_reference_state(ref_states):
    enc = TextContextEncoder(generator=gen())
    # the JAX encoder holds the same 43,062,275 (its test checks 43.06 M)
    assert n_params(enc) == 43_062_275
    _strict_load(enc, ref_states["encoder"])


def test_prior_full_width_loads_reference_state(ref_states):
    gen_params = n_params(StructurePriorGenerator(generator=gen()))
    assert abs(gen_params / 1e6 - 27.97) < 0.01
    _strict_load(StructurePriorGenerator(num_classes=64, generator=gen()),
                 ref_states["prior"])


def test_srnet_full_width_loads_reference_state(ref_states):
    net = StructurePriorSRNet(generator=gen())
    assert abs(n_params(net) / 1e6 - 16.87) < 0.01
    _strict_load(net, ref_states["srnet"])


@pytest.mark.parametrize("net,convert,from_jax", [
    ("encoder", convert_encoder, encoder_from_jax),
    ("prior", convert_prior, prior_from_jax),
    ("srnet", convert_srnet, srnet_from_jax),
])
def test_from_jax_inverts_convert(ref_states, net, convert, from_jax):
    sd = ref_states[net]
    back = from_jax(convert(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert tuple(back[k].shape) == v.shape, k
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_load_reference_pth_is_strict(ref_states, tmp_path):
    """A released checkpoint's container (``{"params": state_dict}``) loads
    strictly; an extra or a missing key raises."""
    sd = {k: torch.from_numpy(v) for k, v in ref_states["srnet"].items()}
    path = tmp_path / "net_sr.pth"
    torch.save({"params": sd}, path)
    net = load_reference_pth(StructurePriorSRNet(generator=gen()), str(path))
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)

    torch.save({"params": {**sd, "conv_extra.weight": torch.zeros(1)}},
               path)
    with pytest.raises(RuntimeError):
        load_reference_pth(StructurePriorSRNet(generator=gen()), str(path))
    torch.save({"params_ema": {k: v for k, v in sd.items()
                               if k != "conv_final.6.bias"}}, path)
    with pytest.raises(RuntimeError):
        load_reference_pth(StructurePriorSRNet(generator=gen()), str(path))
