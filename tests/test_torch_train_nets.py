"""The port's discriminator, LPIPS and training-mode spectral norm against
the JAX package's, and the state-dict plumbing between them.

JAX modules are initialized at reduced width and exported with the port's
``*_from_jax``; both sides run the same numpy inputs on the CPU in f32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from marconet_tpu.convert.torch_import import convert_discriminator
from marconet_tpu.ops.layers import SNConv as JaxSNConv
from marconet_tpu.train.discriminators import UNetDiscriminatorSN as JaxDisc
from marconet_tpu.train.lpips import LPIPS as JaxLPIPS
from marconet_tpu.train.lpips import convert_lpips_weights
from marconet_tpu_torch.convert import discriminator_from_jax, lpips_from_jax
from marconet_tpu_torch.ops.layers import SNConv
from marconet_tpu_torch.train.discriminators import UNetDiscriminatorSN
from marconet_tpu_torch.train.lpips import (
    LPIPS,
    check_lpips_weights,
    load_lpips,
)
from tests.torch_train_support import WIDTH, cpu_convs  # noqa: F401

torch.set_num_threads(1)

DISC_FEAT = max(8, int(round(64 * WIDTH)))


def gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("in_ch", [3, 6])
def test_discriminator_matches_jax(in_ch):
    """Forward output (rtol 1e-4, atol 1e-5) and the input gradient
    (same, scaled by its largest entry), eval mode."""
    rng = np.random.default_rng(in_ch)
    x = rng.uniform(-1, 1, (2, 64, 64, in_ch)).astype(np.float32)
    jmod = JaxDisc(num_feat=DISC_FEAT)
    v = np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(in_ch),
                                   jnp.asarray(x)))

    def jsum(x):
        return (jmod.apply(v, x) ** 2).sum()

    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    want_g = np.asarray(jax.grad(jsum)(jnp.asarray(x)))

    net = UNetDiscriminatorSN(in_ch, DISC_FEAT, generator=gen()).eval()
    net.load_state_dict(discriminator_from_jax(v), strict=True)
    xt = nchw(x).requires_grad_()
    out = net(xt)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                               want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        xt.grad.permute(0, 2, 3, 1).numpy(), want_g, rtol=1e-4,
        atol=1e-5 * np.abs(want_g).max())


def test_discriminator_from_jax_inverts_convert():
    rng = np.random.default_rng(0)
    net = UNetDiscriminatorSN(6, DISC_FEAT, generator=gen(1))
    sd = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in net.state_dict().items()}
    back = discriminator_from_jax(convert_discriminator(dict(sd)))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_lpips_matches_jax():
    """Distances (rtol 1e-4, atol 1e-6) and the prediction's gradient."""
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    jmod = JaxLPIPS(width=WIDTH)
    v = np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(2), jnp.asarray(a),
                                   jnp.asarray(b)))
    want = np.asarray(jmod.apply(v, jnp.asarray(a), jnp.asarray(b)))
    want_g = np.asarray(jax.grad(lambda x: jmod.apply(
        v, x, jnp.asarray(b)).sum())(jnp.asarray(a)))

    lp = LPIPS(WIDTH, generator=gen())
    lp.load_state_dict(lpips_from_jax(v), strict=True)
    at = nchw(a).requires_grad_()
    got = lp(at, nchw(b))
    got.sum().backward()
    assert not any(p.requires_grad for p in lp.parameters())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(
        at.grad.permute(0, 2, 3, 1).numpy(), want_g, rtol=1e-4,
        atol=1e-4 * np.abs(want_g).max())


def _fake_lpips_files(tmp_path, rng):
    """torchvision-style VGG16 (``features.*`` plus a classifier entry)
    and lpips-style lin heads, random, at full width."""
    full = LPIPS(1.0, generator=gen())
    vgg = {k: torch.from_numpy(rng.standard_normal(v.shape)
                               .astype(np.float32))
           for k, v in full.state_dict().items() if k.startswith("features")}
    lin = {k: torch.from_numpy(rng.standard_normal(v.shape)
                               .astype(np.float32))
           for k, v in full.state_dict().items() if k.startswith("lin")}
    torch.save({**vgg, "classifier.0.weight": torch.zeros(2, 2)},
               tmp_path / "vgg16-397923af.pth")
    torch.save(lin, tmp_path / "vgg.pth")
    return vgg, lin


def test_lpips_loader_and_refusal(tmp_path):
    """The loader reads torchvision's and lpips's state dicts straight
    into the module (the same as the JAX package's converter gives), and
    returns None without them; a random VGG is refused unless allowed."""
    rng = np.random.default_rng(6)
    lp = LPIPS(1.0, generator=gen(1))
    assert load_lpips(lp, str(tmp_path)) is None
    assert load_lpips(lp, None) is None
    vgg, lin = _fake_lpips_files(tmp_path, rng)
    assert load_lpips(lp, str(tmp_path)) is lp
    for k, v in {**vgg, **lin}.items():
        torch.testing.assert_close(lp.state_dict()[k], v, rtol=0, atol=0)
    jvars = convert_lpips_weights({k: v.numpy() for k, v in vgg.items()},
                                  {k: v.numpy() for k, v in lin.items()})
    for k, v in lpips_from_jax(jvars).items():
        torch.testing.assert_close(lp.state_dict()[k], v, rtol=0, atol=0)

    with pytest.raises(ValueError, match="random-VGG"):
        check_lpips_weights(False, allow_random=False)
    check_lpips_weights(False, allow_random=True)
    check_lpips_weights(True, allow_random=False)


@pytest.mark.parametrize("k,stride,pad,bias", [(3, 1, 1, True),
                                               (4, 2, 1, False)])
def test_snconv_training_mode_matches_jax(k, stride, pad, bias):
    """Training mode against JAX ``update_stats=True``: u, v (atol 1e-6 on
    unit vectors) and the output (rtol 1e-5, atol 1e-5) after one and two
    forwards; eval mode then leaves u and v where they are."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    jmod = JaxSNConv(6, kernel_size=(k, k), strides=(stride, stride),
                     padding=((pad, pad), (pad, pad)), use_bias=bias,
                     update_stats=True)
    v = jax.jit(jmod.init)(jax.random.PRNGKey(k), jnp.asarray(x))
    if bias:   # a nonzero bias, so it shows in the output
        v = {**v, "params": {**v["params"], "bias": jnp.asarray(
            rng.standard_normal(6).astype(np.float32))}}

    conv = SNConv(5, 6, k, stride=stride, padding=pad, bias=bias,
                  generator=gen()).train()
    sd = {"weight_orig": torch.from_numpy(np.transpose(
              np.asarray(v["params"]["kernel"]), (3, 2, 0, 1)).copy()),
          "weight_u": torch.from_numpy(np.array(v["spectral"]["u"])),
          "weight_v": torch.from_numpy(np.array(v["spectral"]["v"]))}
    if bias:
        sd["bias"] = torch.from_numpy(np.array(v["params"]["bias"]))
    conv.load_state_dict(sd, strict=True)

    spectral = v["spectral"]
    for _ in range(2):
        want, upd = jmod.apply({"params": v["params"], "spectral": spectral},
                               jnp.asarray(x), mutable=["spectral"])
        spectral = upd["spectral"]
        got = conv(nchw(x))
        np.testing.assert_allclose(conv.weight_u.numpy(),
                                   np.asarray(spectral["u"]), atol=1e-6)
        np.testing.assert_allclose(conv.weight_v.numpy(),
                                   np.asarray(spectral["v"]), atol=1e-6)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
    u = conv.weight_u.clone()
    conv.eval()(nchw(x))
    torch.testing.assert_close(conv.weight_u, u, rtol=0, atol=0)
