"""The port's three-phase training step against the JAX trainer's.

One JAX ``MARCONetTrainer`` at width 0.0625 with 4 slots is initialized
once; its ``TrainState`` (and LPIPS variables) is carried into a port
trainer with ``convert.trainer_from_jax``, so both start from identical
weights. Both then run one step on the same numpy batch (B=2, made by the
JAX package's ``tests/train_fixtures.tiny_batch``) on the CPU in f32; the
JAX side also returns ``jax.value_and_grad(trainer._g_loss)`` at the
starting state and the gradients of the D and SRD losses of
``train_step`` (one jitted program for all, shared by every test here).
The port's gradients are the ``.grad`` its step leaves on each net: the G
phase's on the encoder, prior and SR net, the D and SRD phases' on the
two discriminators.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from marconet_tpu.train import losses as JL
from marconet_tpu.train.train_step import (
    MARCONetTrainer as JaxTrainer,
    TrainBatch as JaxBatch,
    TrainConfig as JaxConfig,
)
from marconet_tpu_torch.convert import (
    discriminator_from_jax,
    encoder_from_jax,
    prior_from_jax,
    srnet_from_jax,
    trainer_from_jax,
)
from marconet_tpu_torch.train.train_step import NETS, TrainBatch
from tests.torch_train_support import (  # noqa: F401  (cpu_convs: fixture)
    BATCH,
    SLOTS,
    WIDTH,
    cpu_convs,
    port_trainer,
)
from tests.train_fixtures import tiny_batch

torch.set_num_threads(1)

G_NETS = ("encoder", "prior", "srnet")
FROM_JAX = {"encoder": encoder_from_jax, "prior": prior_from_jax,
            "srnet": srnet_from_jax, "net_d": discriminator_from_jax,
            "net_srd": discriminator_from_jax}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


D_NETS = ("net_d", "net_srd")


def _d_phase_grads(jtr, state, aux, batch):
    """value_and_grad of ``train_step``'s D and SRD losses at ``state``
    (its ``d_loss`` / ``srd_loss``: fake then real forward, each advancing
    u / v, hinge loss), and the parameters one Adam update of each gives."""
    b, n = batch.lq.shape[0], jtr.max_chars
    cmask3 = batch.char_valid[:, :, None]
    pairs = {"net_d": (aux["sr_chars"], aux["gt_chars_rgb"]),
             "net_srd": (
                 jnp.concatenate([aux["sr_chars"], aux["prior128"]], -1),
                 jnp.concatenate([aux["gt_chars_rgb"], batch.gt_chars], -1))}
    out = {}
    for name, (fake_in, real_in) in pairs.items():
        def loss(params, spectral, fake_in=fake_in, real_in=real_in):
            dnet = jtr._make_disc(update_stats=True)
            c = fake_in.shape[-1]
            fake, upd = dnet.apply(
                {"params": params, "spectral": spectral},
                fake_in.reshape(b * n, 128, 128, c), mutable=["spectral"])
            real, _ = dnet.apply(
                {"params": params, "spectral": upd["spectral"]},
                real_in.reshape(b * n, 128, 128, c), mutable=["spectral"])
            return JL.hinge_d_loss(real.reshape(b, n, -1),
                                   fake.reshape(b, n, -1),
                                   real_mask=cmask3, fake_mask=cmask3)

        net = getattr(state, name)
        value, grads = jax.value_and_grad(loss)(net["params"],
                                                net["spectral"])
        updates, _ = jtr.tx[name].update(grads, state.opt[name],
                                         net["params"])
        out[name] = (value, grads, optax.apply_updates(net["params"],
                                                       updates))
    return out


@pytest.fixture(scope="module")
def run():
    """(JAX results, port trainer after one step, port metrics, start)."""
    jtr = JaxTrainer(JaxConfig(), width=WIDTH, max_chars=SLOTS)
    char = jnp.zeros((1, 128, 128, 3))
    jtr.lpips_variables = jax.jit(jtr.lpips.init)(jax.random.PRNGKey(9),
                                                  char, char)
    state = jax.jit(jtr.init_state)(jax.random.PRNGKey(0))
    arrays = tiny_batch(np.random.default_rng(3), b=BATCH, n_chars=SLOTS)
    batch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})

    @jax.jit
    def step(state, batch):
        g_params = (state.encoder["params"], state.prior["params"],
                    state.srnet["params"])
        (_, aux), grads = jax.value_and_grad(jtr._g_loss, has_aux=True)(
            g_params, state, batch)
        d_phases = _d_phase_grads(jtr, state, aux, batch)
        new_state, metrics = jtr.train_step(state, batch)
        return aux["metrics"], grads, d_phases, new_state, metrics

    g_metrics, grads, d_phases, new_state, metrics = np_tree(
        step(state, batch))
    start = np_tree(state)

    trainer = port_trainer()
    trainer_from_jax(trainer, start, np_tree(jtr.lpips_variables))
    port_metrics = trainer.train_step(TrainBatch.from_numpy(arrays, "cpu"))
    grads = dict(zip(G_NETS, grads))
    grads.update({name: d_phases[name][1] for name in D_NETS})
    jax_out = dict(g_metrics=g_metrics, grads=grads, d_phases=d_phases,
                   new_state=new_state, metrics=metrics)
    return jax_out, trainer, port_metrics, start


def _flat(sd, keys):
    return np.concatenate([np.asarray(sd[k]).ravel() for k in keys])


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


LOSS_KEYS = ("l_ctc", "l_loc_center", "l_loc", "l_loc_iou", "l_g_pix128",
             "l_g_iou128", "l_g_pix64", "l_g_pix32", "l_g_gan", "l_sr_pix",
             "l_sr_d_pr", "l_sr_d_r", "l_sr_percep", "l_g_total")


@pytest.mark.parametrize("key", LOSS_KEYS + ("l_d", "l_srd"))
def test_loss_terms_match_jax(run, key):
    """Every loss term of the three phases; rtol 1e-4, atol 1e-5 (f32
    forward through five nets, float reassociation only)."""
    jax_out, _, port_metrics, _ = run
    want = jax_out["metrics"][key]
    if key in LOSS_KEYS:     # the G terms also match value_and_grad's
        np.testing.assert_allclose(jax_out["g_metrics"][key], want,
                                   rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(port_metrics[key]), want, rtol=1e-4,
                               atol=1e-5, err_msg=key)


# relative L2 tolerance of each net's gradient. The SR net's is looser:
# its masked GroupNorm / AdaIN statistics (E[x^2] - E[x]^2 in f32) make its
# f32 gradient sensitive to summation order (about 3e-3 from JAX's here,
# most in the early convs behind both SFT scales).
GRAD_RTOL = {"encoder": 1e-3, "prior": 1e-3, "srnet": 1e-2, "net_d": 1e-3,
             "net_srd": 1e-3}


def _jax_grads(jax_out, start, net: str) -> dict:
    """JAX's gradient of ``net`` under the port's parameter names."""
    args = {"params": jax_out["grads"][net]}
    if net in ("srnet",) + D_NETS:
        args["spectral"] = getattr(start, net)["spectral"]
    return FROM_JAX[net](args)


def _check_grads(run, net: str) -> None:
    """Relative L2 norm of the difference under ``GRAD_RTOL`` over the
    whole net, and per tensor within ``GRAD_RTOL`` times the net's largest
    gradient entry."""
    jax_out, trainer, _, start = run
    want = _jax_grads(jax_out, start, net)
    got = {k: p.grad for k, p in trainer.net(net).named_parameters()}
    keys = sorted(got)
    assert set(keys) <= set(want)
    for k in keys:
        assert got[k] is not None, f"{net}.{k} got no gradient"
    g = _flat({k: got[k].numpy() for k in keys}, keys)
    w = _flat({k: want[k].numpy() for k in keys}, keys)
    assert np.abs(w).max() > 0
    tol = GRAD_RTOL[net]
    assert rel_l2(g, w) < tol, (net, rel_l2(g, w))
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max())


@pytest.mark.parametrize("net", G_NETS)
def test_g_phase_gradients_match_jax(run, net):
    """Each G net's gradient (``_check_grads``)."""
    _check_grads(run, net)


@pytest.mark.parametrize("net", D_NETS)
def test_d_phase_gradients_match_jax(run, net):
    """Each discriminator's gradient from its own phase, against
    ``jax.grad`` of the JAX step's D / SRD loss (``_check_grads``)."""
    _check_grads(run, net)


@pytest.mark.parametrize("net", D_NETS)
def test_jax_d_phase_reference_is_train_step(run, net):
    """The D / SRD losses differentiated here are the JAX step's own: same
    loss value (rtol 1e-6) and, after one Adam update, the same
    parameters (atol 1e-9)."""
    jax_out, _, _, _ = run
    value, _, params = jax_out["d_phases"][net]
    key = {"net_d": "l_d", "net_srd": "l_srd"}[net]
    np.testing.assert_allclose(value, jax_out["metrics"][key], rtol=1e-6)
    want = getattr(jax_out["new_state"], net)["params"]
    for got, w in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-9)


def _lr(net: str) -> float:
    cfg = JaxConfig()
    g_ratio = cfg.g_reg_every / (cfg.g_reg_every + 1)
    d_ratio = cfg.d_reg_every / (cfg.d_reg_every + 1)
    return {"encoder": cfg.lr_encoder * g_ratio, "prior": cfg.lr_g * g_ratio,
            "srnet": cfg.lr_sr * g_ratio, "net_d": cfg.lr_d * d_ratio,
            "net_srd": cfg.lr_srd * d_ratio}[net]


@pytest.mark.parametrize("net", NETS)
def test_updated_parameters_match_jax(run, net):
    """After one step every parameter equals JAX's. Adam with b1 = 0 moves
    an entry by lr * g / (|g| + eps), about lr * sign(g) where |g| >> eps.
    Where JAX's gradient exceeds 100 eps and ten times the port's
    difference from it (so both have the same sign), the entry agrees
    within 1e-2 lr plus one f32 ulp of its value: a wrong sign, a missing
    loss term or a wrong rate moves it by about lr. That holds for at
    least 90% of the entries with a gradient above 100 eps; every entry
    agrees within 2 lr + 1e-6 (a gradient near 0 may differ in sign by
    rounding). Every tensor with such a gradient moved (a discriminator's
    output bias has none at the first step: the hinge terms of real and
    fake outputs inside (-1, 1) cancel)."""
    jax_out, trainer, _, start = run
    want = FROM_JAX[net](getattr(jax_out["new_state"], net))
    before = FROM_JAX[net](getattr(start, net))
    grads = _jax_grads(jax_out, start, net)
    lr = _lr(net)
    n_live = n_tight = 0
    for k, p in trainer.net(net).named_parameters():
        got, w = p.detach().numpy(), want[k].numpy()
        err = np.abs(got - w)
        g = grads[k].numpy()
        live = np.abs(g) > 100 * 1e-8
        tight = live & (np.abs(g) > 10 * np.abs(p.grad.numpy() - g))
        limit = 1e-2 * lr + np.spacing(np.abs(w))
        assert (err[tight] <= limit[tight]).all(), \
            f"{net}.{k}: {err[tight].max()} > 1e-2 lr = {1e-2 * lr}"
        np.testing.assert_allclose(got, w, rtol=0, atol=2 * lr + 1e-6,
                                   err_msg=f"{net}.{k}")
        if live.any():
            assert not torch.equal(p.detach(), before[k]), \
                f"{net}.{k} did not move"
        n_live += int(live.sum())
        n_tight += int(tight.sum())
    assert n_tight >= 0.9 * n_live, (net, n_tight, n_live)


@pytest.mark.parametrize("net", ("srnet", "net_d", "net_srd"))
def test_spectral_vectors_match_jax(run, net):
    """u and v after the step (one power iteration for the SR net in
    phase G, two for each discriminator in its phase; the discriminators'
    eval-mode use in phase G moves nothing): atol 1e-5 on unit vectors."""
    jax_out, trainer, _, start = run
    want = FROM_JAX[net](getattr(jax_out["new_state"], net))
    before = FROM_JAX[net](getattr(start, net))
    got = trainer.net(net).state_dict()
    keys = [k for k in got if k.endswith(("weight_u", "weight_v"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=f"{net}.{k}")
        assert not torch.equal(got[k], before[k]), f"{net}.{k} did not move"


def test_step_count_and_finite(run):
    _, trainer, port_metrics, _ = run
    assert trainer.step == 1
    for k, v in port_metrics.items():
        assert bool(torch.isfinite(v)), k
