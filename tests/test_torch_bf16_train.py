"""The port's bf16 training step against the JAX trainer's bf16 step.

The JAX package trains in bf16 compute over f32 parameters and optimizer
states (``MARCONetTrainer(dtype=jnp.bfloat16)``, the policy of
``tools/bench_train.py``); so does the port's
``MARCONetTrainer(dtype=torch.bfloat16)``. One JAX state at width 0.0625
with 4 slots is initialized once and carried into a port bf16 trainer with
``convert.trainer_from_jax``. Each side takes one step on the same numpy
batch (B=2, ``tests/train_fixtures.tiny_batch``) on the CPU:

- JAX bf16: the G phase's ``value_and_grad`` of ``_g_loss``, the D and
  SRD phases of ``train_step`` (``test_torch_train_step._d_phase_grads``,
  which that file holds to ``train_step``) and each net's optax update, as
  ``train_step`` applies them; run through
  ``test_torch_bf16.run_bf16_on_cpu`` (XLA:CPU cannot run the step's
  bf16 x bf16 -> f32 dots itself);
- JAX f32: the same program with an f32 trainer, jitted; the reference
  distance;
- the port: ``train_step`` of the bf16 trainer.

The bound is ``tests/test_torch_bf16.py``'s: the port's value may be at
most ``FACTOR`` = 2 times as far from JAX's bf16 value as JAX's bf16 value
is from JAX's f32 value, in max and in mean absolute difference, over the
vector of the 16 loss terms, over each net's gradient and over each net's
parameters after the Adam update. Parameters, gradients and Adam states
are f32 on both sides.

Each loss term alone is also held within ``TERM_RTOL`` = 0.1 of its f32
value plus ``TERM_ATOL`` = 1e-5: a check for a wrong or missing term, not
a bf16 bound. One batch is one draw of bf16's rounding, and the hinge
terms of the discriminators (outputs averaging near 0 at init, scaled by
0.02) move by 0.1-6 % of their value in either package's bf16: on this
batch JAX's bf16 ``l_g_gan`` lands 7e-7 from its f32 value, on three
other batches 1.4e-6 to 5.6e-5; the port's lands 2.7e-5 from JAX's bf16
one here (the largest term distance, 8.4 %, is ``l_sr_d_pr``'s 1.2e-5).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

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
from marconet_tpu_torch.train.train_step import (
    NETS,
    MARCONetTrainer,
    TrainBatch,
    TrainConfig,
)
from tests.test_torch_bf16 import run_bf16_on_cpu
from tests.test_torch_train_step import LOSS_KEYS, _d_phase_grads
from tests.torch_train_support import (  # noqa: F401  (cpu_convs: fixture)
    BATCH,
    SLOTS,
    WIDTH,
    cpu_convs,
)
from tests.train_fixtures import tiny_batch

torch.set_num_threads(2)

FACTOR = 2.0
TERM_RTOL, TERM_ATOL = 0.1, 1e-5
LOSS_NAMES = LOSS_KEYS + ("l_d", "l_srd")
G_NETS = ("encoder", "prior", "srnet")
D_NETS = ("net_d", "net_srd")
FROM_JAX = {"encoder": encoder_from_jax, "prior": prior_from_jax,
            "srnet": srnet_from_jax, "net_d": discriminator_from_jax,
            "net_srd": discriminator_from_jax}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_step(jtr):
    """(G-phase metrics, every net's gradient, the D / SRD losses, every
    net's parameters after its update) of one ``train_step`` of ``jtr``."""
    def step(state, batch):
        g_params = (state.encoder["params"], state.prior["params"],
                    state.srnet["params"])
        (_, aux), grads = jax.value_and_grad(jtr._g_loss, has_aux=True)(
            g_params, state, batch)
        d_phases = _d_phase_grads(jtr, state, aux, batch)
        grads = dict(zip(G_NETS, grads))
        new_params, losses = {}, dict(aux["metrics"])
        for name, params in zip(G_NETS, g_params):
            updates, _ = jtr.tx[name].update(grads[name], state.opt[name],
                                             params)
            new_params[name] = optax.apply_updates(params, updates)
        for name, key in zip(D_NETS, ("l_d", "l_srd")):
            losses[key], grads[name], new_params[name] = d_phases[name]
        return losses, grads, new_params

    return step


@pytest.fixture(scope="module")
def run():
    """(JAX f32, JAX bf16, port bf16) results from one starting state."""
    j32 = JaxTrainer(JaxConfig(), width=WIDTH, max_chars=SLOTS)
    jbf = JaxTrainer(JaxConfig(), dtype=jnp.bfloat16, width=WIDTH,
                     max_chars=SLOTS)
    char = jnp.zeros((1, 128, 128, 3))
    lpips = jax.jit(j32.lpips.init)(jax.random.PRNGKey(9), char, char)
    j32.lpips_variables = jbf.lpips_variables = lpips
    state = jax.jit(j32.init_state)(jax.random.PRNGKey(0))
    arrays = tiny_batch(np.random.default_rng(3), b=BATCH, n_chars=SLOTS)
    batch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})

    out32 = np_tree(jax.jit(_jax_step(j32))(state, batch))
    step_bf = _jax_step(jbf)
    flat = run_bf16_on_cpu(step_bf, state, batch)
    outbf = np_tree(jax.tree.unflatten(
        jax.tree.structure(jax.eval_shape(step_bf, state, batch)), flat))

    start = np_tree(state)
    trainer = MARCONetTrainer(TrainConfig(), device="cpu", seed=0,
                              width=WIDTH, max_chars=SLOTS,
                              allow_random_lpips=True, dtype=torch.bfloat16)
    trainer_from_jax(trainer, start, np_tree(lpips))
    metrics = trainer.train_step(TrainBatch.from_numpy(arrays, "cpu"))
    return dict(j32=out32, jbf=outbf, trainer=trainer, metrics=metrics,
                start=start, jax_opt_dtypes=_leaf_dtypes(
                    jax.eval_shape(jbf.train_step, state, batch)))


def _leaf_dtypes(tree) -> set:
    return {leaf.dtype for leaf in jax.tree.leaves(tree)
            if jnp.issubdtype(leaf.dtype, jnp.floating)}


def _within(got, jbf, j32, what):
    got, jbf, j32 = (np.asarray(a, np.float64).ravel()
                     for a in (got, jbf, j32))
    ref = np.abs(jbf - j32)
    for stat in (np.max, np.mean):
        bound = FACTOR * stat(ref)
        err = stat(np.abs(got - jbf))
        assert err <= bound, (what, stat.__name__, err, bound)


def _losses(run, side: str) -> np.ndarray:
    if side == "port":
        return np.array([float(run["metrics"][k]) for k in LOSS_NAMES])
    return np.array([float(run[side][0][k]) for k in LOSS_NAMES])


def test_loss_vector_matches_jax_bf16(run):
    got = _losses(run, "port")
    assert np.isfinite(got).all()
    _within(got, _losses(run, "jbf"), _losses(run, "j32"), "losses")


@pytest.mark.parametrize("key", LOSS_NAMES)
def test_loss_term_near_jax_bf16(run, key):
    got = float(run["metrics"][key])
    jbf, j32 = float(run["jbf"][0][key]), float(run["j32"][0][key])
    assert np.isfinite(got) and np.isfinite(jbf)
    assert abs(got - jbf) <= TERM_RTOL * abs(j32) + TERM_ATOL, \
        (key, got, jbf, j32)


def _by_port_name(run, side: str, what: int, net: str) -> dict:
    """JAX's gradient (``what`` 1) or updated parameters (2) of ``net``
    under the port's parameter names."""
    args = {"params": run[side][what][net]}
    if net in ("srnet",) + D_NETS:
        args["spectral"] = getattr(run["start"], net)["spectral"]
    return {k: v.numpy() for k, v in FROM_JAX[net](args).items()}


@pytest.mark.parametrize("net", NETS)
def test_gradients_match_jax_bf16(run, net):
    """Each net's ``.grad`` after the step (the G phase's for the encoder,
    prior and SR net; its own phase's for each discriminator)."""
    params = dict(run["trainer"].net(net).named_parameters())
    jbf = _by_port_name(run, "jbf", 1, net)
    j32 = _by_port_name(run, "j32", 1, net)
    keys = sorted(params)
    got = np.concatenate([params[k].grad.numpy().ravel() for k in keys])
    _within(got, np.concatenate([jbf[k].ravel() for k in keys]),
            np.concatenate([j32[k].ravel() for k in keys]), net)


@pytest.mark.parametrize("net", NETS)
def test_updated_parameters_match_jax_bf16(run, net):
    params = dict(run["trainer"].net(net).named_parameters())
    jbf = _by_port_name(run, "jbf", 2, net)
    j32 = _by_port_name(run, "j32", 2, net)
    keys = sorted(params)
    got = np.concatenate([params[k].detach().numpy().ravel()
                          for k in keys])
    _within(got, np.concatenate([jbf[k].ravel() for k in keys]),
            np.concatenate([j32[k].ravel() for k in keys]), net)


def test_state_stays_f32(run):
    """Parameters, gradients, Adam states and spectral vectors are f32 in
    the port's bf16 trainer, as in the JAX bf16 trainer's new state."""
    assert run["jax_opt_dtypes"] == {jnp.dtype(jnp.float32)}
    trainer = run["trainer"]
    for name in NETS:
        net = trainer.net(name)
        for k, p in net.named_parameters():
            assert p.dtype == torch.float32, f"{name}.{k}"
            assert p.grad is not None and p.grad.dtype == torch.float32, \
                f"{name}.{k}"
        for k, b in net.named_buffers():
            assert b.dtype == torch.float32, f"{name}.{k}"
        states = trainer.optimizers[name].state.values()
        assert states
        for st in states:
            for k in ("exp_avg", "exp_avg_sq"):
                assert st[k].dtype == torch.float32, (name, k)
    assert all(p.dtype == torch.float32
               for p in trainer.lpips.parameters())
    assert trainer.step == 1


def test_checkpoint_restores_into_f32_trainer(run, tmp_path):
    """A bf16 trainer's checkpoint (``train/checkpoint.py``) is an f32
    trainer's: restored into a fresh f32 trainer, every net tensor and
    Adam state is equal and f32, and the step carries over."""
    from marconet_tpu_torch.train import checkpoint

    trainer = run["trainer"]
    checkpoint.save_state(str(tmp_path), trainer)
    fresh = MARCONetTrainer(TrainConfig(), device="cpu", seed=1,
                            width=WIDTH, max_chars=SLOTS,
                            allow_random_lpips=True)
    checkpoint.restore_state(str(tmp_path), fresh)
    assert fresh.step == trainer.step
    for name in NETS:
        want = trainer.net(name).state_dict()
        for key, value in fresh.net(name).state_dict().items():
            assert value.dtype == torch.float32, f"{name}.{key}"
            assert torch.equal(value, want[key]), f"{name}.{key}"
        got = fresh.optimizers[name].state_dict()["state"]
        want = trainer.optimizers[name].state_dict()["state"]
        assert got.keys() == want.keys()
        for i in got:
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(got[i][key], want[i][key]), (name, key)


def test_visual_forward_runs_in_bf16(run):
    """The eval pass of the periodic grids computes in the trainer's
    dtype and leaves the nets' modes as they were."""
    trainer = run["trainer"]
    arrays = tiny_batch(np.random.default_rng(3), b=BATCH, n_chars=SLOTS)
    modes = [trainer.net(n).training for n in NETS]
    vis = trainer.visual_forward(TrainBatch.from_numpy(arrays, "cpu"))
    assert [trainer.net(n).training for n in NETS] == modes
    assert vis["sr"].dtype == vis["prior128"].dtype == torch.bfloat16
    assert tuple(vis["sr"].shape) == (BATCH, 128, 128 * SLOTS, 3)
    assert torch.isfinite(vis["sr"].float()).all()
