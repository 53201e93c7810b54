"""The port trainer's state: optimizers against optax, freeze groups,
checkpoint resume, the eval pass and the entry point's checks.

- Optimizer: the encoder's Adam, under a freeze group and a milestone
  schedule, against the JAX trainer's optax transform on the same
  gradients for three updates (rtol 1e-6, atol 1e-9: the same f32 Adam
  arithmetic in another order).
- Checkpoint resume: two steps in a row equal one step, save, load into a
  trainer built from another seed, one step (exact on the CPU).
Everything on the CPU in f32 at width 0.0625 with 4 slots.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from marconet_tpu.convert import convert_encoder
from marconet_tpu.train.train_step import MARCONetTrainer as JaxTrainer
from marconet_tpu.train.train_step import TrainConfig as JaxConfig
from marconet_tpu_torch.convert import encoder_from_jax
from marconet_tpu_torch.train import checkpoint
from marconet_tpu_torch.train.train_step import (
    NETS,
    MARCONetTrainer,
    TrainBatch,
    TrainConfig,
)
from tests.torch_train_support import (  # noqa: F401  (cpu_convs: fixture)
    BATCH,
    SLOTS,
    WIDTH,
    cpu_convs,
    port_trainer,
)
from tests.train_fixtures import tiny_batch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch():
    return TrainBatch.from_numpy(
        tiny_batch(np.random.default_rng(4), b=BATCH, n_chars=SLOTS), "cpu")


def test_encoder_optimizer_matches_optax():
    """Three updates with milestones at 1 and 2 (the rate halves before
    the second and the third) and ``encoder.cls`` frozen: the port's
    parameters follow optax's; frozen ones never move."""
    cfg = dict(milestones=(1, 2), freeze=("encoder.cls",))
    trainer = port_trainer(TrainConfig(**cfg))
    jtx = JaxTrainer(JaxConfig(**cfg), width=WIDTH,
                     max_chars=SLOTS).tx["encoder"]
    start = {k: v.numpy().copy()
             for k, v in trainer.encoder.state_dict().items()}
    params = jax.tree.map(jnp.asarray, convert_encoder(start)["params"])
    opt_state = jtx.init(params)
    rng = np.random.default_rng(0)
    for step in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32) * 10.0 ** rng.integers(-9, 1)),
            params)
        updates, opt_state = jtx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        port_grads = encoder_from_jax({"params": jax.tree.map(np.asarray,
                                                              grads)})
        for k, p in trainer.encoder.named_parameters():
            p.grad = port_grads[k].clone()
        trainer.step = step
        trainer._update("encoder")
    want = encoder_from_jax({"params": jax.tree.map(np.asarray, params)})
    frozen = moved = 0
    for k, p in trainer.encoder.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        if k.startswith(("transformer.transformer.layers_cls.",
                         "transformer.linear_cls.")):
            frozen += 1
            np.testing.assert_array_equal(p.detach().numpy(), start[k])
        else:
            moved += int(not np.array_equal(p.detach().numpy(), start[k]))
    assert frozen > 0 and moved > 0


def test_frozen_nets_and_groups_never_move(batch):
    trainer = port_trainer(TrainConfig(freeze=("prior", "encoder.resnet")))
    assert trainer.optimizers["prior"] is None
    before = {n: {k: v.clone() for k, v in trainer.net(n).state_dict()
                  .items()} for n in ("prior", "encoder")}
    trainer.train_step(batch)
    for k, v in trainer.prior.state_dict().items():
        torch.testing.assert_close(v, before["prior"][k], rtol=0, atol=0)
    moved = 0
    for k, v in trainer.encoder.state_dict().items():
        if k.startswith("resnet."):
            torch.testing.assert_close(v, before["encoder"][k], rtol=0,
                                       atol=0)
        else:
            moved += int(not torch.equal(v, before["encoder"][k]))
    assert moved > 0


def test_unknown_freeze_group_raises():
    with pytest.raises(ValueError, match="unknown freeze group"):
        port_trainer(TrainConfig(freeze=("encoder.nope",)))


def test_random_lpips_is_refused_unless_allowed():
    with pytest.raises(ValueError, match="random-VGG"):
        MARCONetTrainer(TrainConfig(), device="cpu", width=WIDTH,
                        max_chars=SLOTS)


def test_default_device_is_cuda():
    """No device named: CUDA, and without a card a refusal, never a
    silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MARCONetTrainer(TrainConfig(), width=WIDTH, max_chars=SLOTS,
                        allow_random_lpips=True)


def _assert_same_state(a: MARCONetTrainer, b: MARCONetTrainer):
    assert a.step == b.step
    for n in NETS:
        sa, sb = a.net(n).state_dict(), b.net(n).state_dict()
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0,
                                       msg=f"{n}.{k}")
        oa, ob = a.optimizers[n].state_dict(), b.optimizers[n].state_dict()
        for i, st in oa["state"].items():
            for k, v in st.items():
                torch.testing.assert_close(v, ob["state"][i][k], rtol=0,
                                           atol=0)


def test_checkpoint_resume(batch, tmp_path):
    """Two steps equal one step, save, load (into a trainer built from
    another seed), one step: nets, spectral buffers, optimizer states and
    the step count. ``max_to_keep`` drops the oldest files."""
    straight = port_trainer()
    straight.train_step(batch)
    straight.train_step(batch)

    first = port_trainer()
    first.train_step(batch)
    d = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(d) is None
    checkpoint.save_state(d, first)
    resumed = port_trainer(seed=1)
    # LPIPS is no training state (its weights are the pretrained files'):
    # the random stand-in of another seed is copied over
    resumed.lpips.load_state_dict(first.lpips.state_dict())
    checkpoint.restore_state(d, resumed)
    _assert_same_state(first, resumed)
    resumed.train_step(batch)
    _assert_same_state(straight, resumed)

    for _ in range(3):
        resumed.step += 1
        checkpoint.save_state(d, resumed, max_to_keep=2)
    assert checkpoint.latest_step(d) == 5
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["step_4.pt", "step_5.pt"]
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_state(str(tmp_path / "none"), resumed)


def test_visual_forward(batch):
    """Eval pass shapes; the SR net's spectral vectors do not move and the
    nets' modes are restored."""
    trainer = port_trainer()
    u = trainer.srnet.conv_first_32[0].weight_u.clone()
    vis = trainer.visual_forward(batch)
    n = SLOTS
    assert vis["sr"].shape == (BATCH, 128, 128 * n, 3)
    assert vis["prior128"].shape == (BATCH, n, 128, 128, 3)
    assert vis["pred_cw"].shape == (BATCH, 2 * n)
    assert vis["pred_ids"].shape == (BATCH, 4 * n)
    torch.testing.assert_close(trainer.srnet.conv_first_32[0].weight_u, u,
                               rtol=0, atol=0)
    assert trainer.srnet.training
