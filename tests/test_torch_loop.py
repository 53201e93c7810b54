"""The port's training driver (``marconet_tpu_torch/train/loop.py`` and
``cli/train.py``), in the manner of ``tests/test_loop.py``: batches from
spawned workers (a seeded glyph renderer stands in for the font pack,
``tests/torch_synth_support.py``), two steps of ``train()`` at width
0.0625 with 4 slots on the CPU, the event file's tags and the checkpoint,
resume, the LPIPS refusal, ``train()`` against the same batches through
``MARCONetTrainer.train_step`` bit for bit, the warm start from released
``.pth`` files, and the CLI."""

import os
import pathlib

import numpy as np
import pytest
import torch

from marconet_tpu_torch.cli import train as cli_train
from marconet_tpu_torch.train import checkpoint as ckpt
from marconet_tpu_torch.train import events
from marconet_tpu_torch.train.config import FullConfig, LoopConfig
from marconet_tpu_torch.train.discriminators import UNetDiscriminatorSN
from marconet_tpu_torch.train.loop import (
    WARM_START_FILES,
    BatchLoader,
    train,
    warm_start,
)
from marconet_tpu_torch.train.train_step import (
    NETS,
    MARCONetTrainer,
    TrainBatch,
    TrainConfig,
    lr_at,
)
from tests.torch_synth_support import stroke_synthesizer
from tests.torch_train_support import (  # noqa: F401
    BATCH,
    SLOTS,
    WIDTH,
    cpu_convs,
)

TAGS = ("losses/l_g_total", "losses/l_d", "losses/l_srd",
        "speed/samples_per_sec", "speed/data_wait_ms", "val/1_gt_sr_lq",
        "val/2_pred_locs", "val/3_char_gt", "val/3_char_prior",
        "val/1_pred_text")


def _config(tmp_path, **loop_kw) -> FullConfig:
    kw = dict(name="smoke", num_workers=1, batch_size=BATCH, print_freq=1,
              save_freq=2, val_freq=2, allow_random_lpips=True,
              experiments_root=str(tmp_path))
    kw.update(loop_kw)
    return FullConfig(train=TrainConfig(width=WIDTH, max_chars=SLOTS),
                      loop=LoopConfig(**kw))


def _direct_batches(loop: LoopConfig, n: int, worker: int = 0):
    """The batches worker ``worker`` makes, synthesized in this process."""
    synth = stroke_synthesizer()
    rng = np.random.default_rng(loop.seed + 1000 + worker)
    return [synth.batch(loop.batch_size, rng, max_chars=SLOTS)
            for _ in range(n)]


def _same_batch(a, b) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def _states_equal(a: MARCONetTrainer, b: MARCONetTrainer) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"]
    for n in NETS:
        for k, v in sa["nets"][n].items():
            assert torch.equal(v, sb["nets"][n][k]), (n, k)
        for k, st in sa["optimizers"][n]["state"].items():
            for name, v in st.items():
                assert torch.equal(v, sb["optimizers"][n]["state"][k][name]),\
                    (n, k, name)


def test_batch_loader_through_spawn_workers(tmp_path):
    """Two spawned workers, seeds ``seed + 1000 + i``: every batch is the
    next one of one worker's own sequence."""
    loop = _config(tmp_path, num_workers=2).loop
    loader = BatchLoader(loop, BATCH, prefetch=2, max_chars=SLOTS,
                         synth_factory=stroke_synthesizer)
    expected = {0: _direct_batches(loop, 4, 0),
                1: _direct_batches(loop, 4, 1)}
    taken = {0: 0, 1: 0}
    try:
        batches = iter(loader)
        for _ in range(4):
            batch = next(batches)
            assert batch["lq"].shape == (BATCH, 32, 32 * SLOTS, 3)
            assert batch["gt_chars"].shape == (BATCH, SLOTS, 128, 128, 3)
            assert np.isfinite(batch["lq"]).all()
            worker = next(w for w in (0, 1)
                          if _same_batch(batch, expected[w][taken[w]]))
            taken[worker] += 1
    finally:
        loader.close()
    assert not any(p.is_alive() for p in loader.procs)


def test_batch_loader_reports_a_failed_worker(tmp_path):
    """The default synthesizer has no glyph renderer: the worker's error
    reaches the consumer, naming what is missing."""
    loader = BatchLoader(_config(tmp_path).loop, BATCH, max_chars=SLOTS)
    try:
        with pytest.raises(RuntimeError, match="font pack"):
            next(iter(loader))
    finally:
        loader.close()


def test_train_driver_end_to_end(tmp_path):
    """Two steps: the event file (read back with its CRCs) holds the loss
    and speed scalars and the val grids and text; a checkpoint of step 2;
    a resumed run continues to step 3 with the same learning rates."""
    config = _config(tmp_path)
    trainer = train(config, max_steps=2, device="cpu",
                    synth_factory=stroke_synthesizer)
    assert trainer.step == 2
    run_dir = os.path.join(str(tmp_path), "smoke")
    files = events.event_files(os.path.join(run_dir, "tb"))
    assert len(files) == 1
    evs = events.read_events(files[0])
    assert evs[0]["file_version"] == "brain.Event:2"
    tags = {v[0] for e in evs for v in e["values"]}
    assert set(TAGS) <= tags
    assert [s for s, _ in events.scalars(os.path.join(run_dir, "tb"),
                                         "losses/l_g_total")] == [1, 2]
    text = [v[2] for e in evs for v in e["values"]
            if v[0] == "val/1_pred_text"]
    assert len(text) == 1 and isinstance(text[0], str)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    assert ckpt.latest_step(ckpt_dir) == 2

    resume = _config(tmp_path, resume_state=ckpt_dir)
    resumed = train(resume, max_steps=3, device="cpu",
                    synth_factory=stroke_synthesizer)
    assert resumed.step == 3
    cfg = resume.train
    for name, opt in resumed.optimizers.items():
        want = lr_at(resumed.base_lr[name], 2, cfg.milestones, cfg.lr_gamma)
        assert [g["lr"] for g in opt.param_groups] == [want]
    assert len(events.event_files(os.path.join(run_dir, "tb"))) == 2


@pytest.fixture
def deterministic():
    """The backward of an advanced-indexing gather (the char crops, the
    SFT windows) accumulates with ``index_put_``, which on several CPU
    threads adds in no fixed order: two runs of one step differ in the
    last bits. PyTorch's deterministic mode sorts those adds."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def test_train_equals_direct_steps(tmp_path, deterministic):
    """``train()`` over two batches (with a val pass after each) leaves the
    trainer state of the same two batches through ``train_step``, bit for
    bit: the loop adds nothing to the step."""
    config = _config(tmp_path, val_freq=1, save_freq=100)
    looped = train(config, max_steps=2, device="cpu",
                   synth_factory=stroke_synthesizer)
    direct = MARCONetTrainer(config.train, device="cpu",
                             seed=config.loop.seed, allow_random_lpips=True)
    for raw in _direct_batches(config.loop, 2):
        direct.train_step(TrainBatch.from_numpy(raw, "cpu"))
    _states_equal(looped, direct)


def test_train_refuses_random_lpips(tmp_path):
    config = _config(tmp_path, allow_random_lpips=False)
    with pytest.raises(SystemExit, match="LPIPS"):
        train(config, max_steps=1, device="cpu",
              synth_factory=stroke_synthesizer)


def test_warm_start_from_reference_files(tmp_path, capsys):
    """Full width: the three released nets under the reference's key
    names (``tests/torch_functional_oracle``, container ``params_ema``)
    and the discriminators' own state dicts (``params``) load strictly;
    a missing file keeps the random init."""
    from tests import torch_functional_oracle as oracle

    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(5)
    states = {"encoder": oracle.build_encoder_state(rng),
              "prior": oracle.build_prior_state(rng),
              "srnet": oracle.build_srnet_state(rng),
              "net_d": UNetDiscriminatorSN(3, 64, generator=gen)
              .state_dict()}
    for name, fname, key in WARM_START_FILES:
        if name in states:
            sd = {k: torch.as_tensor(np.asarray(v))
                  for k, v in states[name].items()}
            torch.save({key: sd}, tmp_path / fname)
    trainer = MARCONetTrainer(device="cpu", allow_random_lpips=True)
    srd_before = {k: v.clone() for k, v in
                  trainer.net_srd.state_dict().items()}
    warm_start(trainer, str(tmp_path))
    for name, sd in states.items():
        for k, v in trainer.net(name).state_dict().items():
            assert torch.equal(v, torch.as_tensor(np.asarray(sd[k]))), \
                (name, k)
    for k, v in trainer.net_srd.state_dict().items():
        assert torch.equal(v, srd_before[k]), k
    out = capsys.readouterr().out
    assert "warm start: net_srd.pth not found, keeping random init" in out


def test_cli_parser_keeps_the_jax_flags():
    args = cli_train.build_parser().parse_args([])
    assert (args.options, args.max_steps, args.allow_random_lpips,
            args.device) == ("options/train.yml", None, False, "cuda")
    args = cli_train.build_parser().parse_args(
        ["-opt", "x.yml", "--max_steps", "3", "--allow_random_lpips",
         "--device", "cpu"])
    assert (args.options, args.max_steps, args.allow_random_lpips,
            args.device) == ("x.yml", 3, True, "cpu")


def test_cli_refuses_without_allow_random_lpips(tmp_path, monkeypatch):
    """Without the LPIPS files the CLI stops unless ``--allow_random_lpips``
    is given; with it, the default synthesizer stops at the first batch
    naming the missing glyph renderer and font pack."""
    text = pathlib.Path("options/train.yml").read_text().replace(
        "  net_g_reg_every: 4",
        f"  net_g_reg_every: 4\n  model_width: {WIDTH}\n"
        f"  model_max_chars: {SLOTS}")
    path = tmp_path / "tiny.yml"
    path.write_text(text)
    monkeypatch.chdir(tmp_path)
    argv = ["-opt", str(path), "--max_steps", "1", "--device", "cpu"]
    with pytest.raises(SystemExit, match="LPIPS"):
        cli_train.main(argv)
    with pytest.raises(RuntimeError, match="font pack"):
        cli_train.main(argv + ["--allow_random_lpips"])
