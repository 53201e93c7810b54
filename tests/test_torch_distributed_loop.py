"""The port's data-parallel wiring on the CPU: ``parallel/distributed.py``
(process group from arguments or the environment, gradient buckets,
summed losses, state broadcast), ``train()`` under two spawned gloo ranks
(rank 0 alone writes events and checkpoints; both ranks resume; the speed
tag counts the global batch; a ``num_gpu`` other than the world size is
refused naming both numbers) and ``python -m marconet_tpu_torch.dryrun``.
Ranks rendezvous through a file under the test's ``tmp_path``, so that
concurrent test workers cannot collide on a port."""

import itertools
import multiprocessing as mp
import os
import queue
import socket
import traceback
import types

import numpy as np
import pytest
import torch

from marconet_tpu_torch import dryrun
from marconet_tpu_torch.parallel import distributed
from marconet_tpu_torch.train import checkpoint as ckpt
from marconet_tpu_torch.train import events
from marconet_tpu_torch.train.config import FullConfig, LoopConfig
from marconet_tpu_torch.train.train_step import NETS, TrainConfig
from tests.torch_synth_support import stroke_synthesizer
from tests.torch_train_support import BATCH, SLOTS, WIDTH

WORLD = 2
RANK_TIMEOUT_S = 240.0


def _config(root: str, **loop_kw) -> FullConfig:
    kw = dict(name="dp", num_workers=1, batch_size=BATCH, print_freq=1,
              save_freq=1, val_freq=1, allow_random_lpips=True,
              experiments_root=root, num_devices=WORLD)
    kw.update(loop_kw)
    return FullConfig(train=TrainConfig(width=WIDTH, max_chars=SLOTS),
                      loop=LoopConfig(**kw))


def _spawn(target, tmp_path, *args) -> list:
    """Run ``target(rank, init_method, *args, out_q)`` on ``WORLD`` spawned
    ranks; each puts (rank, result) or (rank, traceback)."""
    ctx = mp.get_context("spawn")
    init = "file://" + str(tmp_path / "rendezvous")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, init) + args + (out_q,))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < WORLD:
            try:
                rank, out = out_q.get(timeout=RANK_TIMEOUT_S)
            except queue.Empty:
                raise AssertionError(f"ranks {sorted(results)} of {WORLD} "
                                     "reported in time") from None
            assert not isinstance(out, str), f"rank {rank}:\n{out}"
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(WORLD)]


def _join(rank: int, init: str) -> None:
    distributed.maybe_initialize(init, WORLD, rank, backend="gloo",
                                 device="cpu")


# ---------------------------------------------------------------------------
# rank bodies (module level: spawned processes import them)
# ---------------------------------------------------------------------------


def _collectives_rank(rank, init, out_q):
    try:
        _join(rank, init)
        try:
            gen = torch.Generator().manual_seed(rank)
            net = torch.nn.Sequential(torch.nn.Linear(5, 7),
                                      torch.nn.Linear(7, 3))
            with torch.no_grad():
                for p in net.parameters():
                    p.normal_(generator=gen)
            distributed.broadcast_module_state(net)
            params = list(net.parameters())
            for i, p in enumerate(params[:-1]):   # the last: no gradient
                p.grad = torch.full_like(p, float(rank + 1) * (i + 1))
            calls = distributed.all_reduce_grads(params, bucket_mb=0)
            metrics = distributed.all_reduce_metrics(
                {"a": torch.tensor(float(rank + 1)),
                 "b": torch.tensor(10.0 * rank)})
            out = {"state": {k: v.numpy() for k, v in
                             net.state_dict().items()},
                   "grads": [None if p.grad is None else p.grad.numpy()
                             for p in params],
                   "calls": calls,
                   "metrics": {k: float(v) for k, v in metrics.items()},
                   "slice": distributed.local_batch_slice(
                       {"x": np.arange(8)}, 8)["x"].tolist(),
                   "world": distributed.world_size(),
                   "rank": distributed.rank()}
        finally:
            distributed.shutdown()
        out_q.put((rank, out))
    except BaseException:
        out_q.put((rank, traceback.format_exc()))


def _loop_rank(rank, init, root, out_q):
    from marconet_tpu_torch.train import loop

    try:
        # a clock that advances 1 s a reading: the loop reads it three
        # times a step (wait start, wait end, the print), so at print_freq
        # 1 a step takes 3 s and samples/s is the counted batch over 3
        loop.time = types.SimpleNamespace(
            perf_counter=itertools.count().__next__)
        torch.set_num_threads(2)
        _join(rank, init)
        out = {}
        try:
            with torch.backends.mkldnn.flags(enabled=False):
                try:
                    loop.train(_config(root, num_devices=4), max_steps=2,
                               device="cpu",
                               synth_factory=stroke_synthesizer)
                except ValueError as e:
                    out["refused"] = str(e)
                first = loop.train(_config(root), max_steps=1, device="cpu",
                                   synth_factory=stroke_synthesizer)
                out["first_step"] = first.step
                ckpt_dir = os.path.join(root, "dp", "checkpoints")
                resumed = loop.train(_config(root, resume_state=ckpt_dir),
                                     max_steps=2, device="cpu",
                                     synth_factory=stroke_synthesizer)
            out["step"] = resumed.step
            out["state"] = {n: {k: v.numpy() for k, v in
                                resumed.net(n).state_dict().items()}
                            for n in NETS}
            out["group_kept"] = distributed.world_size() == WORLD
        finally:
            distributed.shutdown()
        out_q.put((rank, out))
    except BaseException:
        out_q.put((rank, traceback.format_exc()))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_collectives_on_two_ranks(tmp_path):
    """Rank 0's parameters reach rank 1; the gradients are summed in one
    ``all_reduce`` a bucket (here a bucket a tensor) and a parameter
    without a gradient is left alone; the losses are summed; each rank
    takes its own contiguous rows."""
    a, b = _spawn(_collectives_rank, tmp_path)
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k])
    for out in (a, b):
        assert (out["world"], out["calls"]) == (WORLD, 3)
        for i, g in enumerate(out["grads"][:-1]):
            np.testing.assert_array_equal(g, np.full_like(g, 3.0 * (i + 1)))
        assert out["grads"][-1] is None
        assert out["metrics"] == {"a": 3.0, "b": 10.0}
    assert (a["rank"], a["slice"]) == (0, [0, 1, 2, 3])
    assert (b["rank"], b["slice"]) == (1, [4, 5, 6, 7])


def test_train_on_two_ranks(tmp_path):
    """``train()`` under two gloo ranks (a group the caller started, which
    it keeps): ``num_gpu`` 4 refused naming 4 and 2; one step, then a
    resume to step 2 on both ranks with equal nets; one event file a run
    (rank 0's) whose speed tag counts the global batch of 4; a checkpoint
    a step, each written once."""
    root = str(tmp_path / "runs")
    a, b = _spawn(_loop_rank, tmp_path, root)
    for out in (a, b):
        assert out["refused"].startswith("num_gpu 4 but the world size is "
                                         "2"), out["refused"]
        assert (out["first_step"], out["step"]) == (1, 2)
        assert out["group_kept"]
    for n in NETS:
        for k, v in a["state"][n].items():
            np.testing.assert_array_equal(v, b["state"][n][k],
                                          err_msg=f"{n}.{k}")
    run_dir = os.path.join(root, "dp")
    tb = os.path.join(run_dir, "tb")
    assert len(events.event_files(tb)) == 2        # rank 0, two runs
    assert [s for s, _ in events.scalars(tb, "losses/l_g_total")] == [1, 2]
    rates = [v for _, v in events.scalars(tb, "speed/samples_per_sec")]
    np.testing.assert_allclose(rates, [WORLD * BATCH / 3.0] * 2, rtol=1e-6)
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == \
        ["step_1.pt", "step_2.pt"]
    assert ckpt.latest_step(os.path.join(run_dir, "checkpoints")) == 2


def test_dryrun_on_two_ranks(capsys):
    """``python -m marconet_tpu_torch.dryrun 2``: two ranks against one
    process (raises on any difference beyond rtol 1e-5)."""
    metrics = dryrun.dryrun_multichip(2)
    assert set(metrics) >= {"l_g_total", "l_d", "l_srd"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert "dryrun_multichip(2) OK" in capsys.readouterr().out


def test_one_process_needs_no_group(monkeypatch):
    """Without arguments or launch variables: no group, world size 1, and
    every collective helper a no-op."""
    for var in ("MARCONET_COORDINATOR", "MARCONET_NUM_PROCS",
                "MARCONET_PROC_ID", "MASTER_ADDR", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.maybe_initialize(device="cpu") is False
    assert (distributed.rank(), distributed.world_size(),
            distributed.local_rank()) == (0, 1, 0)
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    assert distributed.all_reduce_grads([p]) == 0
    assert torch.equal(p.grad, torch.full((3,), 2.0))
    m = {"x": torch.tensor(1.5)}
    assert distributed.all_reduce_metrics(m)["x"] is m["x"]
    assert distributed.local_device("cuda") == torch.device("cuda", 0)
    assert distributed.local_device("cuda:1") == torch.device("cuda", 1)
    assert distributed.local_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="number of processes"):
        distributed.maybe_initialize("localhost:1234", device="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("launch", ["marconet", "torchrun"])
def test_group_from_launch_variables(monkeypatch, tmp_path, launch):
    """The JAX package's ``MARCONET_*`` variables and torchrun's bring up a
    one-rank gloo group; ``LOCAL_RANK`` names the device index."""
    if launch == "marconet":
        monkeypatch.setenv("MARCONET_COORDINATOR",
                           "file://" + str(tmp_path / "rendezvous"))
        monkeypatch.setenv("MARCONET_NUM_PROCS", "1")
        monkeypatch.setenv("MARCONET_PROC_ID", "0")
    else:
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(_free_port()))
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.maybe_initialize(device="cpu") is True
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert distributed.maybe_initialize(device="cpu") is False
        assert (distributed.world_size(), distributed.local_rank()) == (1, 3)
        assert distributed.local_device("cuda") == torch.device("cuda", 3)
    finally:
        distributed.shutdown()
    assert distributed.world_size() == 1
