"""Data-parallel dry run on the CPU (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip`` and ``tools/dryrun_worker.py``).

    python -m marconet_tpu_torch.dryrun 4

Spawns ``n`` processes that join one gloo process group through a file
in a temporary directory, each with the same seeded trainer at a reduced
width (0.0625, 4 character slots) and its own 2 rows of one seeded
global batch, whose rows hold different numbers of valid characters.
Every rank runs ONE three-phase ``train_step``; the run raises if a rank
fails, if the ranks' nets differ after the step, or if the summed losses
differ from one process's step over the whole global batch.

:func:`run_ranks` and :func:`one_process_step` are the two sides of that
comparison, also for the tests (``tests/test_torch_distributed.py``).
Every process runs on one thread, under
``torch.use_deterministic_algorithms(True)``, with oneDNN and NNPACK off:
threaded BLAS and the threaded ``index_put_`` adds of the gathers'
backward round by shape or in no fixed order; NNPACK, which PyTorch takes
for CPU convs over 16 images or more (the prior's B x N slots of the
one-process step, not a rank's), rounds each image otherwise than the
native conv, and the SR net's masked statistics carry such differences
far past 1e-5 in its gradient; and this CPU build's oneDNN backward of a
strided 1x1 conv over 8 channels (the encoder at width 0.0625) is
unreliable.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from marconet_tpu_torch.alphabet import BLANK_INDEX
from marconet_tpu_torch.data.batch_prep import prepare_train_batch
from marconet_tpu_torch.parallel import distributed
from marconet_tpu_torch.train.train_step import (
    NETS,
    MARCONetTrainer,
    TrainBatch,
    TrainConfig,
)

WIDTH = 0.0625
SLOTS = 4
PER_RANK = 2
LOSS_RTOL = 1e-5
RANK_TIMEOUT_S = 300.0


def seeded_batch(rng: np.random.Generator, rows: int, slots: int,
                 counts) -> Dict[str, np.ndarray]:
    """A training batch of random GT lines and ink masks (the JAX package's
    ``tests/train_fixtures.py`` recipe) with ``counts[i]`` valid characters
    on row ``i``, through ``prepare_train_batch``."""
    w = 128 * slots
    gt = rng.uniform(-1, 1, (rows, 128, w, 3)).astype(np.float32)
    ink = (rng.uniform(0, 1, (rows, 128, w, 3)) > 0.7).astype(np.float32)
    lq = rng.uniform(-1, 1, (rows, 32, w // 4, 3)).astype(np.float32)
    labels = np.full((rows, slots), BLANK_INDEX, np.int64)
    box = np.zeros((rows, 2 * slots), np.float32)
    for i, n in enumerate(counts):
        labels[i, :n] = rng.integers(0, BLANK_INDEX, n)
        lefts = np.sort(rng.uniform(0.0, 0.8, n))
        box[i, 0:2 * n:2] = lefts
        box[i, 1:2 * n:2] = lefts + 0.05
    return prepare_train_batch(gt, ink, labels, box, lq)


def unequal_counts(rows: int, slots: int) -> List[int]:
    """Valid characters of each row, 1, 2, ... cycling through the slots:
    every two consecutive rows hold a different total."""
    return [1 + i % slots for i in range(rows)]


def seeded_state(seed: int = 0) -> dict:
    """The reduced trainer's nets, optimizers and LPIPS from ``seed``."""
    trainer = MARCONetTrainer(TrainConfig(), device="cpu", seed=seed,
                              width=WIDTH, max_chars=SLOTS,
                              allow_random_lpips=True)
    return {"trainer": trainer.state_dict(),
            "lpips": trainer.lpips.state_dict()}


def _trainer(state: Optional[dict] = None) -> MARCONetTrainer:
    trainer = MARCONetTrainer(TrainConfig(), device="cpu", width=WIDTH,
                              max_chars=SLOTS, allow_random_lpips=True)
    if state is not None:
        trainer.load_state_dict(state["trainer"])
        trainer.lpips.load_state_dict(state["lpips"])
    return trainer


def _step(trainer: MARCONetTrainer, arrays) -> dict:
    """One step on the CPU, deterministic, oneDNN and NNPACK off: the
    losses, every net's gradient (after the all-reduce) and its state
    after the step."""
    with torch.backends.mkldnn.flags(enabled=False), \
            torch.backends.nnpack.flags(enabled=False):
        metrics = trainer.train_step(TrainBatch.from_numpy(arrays, "cpu"))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: {k: p.grad.numpy().copy()
                          for k, p in trainer.net(n).named_parameters()
                          if p.grad is not None} for n in NETS},
            "state": {n: {k: v.numpy().copy() for k, v in
                          trainer.net(n).state_dict().items()}
                      for n in NETS}}


def _rank_main(rank: int, world: int, init_method: str, state_path: str,
               arrays, out_q) -> None:
    try:
        torch.use_deterministic_algorithms(True)
        torch.set_num_threads(1)
        distributed.maybe_initialize(init_method, world, rank,
                                     backend="gloo", device="cpu")
        try:
            trainer = _trainer(torch.load(state_path, weights_only=True))
            local = distributed.local_batch_slice(arrays, len(arrays["lq"]))
            out = _step(trainer, local)
            distributed.barrier()
        finally:
            distributed.shutdown()
        out_q.put((rank, out))
    except BaseException:
        out_q.put((rank, traceback.format_exc()))


def run_ranks(world: int, arrays: Dict[str, np.ndarray], state: dict,
              timeout: float = RANK_TIMEOUT_S) -> List[dict]:
    """One ``train_step`` on ``world`` spawned gloo ranks, each on its
    contiguous rows of ``arrays`` and from ``state``
    (:func:`seeded_state`'s form); returns each rank's :func:`_step`
    result. Raises naming a rank that failed or did not finish."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="marconet_dryrun_") as tmp:
        state_path = os.path.join(tmp, "state.pt")
        torch.save(state, state_path)
        init = "file://" + os.path.join(tmp, "rendezvous")
        out_q = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init, state_path, arrays,
                                   out_q))
                 for r in range(world)]
        for p in procs:
            p.start()
        results: Dict[int, dict] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world:
                try:
                    rank, out = out_q.get(timeout=1.0)
                except queue.Empty:
                    missing = [r for r in range(world) if r not in results]
                    # a rank that exited has flushed its report, if any
                    dead = [r for r in missing if not procs[r].is_alive()]
                    if dead and out_q.empty():
                        raise RuntimeError(
                            f"ranks {dead} exited without a result (exit "
                            f"codes {[procs[r].exitcode for r in dead]})"
                        ) from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"ranks {missing} did not finish "
                                           f"in {timeout:.0f} s") from None
                    continue
                if isinstance(out, str):
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                results[rank] = out
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(world)]


def one_process_step(arrays: Dict[str, np.ndarray], state: dict) -> dict:
    """The same step in this process over the whole batch, deterministic,
    on one thread as each rank."""
    was = torch.are_deterministic_algorithms_enabled(), \
        torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    try:
        return _step(_trainer(state), arrays)
    finally:
        torch.use_deterministic_algorithms(was[0])
        torch.set_num_threads(was[1])


def dryrun_multichip(n: int = 2, seed: int = 0) -> dict:
    """``n`` gloo ranks against one process (module docstring); returns
    the summed losses."""
    t0 = time.perf_counter()
    rows = n * PER_RANK
    counts = unequal_counts(rows, SLOTS)
    arrays = seeded_batch(np.random.default_rng(seed), rows, SLOTS, counts)
    state = seeded_state(seed)
    ranks = run_ranks(n, arrays, state)
    want = one_process_step(arrays, state)
    for r, out in enumerate(ranks[1:], 1):
        for net in NETS:
            for k, v in ranks[0]["state"][net].items():
                if not np.array_equal(v, out["state"][net][k]):
                    raise RuntimeError(f"{net}.{k} differs between rank 0 "
                                       f"and rank {r} after the step")
    got = ranks[0]["metrics"]
    for k, w in want["metrics"].items():
        if not np.isclose(got[k], w, rtol=LOSS_RTOL, atol=0):
            raise RuntimeError(f"{k}: {n} ranks {got[k]!r}, one process "
                               f"{w!r} (rtol {LOSS_RTOL})")
    per_rank = [sum(counts[r * PER_RANK:(r + 1) * PER_RANK])
                for r in range(n)]
    print(f"dryrun_multichip({n}) OK: width {WIDTH}, {SLOTS} slots, global "
          f"batch {rows} ({PER_RANK} a rank, valid characters {per_rank}), "
          f"l_g_total={got['l_g_total']:.6f} (one process "
          f"{want['metrics']['l_g_total']:.6f}), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return got


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
