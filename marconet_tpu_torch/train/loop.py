"""Training loop: data workers, device feed, logging, checkpointing.

Counterpart of ``marconet_tpu/train/loop.py`` (basicsr's
``train_pipeline``, reference ``Train/tspgan/train.py:1-11``), one
device a rank: spawned worker processes synthesize batches on the host
into a bounded queue, each batch goes to the device through pinned memory
(``TrainBatch.from_numpy``), ``MARCONetTrainer.train_step`` runs the three
phases, and the loop logs to a TensorBoard event file (``train/events.py``):
the loss terms, ``speed/samples_per_sec`` and ``speed/data_wait_ms`` (the
host's wait on the queue, a step) every ``print_freq`` steps, the
``val/*`` grids and predicted text every ``val_freq``, and saves a
checkpoint every ``save_freq``. Metrics are read on the host only at
``print_freq``: a step's losses are device tensors, and no other step
waits for the device.

``MARCONET_PROFILE=<dir>`` records a ``torch.profiler`` chrome trace of
the steps ``start + 10 .. start + 15`` (as the JAX package's window) into
``<dir>``, with the spans ``train/data_wait``, ``train/val`` and
``train/save`` marked on the host's timeline.

Data parallelism (``parallel/distributed.py``), as the JAX loop: the
process group comes up first (``maybe_initialize``: the ``MARCONET_*``
variables or torchrun's), each rank drives ``cuda:LOCAL_RANK`` and
synthesizes its own rows with worker seeds offset by ``rank * 10_000``,
every rank starts from rank 0's nets, the step sums gradients and losses
over the ranks, and rank 0 alone prints, writes events and visuals (from
its own rows) and checkpoints. ``speed/samples_per_sec`` counts the
global batch.
"""

from __future__ import annotations

import functools
import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from marconet_tpu_torch.convert import load_reference_pth
from marconet_tpu_torch.data.synth import (
    SynthConfig,
    TextLineSynthesizer,
    font_files,
)
from marconet_tpu_torch.models.pipeline import resolve_device
from marconet_tpu_torch.parallel import distributed
from marconet_tpu_torch.train import checkpoint as ckpt
from marconet_tpu_torch.train.config import (
    FullConfig,
    LoopConfig,
    check_world_size,
)
from marconet_tpu_torch.train.events import EventWriter
from marconet_tpu_torch.train.lpips import MissingLpipsWeights
from marconet_tpu_torch.train.train_step import (
    NETS,
    MARCONetTrainer,
    TrainBatch,
)
from marconet_tpu_torch.train.visuals import build_visual_grids

# the profiled steps, relative to the first step of the run: [10, 16)
PROFILE_STEPS = (10, 16)


# ---------------------------------------------------------------------------
# host-side batch workers
# ---------------------------------------------------------------------------


def default_synthesizer(cfg: LoopConfig) -> TextLineSynthesizer:
    """The config's dataset: fonts, backgrounds and corpora of
    ``datasets.train``."""
    return TextLineSynthesizer(SynthConfig(
        font_dir=cfg.font_dir, bg_dir=cfg.bg_dir,
        corpus_paths=cfg.corpus_paths))


class _WorkerError(str):
    """A worker's traceback, sent through the queue in place of a batch."""


def _worker(factory: Callable[[], TextLineSynthesizer], batch_size: int,
            seed: int, q, max_chars=None):
    try:
        synth = factory()
        rng = np.random.default_rng(seed)
        while True:
            q.put(synth.batch(batch_size, rng, max_chars=max_chars))
    except Exception:                     # reported by the consumer
        q.put(_WorkerError(traceback.format_exc()))


class BatchLoader:
    """Process-pool batch producer with a bounded prefetch queue.

    Worker ``i`` draws from ``np.random.default_rng(cfg.seed + 1000 +
    seed_offset + i)``, as the JAX package's workers do. ``synth_factory``
    (picklable, called once in each worker) makes its synthesizer; by
    default :func:`default_synthesizer` of ``cfg``. A worker that fails
    sends its traceback, which iteration raises.
    """

    def __init__(self, cfg: LoopConfig, global_batch: int,
                 num_workers: Optional[int] = None, prefetch: int = 8,
                 max_chars: Optional[int] = None, seed_offset: int = 0,
                 synth_factory: Optional[Callable] = None):
        self.cfg = cfg
        self.global_batch = global_batch
        self.num_workers = num_workers or max(cfg.num_workers, 1)
        factory = synth_factory or functools.partial(default_synthesizer, cfg)
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue(maxsize=prefetch)
        self.procs = [
            ctx.Process(target=_worker,
                        args=(factory, global_batch,
                              cfg.seed + 1000 + seed_offset + i,
                              self.q, max_chars),
                        daemon=True)
            for i in range(self.num_workers)
        ]
        for p in self.procs:
            p.start()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            try:
                item = self.q.get(timeout=5.0)
            except queue.Empty:
                if not any(p.is_alive() for p in self.procs):
                    raise RuntimeError("every batch worker exited") from None
                continue
            if isinstance(item, _WorkerError):
                raise RuntimeError(f"a batch worker failed:\n{item}")
            yield item

    def close(self):
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            p.join(timeout=10)
        self.q.close()
        self.q.cancel_join_thread()


# ---------------------------------------------------------------------------
# training driver
# ---------------------------------------------------------------------------

# net, released file, container key (reference ``train.yml:65-73``)
WARM_START_FILES = (("encoder", "net_transformer_encoder.pth", "params_ema"),
                    ("prior", "net_prior_generation.pth", "params_ema"),
                    ("srnet", "net_sr.pth", "params_ema"),
                    ("net_d", "net_d.pth", "params"),
                    ("net_srd", "net_srd.pth", "params"))


def warm_start(trainer: MARCONetTrainer, pretrain_dir: str
               ) -> MARCONetTrainer:
    """Load the released torch checkpoints into the trainer's nets, each
    strictly (``convert.load_reference_pth``); a missing file keeps the
    net's random init. Optimizer states stay fresh."""
    for name, fname, key in WARM_START_FILES:
        path = os.path.join(pretrain_dir, fname)
        if not os.path.exists(path):
            print(f"warm start: {fname} not found, keeping random init")
            continue
        print(f"warm start: loading {fname}")
        load_reference_pth(trainer.net(name), path, key)
    return trainer


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _log_visuals(writer: EventWriter, trainer: MARCONetTrainer,
                 batch: TrainBatch, step: int, font_dir: str) -> None:
    """The ``val/*`` grids and the predicted text (reference
    ``tspgan_model.py:615-621``): the text as the image
    ``val/1_pred_text`` in the first font of ``font_dir``, or without a
    font as a text entry of that name (``train/visuals.py``)."""
    vis = trainer.visual_forward(batch)
    fonts = font_files(font_dir)           # the JAX loop takes the first
    grids, text = build_visual_grids(
        gt=_host(batch.gt), lq=_host(batch.lq), sr=_host(vis["sr"]),
        prior128=_host(vis["prior128"]), gt_chars=_host(batch.gt_chars),
        pred_cw=_host(vis["pred_cw"]), boxinfo_lr=_host(batch.boxinfo_lr),
        pred_ids=_host(vis["pred_ids"]),
        font_path=fonts[0] if fonts else None)
    for label, img in grids.items():
        writer.add_image(f"val/{label}", img, step)
    if "1_pred_text" not in grids:
        writer.add_text("val/1_pred_text", text, step)


def _start_profile(device: torch.device) -> profile:
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof: profile, device: torch.device, out_dir: str,
                  steps: Tuple[int, int]) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)   # the window's device work, whole
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_steps_{steps[0]}-{steps[1]}.json")
    prof.export_chrome_trace(path)
    print(f"profile of steps {steps[0]}-{steps[1]} written to {path}")


def train(config: FullConfig, max_steps: Optional[int] = None,
          device="cuda", synth_factory: Optional[Callable] = None,
          profile_steps: Tuple[int, int] = PROFILE_STEPS
          ) -> MARCONetTrainer:
    """Train until step ``min(total_iter, max_steps)``; returns the
    trainer.

    ``device``: CUDA unless named; a CUDA device without an index is this
    rank's, ``cuda:LOCAL_RANK``. ``synth_factory``: the workers'
    synthesizer (see :class:`BatchLoader`). ``profile_steps``: the
    [first, stop) steps, counted from the run's first, that
    ``MARCONET_PROFILE`` traces (on rank 0). The process group is the one
    already up, kept, or else the one the environment names
    (:func:`~marconet_tpu_torch.parallel.distributed.maybe_initialize`,
    its backend by ``device``), ended on return. Refuses a ``num_gpu``
    other than the world size and, unless ``allow_random_lpips`` is set, a
    missing pretrained LPIPS (both before any worker starts).
    """
    owned = distributed.maybe_initialize(device=device)
    try:
        return _train(config, max_steps, device, synth_factory,
                      profile_steps)
    finally:
        if owned:
            distributed.shutdown()


def _train(config: FullConfig, max_steps: Optional[int], device,
           synth_factory: Optional[Callable],
           profile_steps: Tuple[int, int]) -> MARCONetTrainer:
    loop = config.loop
    world, main = distributed.world_size(), distributed.rank() == 0
    check_world_size(loop, world)
    device = resolve_device(distributed.local_device(device))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    run_dir = os.path.join(loop.experiments_root, loop.name)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    os.makedirs(run_dir, exist_ok=True)

    try:
        trainer = MARCONetTrainer(config.train, device=device,
                                  seed=loop.seed,
                                  lpips_dir=loop.pretrain_dir,
                                  allow_random_lpips=loop.allow_random_lpips)
    except MissingLpipsWeights as e:
        raise SystemExit(f"{e} (pretrain_dir={loop.pretrain_dir!r}; "
                         "train.allow_random_lpips / --allow_random_lpips)"
                         ) from None
    if loop.resume_state:
        ckpt.restore_state(loop.resume_state, trainer)
        if main:
            print(f"resumed from {loop.resume_state} at step {trainer.step}")
    elif loop.pretrain_dir:
        warm_start(trainer, loop.pretrain_dir)
    for name in NETS:           # every rank starts from rank 0's nets
        distributed.broadcast_module_state(trainer.net(name))
    start = trainer.step
    global_batch = loop.batch_size * world
    if world > 1 and main:
        print(f"data parallel: {world} ranks, global batch {global_batch} "
              f"({loop.batch_size} a rank)")

    writer = EventWriter(os.path.join(run_dir, "tb")) \
        if loop.use_tb_logger and main else None
    # each rank synthesizes its own rows; worker seeds disjoint over ranks
    loader = BatchLoader(loop, loop.batch_size, max_chars=trainer.max_chars,
                         seed_offset=distributed.rank() * 10_000,
                         synth_factory=synth_factory)
    profile_dir = os.environ.get("MARCONET_PROFILE") if main else None
    prof = None
    window = (start + profile_steps[0] + 1, start + profile_steps[1])
    total = min(loop.total_iter, max_steps or loop.total_iter)
    batches = iter(loader)
    t0, wait = time.perf_counter(), 0.0
    try:
        while trainer.step < total:
            step = trainer.step            # the 0-based index of this step
            if profile_dir and step == start + profile_steps[0]:
                prof = _start_profile(device)
            tw = time.perf_counter()
            with record_function("train/data_wait"):
                raw = next(batches)
            wait += time.perf_counter() - tw
            batch = TrainBatch.from_numpy(raw, device)
            # the losses come back summed over the ranks (every rank runs
            # the same collectives a step, so none waits on another's branch)
            metrics = trainer.train_step(batch)
            done = step + 1
            if prof is not None and done == window[1]:
                _stop_profile(prof, device, profile_dir, window)
                prof = None

            if main and done % loop.print_freq == 0:
                m = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                rate = loop.print_freq * global_batch / (now - t0)
                wait_ms = wait * 1e3 / loop.print_freq
                t0, wait = now, 0.0
                print(f"iter {done} | {rate:.3f} samples/s | data wait "
                      f"{wait_ms:.1f} ms/step | " + " ".join(
                          f"{k}={v:.4f}" for k, v in sorted(m.items())),
                      flush=True)
                if writer is not None:
                    for k, v in m.items():
                        writer.add_scalar(f"losses/{k}", v, done)
                    writer.add_scalar("speed/samples_per_sec", rate, done)
                    writer.add_scalar("speed/data_wait_ms", wait_ms, done)
            # rank 0's own rows; the eval forward issues no collective
            if writer is not None and loop.val_freq > 0 \
                    and done % loop.val_freq == 0:
                with record_function("train/val"):
                    _log_visuals(writer, trainer, batch, done,
                                 loop.font_dir)
            if done % loop.save_freq == 0:
                with record_function("train/save"):
                    path = ckpt.save_state(ckpt_dir, trainer)
                if main:
                    print(f"saved checkpoint at iter {done}: {path}")
    finally:
        if prof is not None:
            _stop_profile(prof, device, profile_dir,
                          (window[0], trainer.step))
        loader.close()
        if writer is not None:
            writer.close()
    return trainer
