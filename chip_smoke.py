#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``marconet_tpu_torch``) once on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits nonzero:

1. device: refuse to run without CUDA; print the card's name and power
   limit (nvidia-smi) and the TF32 switches, which are set off.
2. build: compile the hand-written kernels (csrc/, one nvcc per source,
   all at once) and time the build.
3. kernels: K1 (fused bias-LeakyReLU), K1b (its backward), K2 (SFT
   write-back) and the write-back's backward against their plain PyTorch
   versions at the serving and training paths' shapes, f32 and bf16; max
   abs difference (expected 0: all do f32 math and round once), CUDA-event
   times of both, and each kernel's bound (the larger of its bytes over
   the card's memory rate and its operations over the f32 peak).
4. parity: full-width f32 ``restore`` (B=1, 4 slots, 3 valid) on the card
   (kernels, TF32 off) against the CPU (plain versions), same seeded
   weights, within the tolerances of
   tests/test_convert.py::test_full_pipeline_chain_matches_torch.
5. serving: bf16 ``restore`` at full width on bench.py's workload (16
   lines of 8 characters) over several batches; checks shapes, finite
   values, sr in [-1, 1] and that every kernel of the path launched;
   prints crops/s from CUDA events and the per-stage split.
6. training parity: one full-width f32 ``MARCONetTrainer.train_step``
   (B=1, 4 slots, random LPIPS explicitly allowed: the pretrained weights
   are not in the repository) on the card (kernels, TF32 off) against the
   CPU (plain versions), same seeded weights: every loss term of the G, D
   and SRD phases and each net's gradient (G phase: encoder, prior, SR
   net; D / SRD phase: the discriminators), within the tolerances
   printed; then the encoder's gradient with cuDNN off (held to 1e-3)
   and a report of where cuDNN's differs (cotangents, cuDNN modes, and
   every conv2d of the G phase against f64).
7. training throughput: full-width f32 steps at ``options/train.yml``'s
   batch 2 with 16 slots on batches from ``prepare_train_batch``; one
   warm-up step and timed steps; checks finite losses, that every
   parameter tensor with a gradient moved, the step count and the exact
   launches of the four kernels per step; prints samples/s and the G / D
   / SRD split from CUDA events and the peak device memory.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from marconet_tpu_torch import native
from marconet_tpu_torch.data.batch_prep import prepare_train_batch
from marconet_tpu_torch.models.pipeline import BLANK_INDEX, MARCONet
from marconet_tpu_torch.models.srnet import window_geometry
from marconet_tpu_torch.ops.layers import nchw
from marconet_tpu_torch.ops.fused_act import (
    fused_leaky_relu,
    fused_leaky_relu_bwd,
    fused_leaky_relu_bwd_plain,
    fused_leaky_relu_plain,
)
from marconet_tpu_torch.ops.sft_writeback import (
    sft_writeback,
    sft_writeback_bwd,
    sft_writeback_bwd_plain,
    sft_writeback_plain,
)
from marconet_tpu_torch.train.train_step import (
    NETS,
    MARCONetTrainer,
    TrainBatch,
    TrainConfig,
)

SERVE_BATCH = 16    # bench.py's workload: 16 lines of 8 characters
SERVE_SLOTS = 8
SERVE_REQUESTS = 4  # distinct batches standing in for requests
SERVE_ITERS = 12
TRAIN_BATCH = 2     # options/train.yml:20 batch_size_per_gpu
TRAIN_SLOTS = 16
TRAIN_STEPS = 5     # timed, after one warm-up step
PARITY_SLOTS = 4
# the card's peaks (NVIDIA H100 SXM data sheet, 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores (these kernels' arithmetic)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
KERNELS = {
    "fused_leaky_relu": dict(
        route="cuda", source="marconet_tpu_torch/csrc/fused_act.cu",
        replaces="marconet_tpu/ops/fused_act.py:48"),
    "fused_leaky_relu_bwd": dict(
        route="cuda", source="marconet_tpu_torch/csrc/fused_act.cu",
        replaces="marconet_tpu/ops/fused_act.py:55"),
    "sft_writeback": dict(
        route="cuda", source="marconet_tpu_torch/csrc/sft_writeback.cu",
        replaces="marconet_tpu/ops/pallas_sft.py:70"),
    "sft_writeback_bwd": dict(
        route="cuda", source="marconet_tpu_torch/csrc/sft_writeback.cu",
        replaces="none"),
}
# launches per training step: 19 StyledConv / style-MLP activations in the
# prior (forward and backward), two SFT scales in the SR net
TRAIN_LAUNCHES = {"fused_leaky_relu": 19, "fused_leaky_relu_bwd": 19,
                  "sft_writeback": 2, "sft_writeback_bwd": 2}


def say(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn``, from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the port on a GPU and has no CPU mode")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" cuda {torch.version.cuda} cudnn {torch.backends.cudnn.version()}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}; "
        f"fp32_precision: cudnn.conv "
        f"{getattr(torch.backends.cudnn.conv, 'fp32_precision', '-')}, "
        f"cuda.matmul "
        f"{getattr(torch.backends.cuda.matmul, 'fp32_precision', '-')}")
    native.require_hopper(torch.device("cuda", 0))
    return smi


def phase_build() -> None:
    path, seconds = native.build()
    native.library()
    say(f"[build] kernels built in {seconds:.2f} s -> "
        f"{os.path.relpath(path)}")


def _k2_case(gen: np.random.Generator, tgen: torch.Generator, b: int,
             height: int, width: int, hw: int, dtype, dev):
    """The sft_32 / sft_64 write-back shapes with S=16 slots: rows mix
    overlapping windows, truncated edge windows and invalid slots."""
    s, c = 16, 256
    locs = np.zeros((b, 2 * s), np.float32)
    for i in range(b):
        kind = i % 3
        if kind == 0:       # a window at each edge, dense overlaps between
            centers = np.linspace(0.01, 0.99, s)
        elif kind == 1:     # a heavily overlapping cluster
            centers = np.concatenate([[0.3, 0.317, 0.335, 0.36],
                                      gen.uniform(0, 1, s - 4)])
        else:
            centers = gen.uniform(0, 1, s)
        locs[i, 0::2] = centers
    x1, length, _ = window_geometry(torch.from_numpy(locs), hw, width)
    valid = torch.from_numpy((gen.random((b, s)) > 0.25).astype(np.int32))
    canvas = torch.randn(b, height, width, c, device=dev, generator=tgen)
    res = torch.randn(b, s, height, 2 * hw, c, device=dev, generator=tgen)
    return (canvas.to(dtype), res.to(dtype), x1.to(dev), length.to(dev),
            valid.to(dev))


def _bound(nbytes: float, ops: float) -> tuple:
    """(least ms, what bounds it) for ``nbytes`` moved and ``ops`` done."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _covered_columns(x1, length, valid, width: int, win: int) -> int:
    """Columns some valid slot covers (each has exactly one winner)."""
    cols = torch.arange(width, device=x1.device)
    length = length.clamp(0, win)
    covers = ((cols >= x1[:, :, None]) & (cols < (x1 + length)[:, :, None])
              & (valid[:, :, None] > 0))
    return int(covers.any(dim=1).sum())


def _check_exact(name: str, label: str, err: float) -> None:
    if err != 0.0:
        raise AssertionError(f"{name} differs from its plain version by "
                             f"{err} ({label})")


def phase_kernels() -> dict:
    """Each kernel against its plain version at the main paths' shapes.

    K1 / K2 at the serving shapes (bf16 restore) and the training shapes;
    K1b / the write-back's backward at the training shapes (the only path
    that runs them), f32 and bf16 each. The report keeps, per kernel, the
    largest error and the times and bound of its reported case: bf16 at
    the largest serving shape for K1 / K2 (as in earlier runs), f32 at the
    largest training shape for the backward kernels.
    """
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(0)
    tgen = torch.Generator(device=dev).manual_seed(0)
    report = {name: {"max_abs_err": 0.0} for name in KERNELS}
    rows = TRAIN_BATCH * TRAIN_SLOTS
    k1_cases = {   # 4-D inputs are NHWC-stored (channels_last)
        "style-MLP serve (128, 512)": (128, 512),
        "StyledConv@128 serve (128, 128, 128, 128)": (128, 128, 128, 128),
        f"style-MLP train ({rows}, 512)": (rows, 512),
        f"StyledConv@128 train ({rows}, 128, 128, 128)":
            (rows, 128, 128, 128),
    }
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        size = torch.tensor([], dtype=dtype).element_size()
        for label, shape in k1_cases.items():
            x = torch.randn(shape, device=dev, generator=tgen).to(dtype)
            g = torch.randn(shape, device=dev, generator=tgen).to(dtype)
            if x.dim() == 4:
                x, g = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            bias = torch.randn(x.shape[1], device=dev, generator=tgen)
            n, c = x.numel(), x.shape[1]
            cases = [("fused_leaky_relu", "K1",
                      lambda: fused_leaky_relu(x, bias),
                      lambda: fused_leaky_relu_plain(x, bias),
                      _bound(2 * n * size + c * size, 3 * n))]
            if "train" in label:
                cases.append((
                    "fused_leaky_relu_bwd", "K1b",
                    lambda: fused_leaky_relu_bwd(x, bias, g),
                    lambda: fused_leaky_relu_bwd_plain(x, bias, g),
                    _bound(3 * n * size + c * size, 3 * n)))
            for name, short, kern, plain, (bound_ms, bound_by) in cases:
                err = max_abs(kern(), plain())
                ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
                say(f"[kernels] {short} {label} {dn}: max_abs_err={err} "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by})")
                _check_exact(name, f"{label}, {dn}", err)
                rep = report[name]
                rep["max_abs_err"] = max(rep["max_abs_err"], err)
                reported = (("serve (128, 128" in label and dn == "bfloat16")
                            if name == "fused_leaky_relu" else
                            (x.dim() == 4 and dn == "float32"))
                if reported:
                    rep.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
            del x, g
        for label, b, (height, width, hw) in (
                ("sft_32 serve", SERVE_BATCH, (32, 512, 16)),
                ("sft_64 serve", SERVE_BATCH, (64, 1024, 32)),
                ("sft_32 train", TRAIN_BATCH, (32, 512, 16)),
                ("sft_64 train", TRAIN_BATCH, (64, 1024, 32))):
            canvas, res, x1, length, valid = _k2_case(
                gen, tgen, b, height, width, hw, dtype, dev)
            win, c = 2 * hw, canvas.shape[-1]
            cov = _covered_columns(x1, length, valid, width, win)
            g = torch.randn(canvas.shape, device=dev, generator=tgen).to(
                dtype)
            canvas_el = canvas.numel()
            tables = 3 * x1.numel() * 4
            cases = [("sft_writeback", "K2",
                      lambda: sft_writeback(canvas, res, x1, length, valid),
                      lambda: sft_writeback_plain(canvas, res, x1, length,
                                                  valid),
                      _bound((2 * canvas_el + cov * height * c) * size
                             + tables, cov * height * c))]
            if "train" in label:
                cases.append((
                    "sft_writeback_bwd", "K2 backward",
                    lambda: sft_writeback_bwd(g, x1, length, valid, win),
                    lambda: sft_writeback_bwd_plain(g, x1, length, valid,
                                                    win),
                    _bound((res.numel() + cov * height * c) * size + tables,
                           0)))
            for name, short, kern, plain, (bound_ms, bound_by) in cases:
                err = max_abs(kern(), plain())
                ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
                say(f"[kernels] {short} {label} B={b} S=16 H={height} "
                    f"W={width} win={win} C={c} {dn}: max_abs_err={err} "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by})")
                _check_exact(name, f"{label}, {dn}", err)
                rep = report[name]
                rep["max_abs_err"] = max(rep["max_abs_err"], err)
                reported = (label == "sft_64 serve" and dn == "bfloat16"
                            if name == "sft_writeback" else
                            label == "sft_64 train" and dn == "float32")
                if reported:
                    rep.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
            del canvas, res, g
    torch.cuda.empty_cache()
    for rep in report.values():
        rep["library_ms"] = None      # no one PyTorch call computes these
    return report


def _lines(gen: np.random.Generator, batch: int, slots: int,
           n_valid: int, centers):
    lq = torch.from_numpy(gen.uniform(-1, 1, (batch, 32, 512, 3))
                          .astype(np.float32))
    labels = np.full((batch, slots), BLANK_INDEX, np.int64)
    labels[:, :n_valid] = gen.integers(0, BLANK_INDEX, (batch, n_valid))
    locs = np.zeros((batch, 2 * slots), np.float32)
    locs[:, 0:2 * n_valid:2] = centers
    locs[:, 1:2 * n_valid:2] = 0.03
    mask = np.zeros((batch, slots), np.float32)
    mask[:, :n_valid] = 1.0
    return lq, torch.from_numpy(labels), torch.from_numpy(locs), \
        torch.from_numpy(mask)


def phase_parity() -> None:
    """Full-width f32 restore: card (kernels) vs CPU (plain versions)."""
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu_net = MARCONet(dtype=torch.float32, device="cpu", seed=0)
    gpu_net = MARCONet(dtype=torch.float32, device="cuda", seed=1)
    gpu_net.load_state_dict(cpu_net.state_dict())
    say(f"[parity] built both nets in {time.perf_counter() - t0:.1f} s")
    inputs = _lines(np.random.default_rng(1), 1, 4, 3, [0.1, 0.45, 0.8])

    t0 = time.perf_counter()
    want = cpu_net.restore(*inputs)
    cpu_s = time.perf_counter() - t0
    gpu_net.restore(*inputs)                       # first call: warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = gpu_net.restore(*inputs)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    del cpu_net
    # tolerances of test_full_pipeline_chain_matches_torch
    for name, atol in (("sr", 5e-3), ("priors", 5e-3), ("w", 2e-3)):
        g = getattr(got, name).float().cpu()
        w = getattr(want, name)
        say(f"[parity] {name}: max_abs_diff={max_abs(g, w):.3e} "
            f"(rtol 2e-3, atol {atol:g})")
        torch.testing.assert_close(g, w, rtol=2e-3, atol=atol)
    say(f"[parity] restore f32 B=1 N=4: card {gpu_s * 1e3:.1f} ms, "
        f"CPU ({torch.get_num_threads()} threads) {cpu_s * 1e3:.1f} ms")


def _check_serving(out, batch: int, slots: int) -> None:
    if tuple(out.sr.shape) != (batch, 128, 2048, 3):
        raise AssertionError(f"sr shape {tuple(out.sr.shape)}")
    if tuple(out.priors.shape) != (batch, slots, 128, 128, 3):
        raise AssertionError(f"priors shape {tuple(out.priors.shape)}")
    for name, t in out._asdict().items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite values in {name}")
    if float(out.sr.float().abs().max()) > 1.0:
        raise AssertionError("sr leaves [-1, 1]")


_WRAPPERS = {"fused_leaky_relu": fused_leaky_relu,
             "fused_leaky_relu_bwd": fused_leaky_relu_bwd,
             "sft_writeback": sft_writeback,
             "sft_writeback_bwd": sft_writeback_bwd}


def _reset_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def _check_counts(phase: str, launches: dict, expected: dict,
                  what: str) -> None:
    say(f"[{phase}] launches over {what}: {launches} (expected {expected})")
    for name, count in launches.items():
        if count != expected[name]:
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{phase}, expected {expected[name]}")


def phase_serve(smi: str) -> dict:
    """bf16 restore on bench.py's workload, several batches."""
    b, n = SERVE_BATCH, SERVE_SLOTS
    net = MARCONet(dtype=torch.bfloat16, device="cuda", seed=0)
    gen = np.random.default_rng(2)
    centers = [0.06 + 0.11 * c for c in range(n)]   # bench.py's layout
    requests = [[t.cuda() for t in _lines(gen, b, n, n, centers)]
                for _ in range(SERVE_REQUESTS)]

    _reset_counts()
    outs = [net.restore(*requests[0])]            # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(SERVE_ITERS):
        outs.append(net.restore(*requests[i % SERVE_REQUESTS]))
        outs = outs[-SERVE_REQUESTS:]
    end.record()
    torch.cuda.synchronize()
    launches = _counts()
    ms = start.elapsed_time(end) / SERVE_ITERS
    for out in outs:
        _check_serving(out, b, n)
    calls = SERVE_ITERS + 1
    # inference runs no backward kernel
    _check_counts("serve", launches, {
        "fused_leaky_relu": calls * 19, "fused_leaky_relu_bwd": 0,
        "sft_writeback": calls * 2, "sft_writeback_bwd": 0},
        f"{calls} restores")
    say(f"[serve] bf16 restore B={b} slots={n}: {ms:.2f} ms/batch = "
        f"{b * 1e3 / ms:.2f} crops/s on {smi}")

    # per-stage split of the same workload (CUDA events)
    lq, labels, locs, mask = requests[0]
    with torch.inference_mode():
        x = lq.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        _, _, w = net.encoder(x)
        pri = net.generate_priors(w, labels)
        stages = {
            "encoder": cuda_ms(lambda: net.encoder(x), iters=5, warmup=1),
            "prior": cuda_ms(lambda: net.generate_priors(w, labels),
                             iters=5, warmup=1),
            "srnet": cuda_ms(lambda: net.super_resolve(
                x, pri.feat64, pri.feat32, locs, mask), iters=5, warmup=1),
        }
    say("[serve] stages (ms/batch): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))
    return launches


def _train_arrays(gen: np.random.Generator, batch: int, slots: int):
    """A training batch from seeded random GT lines and ink masks, 3 valid
    characters per line (the JAX package's ``tests/train_fixtures.py``
    recipe at any size), through the port's ``prepare_train_batch``."""
    w = 128 * slots
    gt = gen.uniform(-1, 1, (batch, 128, w, 3)).astype(np.float32)
    ink = (gen.uniform(0, 1, (batch, 128, w, 3)) > 0.7).astype(np.float32)
    lq = gen.uniform(-1, 1, (batch, 32, w // 4, 3)).astype(np.float32)
    labels = np.full((batch, slots), BLANK_INDEX, np.int64)
    box = np.zeros((batch, 2 * slots), np.float32)
    for i in range(batch):
        labels[i, :3] = gen.integers(0, BLANK_INDEX, 3)
        lefts = np.sort(gen.uniform(0.0, 0.8, 3))
        box[i, 0:6:2] = lefts
        box[i, 1:6:2] = lefts + 0.05
    return prepare_train_batch(gt, ink, labels, box, lq)


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm())


# card vs CPU, f32, TF32 off: losses rtol 1e-3 / atol 1e-4 (full-width
# reductions in another order); each net's gradient (the G phase's for
# encoder, prior and SR net, the D and SRD phases' for the discriminators)
# by relative L2 norm. The SR net's 1e-2 is the f32 sensitivity of its
# masked GroupNorm / AdaIN statistics (the CPU suite holds it to 1e-2
# against JAX). The encoder's 1e-2 on the cuDNN path: one ReLU input in
# its trunk lies within f32 rounding of 0 and cuDNN's f32 forward puts it
# on the other side, which reroutes the gradient through that unit
# (``_precision_report`` finds and prints it). The port's own math is held
# tighter: the encoder's gradient with PyTorch's native CUDA convolutions
# within 1e-3, and every conv2d of the G phase, recomputed alone under the
# path's own settings, within 1e-5 of f64 (TF32 would miss by ~1e-3).
PARITY_LOSS_TOL = (1e-3, 1e-4)
PARITY_GRAD_TOL = {"encoder": 1e-2, "prior": 1e-3, "srnet": 1e-2,
                   "net_d": 1e-3, "net_srd": 1e-3}
PARITY_NATIVE_ENCODER_TOL = 1e-3
PARITY_CONV_F64_TOL = 1e-5


def _conv_backend(cudnn: bool):
    """The path's own settings with cuDNN; PyTorch's native CUDA
    convolutions otherwise (``cudnn.flags`` turns TF32 on unless told)."""
    return (contextlib.nullcontext() if cudnn else
            torch.backends.cudnn.flags(enabled=False, allow_tf32=False))


class _EncoderCotangents:
    """Keeps the cotangents that reach the encoder's outputs (logits,
    locs, w) and its ResNet trunk's output during one backward."""

    def __init__(self, trainer):
        self.grads = {}
        self.handles = [
            trainer.encoder.register_forward_hook(self._outputs),
            trainer.encoder.resnet.register_forward_hook(self._trunk)]

    def _outputs(self, module, inputs, out) -> None:
        for name, t in zip(("logits", "locs", "w"), out):
            self._keep(name, t)

    def _trunk(self, module, inputs, out) -> None:
        self._keep("trunk", out)

    def _keep(self, name, t) -> None:
        t.register_hook(lambda g: self.grads.__setitem__(
            name, g.detach().float().cpu()))

    def close(self) -> None:
        for h in self.handles:
            h.remove()


class _ConvRecorder(torch.overrides.TorchFunctionMode):
    """Records every ``conv2d`` of a forward and backward: the module that
    ran it, its inputs and the cotangent of its output."""

    def __init__(self, nets):
        super().__init__()
        self.calls, self.stack, self.handles = [], [], []
        for net_name, net in nets.items():
            for name, mod in net.named_modules():
                label = f"{net_name}.{name}" if name else net_name
                self.handles += [
                    mod.register_forward_pre_hook(
                        lambda m, i, label=label: self._enter(label)),
                    mod.register_forward_hook(self._leave)]

    def _enter(self, label: str) -> None:
        self.stack.append(label)

    def _leave(self, module, inputs, out) -> None:
        self.stack.pop()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.nn.functional.conv2d and out.requires_grad:
            call = {"module": self.stack[-1] if self.stack else "?",
                    "args": [a.detach() if isinstance(a, torch.Tensor)
                             else a for a in args],
                    "kwargs": dict(kwargs or {})}
            out.register_hook(
                lambda g, call=call: call.__setitem__("gy", g.detach()))
            self.calls.append(call)
        return out

    def close(self) -> None:
        for h in self.handles:
            h.remove()


def _conv_errors(call) -> dict:
    """Relative L2 errors of one recorded conv's output, input gradient
    and weight gradient in f32 with cuDNN and with PyTorch's native CUDA
    convolutions, each against f64 on the same inputs."""
    x, w, *rest = call["args"]

    def run(dtype, cudnn):
        with _conv_backend(cudnn):
            xx = x.to(dtype).requires_grad_()
            ww = w.to(dtype).requires_grad_()
            more = [a.to(dtype) if isinstance(a, torch.Tensor) else a
                    for a in rest]
            y = torch.nn.functional.conv2d(xx, ww, *more, **call["kwargs"])
            return (y.detach(),) + torch.autograd.grad(
                y, (xx, ww), call["gy"].to(dtype))

    ref = run(torch.float64, True)
    out = {}
    for backend, cudnn in (("cudnn", True), ("native", False)):
        for part, g, r in zip(("fwd", "dgrad", "wgrad"),
                              run(torch.float32, cudnn), ref):
            out[f"{backend} {part}"] = _rel_l2(g.double(), r)
    return out


def _trunk_against_f64(gpu, start, lq, cot) -> None:
    """The encoder's ResNet trunk alone, on the step's input ``lq`` (NHWC,
    CPU) with the CPU step's cotangent ``cot`` at its output: output and
    weight gradient in f32 with cuDNN, with the native CUDA convolutions
    and on the CPU, each against f64 on the card. Then, against the f64
    run, each conv of the cuDNN run whose input (a ReLU's output) is 0 at
    other entries than f64's, with the error of the cotangent at its
    output and at the output of the conv before it."""
    sd = {k.removeprefix("resnet."): v
          for k, v in start["nets"]["encoder"].items()
          if k.startswith("resnet.")}

    def run(device, dtype, cudnn=True):
        trunk = copy.deepcopy(gpu.encoder.resnet).to(device, dtype)
        trunk.load_state_dict(sd)
        rec = _ConvRecorder({"trunk": trunk})
        with _conv_backend(cudnn), torch.backends.mkldnn.flags(
                enabled=False, allow_tf32=False):
            with rec:
                y = trunk(nchw(lq.to(device, dtype)))
            y.backward(cot.to(device, dtype))
        rec.close()
        return (y.detach().double().cpu(),
                torch.cat([p.grad.double().cpu().ravel()
                           for p in trunk.parameters()]), rec.calls)

    y64, g64, calls64 = run(gpu.device, torch.float64)
    runs = {"cuDNN f32": run(gpu.device, torch.float32),
            "native f32": run(gpu.device, torch.float32, cudnn=False),
            "CPU f32": run(torch.device("cpu"), torch.float32)}
    say("[train-parity] encoder trunk alone, same input and output "
        "cotangent, against f64 (relative L2, output / weight gradient): "
        + ", ".join(f"{k} {_rel_l2(y, y64):.2e} / {_rel_l2(g, g64):.2e}"
                    for k, (y, g, _) in runs.items())
        + "; weight gradient, native f32 vs CPU f32 "
        f"{_rel_l2(runs['native f32'][1], runs['CPU f32'][1]):.2e}")
    calls = runs["cuDNN f32"][2]
    cot_err = [_rel_l2(c["gy"].double(), r["gy"]) for c, r in
               zip(calls, calls64)]
    for i, (c, r) in enumerate(zip(calls, calls64)):
        x32, x64 = c["args"][0], r["args"][0]
        flips = (x32 == 0) != (x64 == 0)
        if i and bool(flips.any()):
            say(f"[train-parity] trunk, cuDNN f32 vs f64: the input of "
                f"{c['module'].removeprefix('trunk.')} is exactly 0 at "
                f"{int((x64 == 0).sum())} entries in f64 and "
                f"{int((x32 == 0).sum())} in f32; {int(flips.sum())} "
                f"differ (largest value there: f32 "
                f"{float(x32[flips].abs().max()):.2e}, f64 "
                f"{float(x64[flips].abs().max()):.2e}); the cotangent's "
                f"error is {cot_err[i]:.2e} at this conv's output and "
                f"{cot_err[i - 1]:.2e} at the output of "
                f"{calls[i - 1]['module'].removeprefix('trunk.')}")


def _encoder_rel(gpu, cpu) -> float:
    return _rel_l2(torch.cat([p.grad.cpu().ravel()
                              for p in gpu.encoder.parameters()]),
                   torch.cat([p.grad.ravel()
                              for p in cpu.encoder.parameters()]))


def _precision_report(gpu, cpu, start, arrays, cot_gpu, cot_cpu) -> None:
    """Where the encoder's G-phase gradient on the card leaves the CPU's.

    1. the cotangents reaching the encoder's outputs and its trunk;
    2. the same G phase with cuDNN off (held to 1e-3);
    3. every conv2d of one G phase on the path's settings, recomputed
       alone on its own inputs in f32 with cuDNN (held to 1e-5) and with
       the native convolutions, each against f64;
    4. the trunk alone (``_trunk_against_f64``).
    """
    say("[train-parity] cotangents reaching the encoder, card vs CPU "
        "(relative L2): " + ", ".join(
            f"{k} {_rel_l2(cot_gpu[k], cot_cpu[k]):.3e}" for k in cot_cpu))
    batch = TrainBatch.from_numpy(arrays, gpu.device)
    gpu.load_state_dict(start)
    with _conv_backend(cudnn=False):
        gpu.g_phase(batch)
    rel = _encoder_rel(gpu, cpu)
    say(f"[train-parity] G-phase gradient of encoder with cuDNN off: "
        f"relative L2 difference {rel:.3e} (limit "
        f"{PARITY_NATIVE_ENCODER_TOL:g})")
    if not rel <= PARITY_NATIVE_ENCODER_TOL:
        raise AssertionError(f"encoder gradient with cuDNN off differs by "
                             f"{rel}")

    gpu.load_state_dict(start)
    rec = _ConvRecorder({n: gpu.net(n) for n in NETS} | {"lpips": gpu.lpips})
    with rec:
        gpu.g_phase(batch)
    rec.close()
    rows = []
    for call in rec.calls:
        if "gy" in call:
            rows.append((_conv_errors(call), call["module"]))
        call.clear()
    torch.cuda.empty_cache()
    worst = {k: max((e[k], m) for e, m in rows) for k in rows[0][0]}
    say(f"[train-parity] {len(rows)} conv2d calls of one G phase, each "
        f"alone against f64, largest relative L2 error (limit "
        f"{PARITY_CONV_F64_TOL:g} with cuDNN): " + ", ".join(
            f"{k} {e:.2e} ({m})" for k, (e, m) in worst.items()))
    bad = {k: v for k, v in worst.items()
           if k.startswith("cudnn") and not v[0] <= PARITY_CONV_F64_TOL}
    if bad:
        raise AssertionError(f"cuDNN conv2d outside {PARITY_CONV_F64_TOL}"
                             f" of f64: {bad}")
    _trunk_against_f64(gpu, start, TrainBatch.from_numpy(arrays, "cpu").lq,
                       cot_cpu["trunk"])


def phase_train_parity() -> None:
    """Full-width f32 train_step: card (kernels) vs CPU (plain versions)."""
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    kw = dict(max_chars=PARITY_SLOTS, allow_random_lpips=True)
    cpu = MARCONetTrainer(TrainConfig(), device="cpu", seed=0, **kw)
    gpu = MARCONetTrainer(TrainConfig(), device="cuda", seed=1, **kw)
    start = copy.deepcopy(cpu.state_dict())
    gpu.load_state_dict(start)
    gpu.lpips.load_state_dict(cpu.lpips.state_dict())
    say(f"[train-parity] built both trainers in "
        f"{time.perf_counter() - t0:.1f} s (random LPIPS, explicitly "
        f"allowed)")
    arrays = _train_arrays(np.random.default_rng(3), 1, PARITY_SLOTS)

    t0 = time.perf_counter()
    # oneDNN off on the CPU: its strided 1x1 conv backward has crashed
    # PyTorch's CPU build; the native convolutions compute the same
    cot_cpu = _EncoderCotangents(cpu)
    with torch.backends.mkldnn.flags(enabled=False):
        want = cpu.train_step(TrainBatch.from_numpy(arrays, "cpu"))
    cot_cpu.close()
    cpu_s = time.perf_counter() - t0
    _reset_counts()
    cot_gpu = _EncoderCotangents(gpu)
    t0 = time.perf_counter()
    got = gpu.train_step(TrainBatch.from_numpy(arrays, "cuda"))
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    cot_gpu.close()
    launches = _counts()
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel did not launch in the card's step: "
                             f"{launches}")
    rtol, atol = PARITY_LOSS_TOL
    for key, w in want.items():
        g = float(got[key])
        say(f"[train-parity] {key}: card {g:.6e} cpu {float(w):.6e} "
            f"(rtol {rtol:g}, atol {atol:g})")
        if not abs(g - float(w)) <= atol + rtol * abs(float(w)):
            raise AssertionError(f"{key}: card {g} vs CPU {float(w)}")
    failed = []
    for net, tol in PARITY_GRAD_TOL.items():
        cpu_params = dict(cpu.net(net).named_parameters())
        flat_g, flat_w, worst = [], [], []
        for k, p in gpu.net(net).named_parameters():
            if p.grad is None or cpu_params[k].grad is None:
                raise AssertionError(f"{net}.{k} got no gradient")
            g, w = p.grad.float().cpu(), cpu_params[k].grad
            flat_g.append(g.ravel())
            flat_w.append(w.ravel())
            worst.append((float((g - w).norm()), _rel_l2(g, w), k))
        rel = _rel_l2(torch.cat(flat_g), torch.cat(flat_w))
        phase = {"net_d": "D", "net_srd": "SRD"}.get(net, "G")
        say(f"[train-parity] {phase}-phase gradient of {net}: relative L2 "
            f"difference {rel:.3e} (limit {tol:g}); "
            f"largest differences: " + ", ".join(
                f"{k} {d:.2e} ({r:.2e} of its norm)"
                for d, r, k in sorted(worst, reverse=True)[:3]))
        if not rel <= tol:
            failed.append(f"{net} gradient differs by {rel}")
    if failed:
        raise AssertionError("; ".join(failed))
    say(f"[train-parity] train_step f32 B=1 N={PARITY_SLOTS}: card "
        f"{gpu_s * 1e3:.1f} ms (first call), CPU "
        f"({torch.get_num_threads()} threads) {cpu_s * 1e3:.1f} ms")
    _precision_report(gpu, cpu, start, arrays, cot_gpu.grads, cot_cpu.grads)


def phase_train(smi: str) -> dict:
    """Full-width f32 training throughput at batch 2 x 16 slots."""
    dev = torch.device("cuda", 0)
    trainer = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                              allow_random_lpips=True)
    gen = np.random.default_rng(4)
    batches = [TrainBatch.from_numpy(
        _train_arrays(gen, TRAIN_BATCH, TRAIN_SLOTS), dev) for _ in range(2)]
    params = {f"{n}.{k}": p for n in NETS
              for k, p in trainer.net(n).named_parameters()}
    before = {k: p.detach().clone() for k, p in params.items()}
    torch.cuda.reset_peak_memory_stats(dev)

    _reset_counts()
    trainer.train_step(batches[0])                 # warm-up
    torch.cuda.synchronize()
    _check_moved(params, before)
    del before
    marks, metrics = [], []
    for i in range(TRAIN_STEPS):
        metrics.append(trainer.train_step(batches[i % 2], marks=marks))
    torch.cuda.synchronize()
    launches = _counts()
    steps = TRAIN_STEPS + 1
    _check_counts("train", launches,
                  {k: v * steps for k, v in TRAIN_LAUNCHES.items()},
                  f"{steps} steps")

    if trainer.step != steps:
        raise AssertionError(f"step is {trainer.step}, expected {steps}")
    for m in metrics:
        for k, v in m.items():
            if not bool(torch.isfinite(v)):
                raise AssertionError(f"non-finite {k}")
    split = {"G": 0.0, "D": 0.0, "SRD": 0.0}
    for i in range(TRAIN_STEPS):
        m = marks[4 * i: 4 * i + 4]
        for j, phase in enumerate(split):
            split[phase] += m[j].elapsed_time(m[j + 1])
    total = marks[0].elapsed_time(marks[-1])
    ms = total / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    say(f"[train] f32 B={TRAIN_BATCH} slots={TRAIN_SLOTS} full width, "
        f"TF32 off: {ms:.2f} ms/step = {TRAIN_BATCH * 1e3 / ms:.3f} "
        f"samples/s over {TRAIN_STEPS} steps on {smi}")
    say("[train] split (ms/step): " + ", ".join(
        f"{k} {v / TRAIN_STEPS:.2f}" for k, v in split.items()))
    say(f"[train] peak device memory {peak:.2f} GiB; last losses: " +
        ", ".join(f"{k} {float(v):.4g}" for k, v in metrics[-1].items()))
    _profile_step(trainer, batches[0])
    return launches


def _check_moved(params: dict, before: dict) -> None:
    """After one step (no freeze groups) every parameter tensor with a
    gradient entry above 100 x Adam's eps moved: Adam's first update is
    about lr * sign(g) there. Tensors without one are named."""
    quiet = []
    for key, p in params.items():
        if p.grad is None:
            raise AssertionError(f"{key} got no gradient")
        if not bool((p.grad.abs() > 1e-6).any()):
            quiet.append(key)
        elif torch.equal(p.detach(), before[key]):
            raise AssertionError(f"{key} did not move")
    say(f"[train] after the warm-up step {len(params) - len(quiet)} of "
        f"{len(params)} parameter tensors moved; without a gradient above "
        f"1e-6: {quiet}")


_CUPTI_MARKER = "Command Buffer Full"


def _profile_step(trainer, batch) -> None:
    """Device busy time and the operators that take it, over one more
    training step (``torch.profiler``; counts outside the timed steps)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    # device activity (kernels, copies); CUPTI's "Command Buffer Full"
    # markers are not work
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name != _CUPTI_MARKER)
    if not spans:
        say("[train] profile: no device time recorded (not measured)")
        return
    busy, end = 0.0, spans[0][0]          # union of the spans, in us
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    busy /= 1e3
    window = (end - spans[0][0]) / 1e3
    ops = sorted(((e.self_device_time_total, e.key)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key != _CUPTI_MARKER
                  and e.self_device_time_total > 0), reverse=True)
    say(f"[train] profile of one step: device busy {busy:.2f} ms of a "
        f"{window:.2f} ms window (idle share {100 * (1 - busy / window):.2f}"
        f"%); self device time by op: " + ", ".join(
            f"{k} {t / 1e3:.2f} ms ({100 * t / 1e3 / busy:.1f}%)"
            for t, k in ops[:12]))


def main() -> None:
    smi = phase_device()
    phase_build()
    report = phase_kernels()
    phase_parity()
    serve = phase_serve(smi)
    phase_train_parity()
    train = phase_train(smi)
    kernels = [dict(name=name, **KERNELS[name],
                    launches=serve[name] + train[name], **report[name])
               for name in KERNELS]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
