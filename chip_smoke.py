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
   the card's memory rate and its operations over the f32 peak); K1's
   achieved GB/s beside the memory rate.
4. conv3x3: K3 (the 3x3 implicit-GEMM conv) on its paths, the SFT window
   convs of one serving batch in bf16 (12 launches, counted, all on the
   TMA + wgmma kernel) and in f32 (12 launches, all on the FMA kernel);
   then against its plain version at the four SFT window shapes in bf16
   (within one bf16 ulp) and in f32 (within 1e-5 of the largest value)
   and two ragged shapes in each, all against f64 ``F.conv2d``; kernel,
   bound, plain and cuDNN times. At the four bf16 SFT shapes the general
   mma.sync kernel runs on the same inputs too, held to the same ulp and
   timed beside the wgmma one, which must be faster.
5. parity: full-width f32 ``restore`` (B=1, 4 slots, 3 valid) on the card
   (kernels, TF32 off) against the CPU (plain versions), same seeded
   weights, within the tolerances of
   tests/test_convert.py::test_full_pipeline_chain_matches_torch.
6. serving: bf16 ``restore`` at full width on bench.py's workload (16
   lines of 8 characters) over several batches; checks shapes, finite
   values, sr in [-1, 1] and that every kernel of the path launched;
   prints crops/s from CUDA events and the per-stage split.
7. page server: full-width bf16 ``TextPageRestorer`` on a seeded page of
   48 lines (a quarter split into 2-3 segments), default buckets and
   bucket 16; checks results, stitching, equality with ``restore`` on
   each chunk, chunking invariance (in f32), exact K1 / K2 launches per
   chunk and that ``restore`` never synchronises with the host; prints
   lines/s, host prep and device time per chunk and the loop's idle
   share.
8. interpolation: full-width f32 ``interpolate_styles`` (11 blends of 8
   labels); its endpoints against ``generate_priors``.
9. training parity: one full-width f32 ``MARCONetTrainer.train_step``
   (B=1, 4 slots, random LPIPS explicitly allowed: the pretrained weights
   are not in the repository) on the card (kernels, TF32 off) against the
   CPU (plain versions), same seeded weights: every loss term of the G, D
   and SRD phases and each net's gradient (G phase: encoder, prior, SR
   net; D / SRD phase: the discriminators), within the tolerances
   printed; then the encoder's gradient with cuDNN off (held to 1e-3)
   and a report of where cuDNN's differs (cotangents, cuDNN modes, and
   every conv2d of the G phase against f64).
10. training throughput: full-width f32 steps at ``options/train.yml``'s
   batch 2 with 16 slots on batches from ``prepare_train_batch``; one
   warm-up step and timed steps; checks finite losses, that every
   parameter tensor with a gradient moved, the step count and the exact
   launches of the kernels per step; prints samples/s and the G / D
   / SRD split from CUDA events and the peak device memory.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from marconet_tpu_torch import native
from marconet_tpu_torch.data.batch_prep import prepare_train_batch
from marconet_tpu_torch.alphabet import alphabet
from marconet_tpu_torch.models.pipeline import BLANK_INDEX, MARCONet
from marconet_tpu_torch.models.srnet import window_geometry
from marconet_tpu_torch.ops.layers import nchw
from marconet_tpu_torch.ops.conv3x3 import (
    _conv3x3_mma_sync,
    conv3x3_path,
    conv3x3_same,
    conv3x3_same_plain,
)
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
from marconet_tpu_torch.serve import TextPageRestorer, _pack_uint8
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
# the card's peaks (NVIDIA H100 SXM data sheet, 700 W): HBM bytes/s, f32
# operations/s outside the tensor cores (K1, K1b, K2 and K3 in f32) and
# dense bf16 operations/s on the tensor cores (K3 in bf16)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
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
    "conv3x3_same": dict(
        route="cuda", source="marconet_tpu_torch/csrc/conv3x3_wgmma.cu",
        general_source="marconet_tpu_torch/csrc/conv3x3.cu",
        f32_source="marconet_tpu_torch/csrc/conv3x3_f32.cu",
        replaces="marconet_tpu/ops/pallas_conv.py:39"),
}
# launches per training step: 19 StyledConv / style-MLP activations in the
# prior (forward and backward), two SFT scales in the SR net; no model
# calls K3 (as in the JAX package)
TRAIN_LAUNCHES = {"fused_leaky_relu": 19, "fused_leaky_relu_bwd": 19,
                  "sft_writeback": 2, "sft_writeback_bwd": 2,
                  "conv3x3_same": 0}
# launches per restore (serving): no backward kernel, no K3
RESTORE_LAUNCHES = {"fused_leaky_relu": 19, "fused_leaky_relu_bwd": 0,
                    "sft_writeback": 2, "sft_writeback_bwd": 0,
                    "conv3x3_same": 0}


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


def _bound(nbytes: float, ops: float,
           ops_per_s: float = F32_OPS_PER_S) -> tuple:
    """(least ms, what bounds it) for ``nbytes`` moved and ``ops`` done at
    ``ops_per_s``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
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
                rate = ""
                if name == "fused_leaky_relu":    # x and y once, the bias
                    nbytes = (2 * n + c) * size
                    rate = (f", {nbytes / ms / 1e6:.1f} GB/s of "
                            f"{HBM_BYTES_PER_S / 1e9:.0f}")
                say(f"[kernels] {short} {label} {dn}: max_abs_err={err} "
                    f"kernel {ms:.4f} ms{rate}, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms ({bound_by})")
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
             "sft_writeback_bwd": sft_writeback_bwd,
             "conv3x3_same": conv3x3_same}


def _reset_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
    conv3x3_same.launches_by_path = dict.fromkeys(
        conv3x3_same.launches_by_path, 0)


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
    _check_counts("serve", launches,
                  {k: v * calls for k, v in RESTORE_LAUNCHES.items()},
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


# ---------------------------------------------------------------------------
# K3: the SR net's SFT window convs
# ---------------------------------------------------------------------------

SFT_WINDOWS = SERVE_BATCH * SERVE_SLOTS   # 128 windows per serving batch
# (N, H, W, CI, CO, dtype) of K3's checks: the four SFT window conv shapes
# of the serving batch (the fuse block's 512 -> 256 conv; 256 -> 256 for
# its second conv and the scale / shift stacks; at the 64- and 32-high
# scales) in bf16 and in f32, and two ragged shapes in each dtype
K3_SFT_SHAPES = [(SFT_WINDOWS, 64, 64, 512, 256),
                 (SFT_WINDOWS, 64, 64, 256, 256),
                 (SFT_WINDOWS, 32, 32, 512, 256),
                 (SFT_WINDOWS, 32, 32, 256, 256)]
K3_CASES = [*[(*sh, torch.bfloat16) for sh in K3_SFT_SHAPES],
            *[(*sh, torch.float32) for sh in K3_SFT_SHAPES],
            (3, 7, 13, 40, 24, torch.bfloat16),
            (2, 9, 64, 300, 130, torch.bfloat16),
            (3, 7, 13, 40, 24, torch.float32),
            (2, 9, 64, 300, 130, torch.float32)]
K3_REPORTED = K3_CASES[0]
# the f32 case whose numbers the kernels line carries beside the bf16 ones
K3_REPORTED_F32 = (SFT_WINDOWS, 64, 64, 256, 256, torch.float32)
# per scale: the fuse block's 512 -> 256 conv, its 256 -> 256 conv and two
# 256 -> 256 convs in each of the scale and shift stacks
K3_PATH_CI = (512, 256, 256, 256, 256, 256)
# bf16: the kernel and the plain version round one f32 sum each, taken in
# different orders, so they may differ by one bf16 ulp. The ulp is taken at
# max(|plain|, rms(plain) / 16): below that magnitude the two sums' order
# alone (about 2**-24 * K**0.5 * rms, K = 9 * CI) could move a value near 0
# by more than its own ulp; the floor's ulp is > 10x that.
K3_BF16_ULP_FLOOR = 16
K3_F32_TOL = 1e-5        # max |kernel - plain| <= 1e-5 * max |plain|
K3_ORACLE_WINDOWS = 8    # windows of each case recomputed in f64
K3_ORACLE_RATIO = 2.0    # kernel's f64 error <= 2x the plain version's


def _k3_weight(ci: int, co: int, dtype, tgen) -> torch.Tensor:
    """(3, 3, ci, co) HWIO with unit output variance for unit inputs."""
    w = torch.randn(3, 3, ci, co, device=tgen.device, generator=tgen)
    return (w / math.sqrt(9 * ci)).to(dtype)


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """Largest |got - want| in bf16 ulps of max(|want|, rms(want) / 16),
    and the share of elements that differ."""
    g, w = got.float(), want.float()
    floor = float(w.square().mean().sqrt()) / K3_BF16_ULP_FLOOR
    _, e = torch.frexp(w.abs().clamp_min(floor))    # m * 2**e, m in [.5, 1)
    ulp = torch.ldexp(torch.ones_like(g), e - 8)    # bf16 keeps 8 bits
    d = (g - w).abs()
    return float((d / ulp).max()), float((d > 0).float().mean())


def _k3_old_design(x, wt, want, iters: int) -> tuple:
    """The general mma.sync kernel on an SFT case that the rule sends to
    wgmma: (its largest error in bf16 ulps of the plain version, ms)."""
    ulps, _ = _bf16_ulps(_conv3x3_mma_sync(x, wt), want)
    return ulps, cuda_ms(lambda: _conv3x3_mma_sync(x, wt), iters=iters)


def _k3_path(dtype, tgen) -> tuple:
    """The SFT window convs of one serving batch (128 windows) at both
    scales, chained as the SR net's stacks would run them, through
    ``conv3x3_same`` in ``dtype``: (launches, launches by path), counted
    from 0 just before and read just after."""
    dev = tgen.device
    _reset_counts()
    for hw in (32, 64):
        x = torch.randn(SFT_WINDOWS, hw, hw, 512, device=dev,
                        generator=tgen).to(dtype)
        for ci in K3_PATH_CI:
            x = conv3x3_same(x, _k3_weight(ci, 256, dtype, tgen))
        if tuple(x.shape) != (SFT_WINDOWS, hw, hw, 256) or \
                not bool(torch.isfinite(x).all()):
            raise AssertionError(f"K3 {dtype} path at {hw}x{hw}: shape "
                                 f"{tuple(x.shape)} or non-finite values")
    torch.cuda.synchronize()
    return _counts(), dict(conv3x3_same.launches_by_path)


def phase_conv3x3(smi: str) -> tuple:
    """K3 on its paths, then against its plain version.

    The paths: the SFT window convs of one serving batch (128 windows) at
    both scales, chained as the SR net's stacks would run them, through
    ``conv3x3_same``: in bf16 (12 launches, counted, every one on the
    wgmma kernel) and in f32 (12 launches, every one on the FMA kernel).
    Then each of ``K3_CASES``: kernel against plain (bf16 within one ulp,
    f32 within 1e-5 of the largest value), both against an f64
    ``F.conv2d`` on the first windows (the kernel's error at most twice the
    plain version's), and CUDA-event times of the kernel, the plain version
    and cuDNN's ``F.conv2d`` on the same data (TF32 off), beside the bound.
    At the four bf16 SFT shapes the general mma.sync kernel (the design the
    wgmma kernel replaced there) runs on the same inputs, within the same
    ulp, timed in turns with the wgmma kernel, which must be the faster.
    """
    dev = torch.device("cuda", 0)
    tgen = torch.Generator(device=dev).manual_seed(5)
    n_path = 2 * len(K3_PATH_CI)
    launches = dict.fromkeys(_WRAPPERS, 0)
    by_path = dict.fromkeys(conv3x3_same.launches_by_path, 0)
    # the f32 path draws from a generator of its own: the bf16 path and the
    # cases below keep their inputs whatever it draws
    for dtype, route, gen in (
            (torch.bfloat16, "wgmma", tgen),
            (torch.float32, "fma",
             torch.Generator(device=dev).manual_seed(6))):
        counts, paths = _k3_path(dtype, gen)
        dn = str(dtype).removeprefix("torch.")
        _check_counts("conv3x3", counts, {
            k: n_path if k == "conv3x3_same" else 0 for k in _WRAPPERS},
            f"the SFT window convs of one serving batch in {dn}")
        say(f"[conv3x3] K3 launches by path over those convs in {dn}: "
            f"{paths}")
        want = {p: n_path if p == route else 0 for p in paths}
        if paths != want:
            raise AssertionError(f"the {dn} SFT window convs did not all "
                                 f"take the {route} kernel: {paths}")
        for k in launches:
            launches[k] += counts[k]
        for p in by_path:
            by_path[p] += paths[p]

    report = {"max_abs_err": 0.0}
    # ms of each path's 12 convs
    path = {"wgmma": 0.0, "mma.sync": 0.0, "bound": 0.0, "cuDNN": 0.0}
    path_f32 = {"fma": 0.0, "bound": 0.0, "cuDNN": 0.0}
    for case in K3_CASES:
        n, h, w, ci, co, dtype = case
        dn = str(dtype).removeprefix("torch.")
        x = torch.randn(n, h, w, ci, device=dev, generator=tgen).to(dtype)
        wt = _k3_weight(ci, co, dtype, tgen)
        route = conv3x3_path(tuple(x.shape), tuple(wt.shape), dtype,
                             x.data_ptr() % 16 == 0
                             and wt.data_ptr() % 16 == 0)
        sft = n == SFT_WINDOWS and dtype == torch.bfloat16
        if sft and route != "wgmma":
            raise AssertionError(f"{case} takes {route}, not wgmma")
        if dtype == torch.float32 and route != "fma":
            raise AssertionError(f"{case} takes {route}, not fma")
        got = conv3x3_same(x, wt)
        want = conv3x3_same_plain(x, wt)
        err = max_abs(got, want)
        if dtype == torch.bfloat16:
            ulps, share = _bf16_ulps(got, want)
            check = (f"{ulps:.3f} ulp (limit 1), {share:.3e} of elements "
                     f"differ")
            ok = ulps <= 1.0
        else:
            limit = K3_F32_TOL * float(want.abs().max())
            check = f"limit {limit:.3e}"
            ok = err <= limit
        k = min(n, K3_ORACLE_WINDOWS)
        ref = F.conv2d(x[:k].double().permute(0, 3, 1, 2),
                       wt.double().permute(3, 2, 0, 1), padding=1
                       ).permute(0, 2, 3, 1)
        e_kern = float((got[:k].double() - ref).abs().max())
        e_plain = float((want[:k].double() - ref).abs().max())
        del ref
        flops = 2.0 * n * h * w * 9 * ci * co
        size = x.element_size()
        bound_ms, bound_by = _bound(
            (x.numel() + wt.numel() + n * h * w * co) * size, flops,
            BF16_TC_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S)
        iters = 5 if flops > 1e11 else 20
        x_nchw = x.permute(0, 3, 1, 2)             # NHWC storage, no copy
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        ms = cuda_ms(lambda: conv3x3_same(x, wt), iters=iters)
        old = ""
        if sft:     # in turns: wgmma, mma.sync, mma.sync, wgmma
            old_ulps, old_a = _k3_old_design(x, wt, want, iters)
            old_ulps, old_b = _k3_old_design(x, wt, want, iters)
            old_ms = (old_a + old_b) / 2
            ms = (ms + cuda_ms(lambda: conv3x3_same(x, wt), iters=iters)) / 2
            old = (f"; the mma.sync kernel on the same inputs {old_ms:.4f} "
                   f"ms ({old_ulps:.3f} ulp), {old_ms / ms:.2f}x the wgmma "
                   f"kernel's time")
        plain_ms = cuda_ms(lambda: conv3x3_same_plain(x, wt),
                           iters=2 if iters == 5 else 10, warmup=1)
        lib_ms = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1),
                         iters=iters)
        say(f"[conv3x3] K3 ({n}, {h}, {w}, {ci} -> {co}) {dn}, {route}: "
            f"max_abs_err={err:.3e} ({check}); against f64 over {k} "
            f"windows: kernel {e_kern:.3e}, plain {e_plain:.3e} (limit "
            f"{K3_ORACLE_RATIO:g}x plain); kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% "
            f"of the bound), bound {bound_ms:.4f} ms ({bound_by}), plain "
            f"{plain_ms:.4f} ms, cuDNN {lib_ms:.4f} ms "
            f"({flops / lib_ms / 1e9:.1f} TFLOP/s){old}")
        if not ok:
            raise AssertionError(f"conv3x3_same differs from its plain "
                                 f"version at {case}: {check}, {err}")
        if not e_kern <= K3_ORACLE_RATIO * e_plain:
            raise AssertionError(f"conv3x3_same's error against f64 at "
                                 f"{case} is {e_kern}, plain {e_plain}")
        report["max_abs_err"] = max(report["max_abs_err"], err)
        if sft:
            if not old_ulps <= 1.0:
                raise AssertionError(f"the mma.sync kernel differs from "
                                     f"the plain version at {case} by "
                                     f"{old_ulps} ulp")
            if not ms < old_ms:
                raise AssertionError(f"the wgmma kernel ({ms} ms) is not "
                                     f"faster than mma.sync ({old_ms} ms) "
                                     f"at {case}")
            uses = K3_PATH_CI.count(ci)         # once per scale
            for key, t in (("wgmma", ms), ("mma.sync", old_ms),
                           ("bound", bound_ms), ("cuDNN", lib_ms)):
                path[key] += uses * t
        elif n == SFT_WINDOWS:      # f32
            uses = K3_PATH_CI.count(ci)
            for key, t in (("fma", ms), ("bound", bound_ms),
                           ("cuDNN", lib_ms)):
                path_f32[key] += uses * t
        if case == K3_REPORTED:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib_ms,
                          mma_sync_ms=old_ms)
        if case == K3_REPORTED_F32:
            report.update(f32_ms=ms, f32_plain_ms=plain_ms,
                          f32_bound_ms=bound_ms, f32_library_ms=lib_ms)
        del x, wt, got, want, x_nchw, w_oihw
    torch.cuda.empty_cache()
    for dn, times in (("bf16", path), ("f32", path_f32)):
        say(f"[conv3x3] the {n_path} {dn} SFT window convs of one serving "
            f"batch, from the times above: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in times.items()) + f"; on {smi}")
    report["launches_by_path"] = by_path
    return report, launches


# ---------------------------------------------------------------------------
# the page server
# ---------------------------------------------------------------------------

PAGE_LINES = 48
# chunking invariance, bucket 16 against bucket 64, held in f32 (TF32 off):
# cuDNN picks its algorithms by batch size, so sums are taken in other
# orders, which moves f32 outputs by ~4e-4 of [-1, 1] (0.05 of a level).
# In bf16 the same reordering moves the random-weight nets' outputs by
# tens of levels (``_batch_sensitivity`` prints how far), so bf16 is
# measured and printed, not held.
# The share's limit is 4x the 5.06e-4 measured on an H100 (pixels whose f32
# value lies within 4e-4 of a rounding boundary flip by one level).
PAGE_INVARIANCE_MAX = 1          # uint8 levels
PAGE_INVARIANCE_SHARE = 2e-3     # of pixels that may differ


def _page(gen: np.random.Generator) -> tuple:
    """A seeded page of ``PAGE_LINES`` line crops stacked down a noise
    page: heights 40-72 px; widths at height 32 of 64-500 px, and 530-1400
    px for a quarter of the lines (split into 2-3 segments); each line's
    text is 2-4 alphabet characters in its first third, 5-8 in the second
    and 9-16 in the last (so chunks of 16 segments use 4, 8 and 16 slots),
    with evenly spaced character boxes."""
    chars = alphabet()
    heights = gen.integers(40, 73, PAGE_LINES)
    wide = np.zeros(PAGE_LINES, bool)
    wide[gen.permutation(PAGE_LINES)[:PAGE_LINES // 4]] = True
    w32 = np.where(wide, gen.integers(530, 1401, PAGE_LINES),
                   gen.integers(64, 501, PAGE_LINES))
    widths = w32 * heights // 32
    third = np.arange(PAGE_LINES) * 3 // PAGE_LINES
    n_chars = np.choose(third, [gen.integers(2, 5, PAGE_LINES),
                                gen.integers(5, 9, PAGE_LINES),
                                gen.integers(9, 17, PAGE_LINES)])
    page = gen.integers(0, 256, (int(heights.sum()), int(widths.max()), 3),
                        dtype=np.uint8)
    boxes, texts, char_boxes = [], [], []
    y = 0
    for h, w, n in zip(heights.tolist(), widths.tolist(), n_chars.tolist()):
        boxes.append((0, y, w, y + h))
        texts.append("".join(chars[i] for i in
                             gen.integers(0, BLANK_INDEX, n)))
        edges = np.linspace(0.0, w, n + 1)
        char_boxes.append([(edges[i] + 1.0, 2.0, edges[i + 1] - 1.0,
                            h - 2.0) for i in range(n)])
        y += h
    return page, boxes, texts, char_boxes


def _busy(prof) -> tuple:
    """(device busy ms, window ms) of a ``torch.profiler`` run: the union
    of the device's activity spans (kernels, copies; CUPTI's "Command
    Buffer Full" markers are not work), or None when none was recorded."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name != _CUPTI_MARKER)
    if not spans:
        return None
    busy, end = 0.0, spans[0][0]          # union of the spans, in us
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy / 1e3, (end - spans[0][0]) / 1e3


def _check_page(results, segments, groups, texts, line_boxes) -> None:
    """One result per line box; stitched widths (each segment shows
    round(width * 128 / height) columns of its x4 output, at most 2048),
    texts and prior counts as ``tests/test_serve.py`` expects."""
    if len(results) != len(line_boxes):
        raise AssertionError(f"{len(results)} results for "
                             f"{len(line_boxes)} line boxes")
    for res, idxs, text in zip(results, groups, texts):
        want_w = sum(min(int(round(segments[j].image.shape[1] * 128
                                   / segments[j].image.shape[0])), 2048)
                     for j in idxs)
        if res.sr.shape != (128, want_w, 3) or res.sr.dtype != np.uint8:
            raise AssertionError(f"stitched sr {res.sr.shape} "
                                 f"{res.sr.dtype}, expected (128, {want_w},"
                                 f" 3) uint8")
        if res.text != text or res.priors.shape != (len(text), 128, 128, 3):
            raise AssertionError(f"text {res.text!r} / priors "
                                 f"{res.priors.shape} for {text!r}")


def _stitch(parts, groups) -> list:
    return [np.concatenate([parts[j].sr for j in idxs], axis=1)
            for idxs in groups]


def _page_diff(results, stitched) -> tuple:
    """(largest uint8 difference, share of pixels that differ) between
    the stitched lines of two runs."""
    diff = np.concatenate([np.abs(a.sr.astype(int) - b.astype(int)).ravel()
                           for a, b in zip(results, stitched)])
    return int(diff.max()), float((diff > 0).mean())


def _batch_sensitivity() -> None:
    """How far restore moves with the batch it runs in: 16 seeded lines
    (8 slots) alone and as the first half of a batch of 32 (the same 16
    twice), in bf16 and in f32; largest difference of the encoder's w and
    of sr over the 16 lines. Printed, not held."""
    inputs = [t.cuda() for t in _lines(np.random.default_rng(8), 16, 8, 8,
                                       [0.06 + 0.11 * c for c in range(8)])]
    doubled = [torch.cat([t, t]) for t in inputs]
    for dtype in (torch.bfloat16, torch.float32):
        net = MARCONet(dtype=dtype, device="cuda", seed=0)
        alone, twice = net.restore(*inputs), net.restore(*doubled)
        say(f"[page] restore of 16 lines alone vs in a batch of 32, "
            f"{str(dtype).removeprefix('torch.')}: w max_abs_diff "
            f"{max_abs(alone.w, twice.w[:16]):.3e}, sr "
            f"{max_abs(alone.sr, twice.sr[:16]):.3e}")
        del net, alone, twice
    torch.cuda.empty_cache()


def _page_invariance(page, line_boxes, texts, char_boxes) -> None:
    """The page's lines of up to 8 characters in f32 (TF32 off), default
    buckets (one chunk of 64 at 8 slots) against bucket 16: within
    ``PAGE_INVARIANCE_MAX`` levels on at most ``PAGE_INVARIANCE_SHARE`` of
    the pixels. (64 lines at 16 slots in f32 do not fit in 80 GB.)"""
    keep = [i for i, t in enumerate(texts) if len(t) <= 8]
    line_boxes, texts, char_boxes = ([seq[i] for i in keep] for seq in
                                     (line_boxes, texts, char_boxes))
    net = MARCONet(dtype=torch.float32, device="cuda", seed=0)
    res64 = TextPageRestorer(net).restore_page(page, line_boxes, texts,
                                               char_boxes)
    res16 = TextPageRestorer(net, buckets=(16,)).restore_page(
        page, line_boxes, texts, char_boxes)
    levels, share = _page_diff(res64, [r.sr for r in res16])
    say(f"[page] f32, {len(keep)} lines of <= 8 characters, default "
        f"buckets vs bucket 16: max {levels} uint8 levels, {share:.3e} of "
        f"pixels differ (limits "
        f"{PAGE_INVARIANCE_MAX}, {PAGE_INVARIANCE_SHARE:g})")
    if levels > PAGE_INVARIANCE_MAX or share > PAGE_INVARIANCE_SHARE:
        raise AssertionError("chunking changed the page's pixels")
    del net
    torch.cuda.empty_cache()


def phase_page(smi: str) -> dict:
    """``TextPageRestorer`` on a seeded page, full-width bf16.

    ``restore_page`` with the default buckets, then ``restore_lines`` over
    the same segments with bucket 16 (>= 4 chunks): one result per line,
    stitched widths and texts; each bucket-16 result equal to
    ``_pack_uint8`` of ``MARCONet.restore`` on the same chunk; exact
    launches of K1 and K2 per chunk; buckets 16 and 64 within one uint8
    level when the page is run again in f32 (``_page_invariance``);
    no host synchronisation inside ``restore``. Prints warm lines/s, the
    host prep and device time per chunk and the device's idle share over
    the loop (``torch.profiler``).
    """
    net = MARCONet(dtype=torch.bfloat16, device="cuda", seed=0)
    page, line_boxes, texts, char_boxes = _page(np.random.default_rng(6))
    page_server = TextPageRestorer(net)
    lines16 = TextPageRestorer(net, buckets=(16,))
    segments, groups = lines16._page_requests(page, line_boxes, texts,
                                              char_boxes)
    n_seg = len(segments)
    n_wide = sum(len(g) > 1 for g in groups)
    launches = dict.fromkeys(_WRAPPERS, 0)

    def counted(what: str, chunks: int, fn):
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = _counts()
        _check_counts("page", got, {k: v * chunks for k, v in
                                    RESTORE_LAUNCHES.items()}, what)
        for k, v in got.items():
            launches[k] += v
        return out

    b64 = page_server._bucket(n_seg)
    page_res = counted(f"restore_page, bucket {b64}", -(-n_seg // b64),
                       lambda: page_server.restore_page(
                           page, line_boxes, texts, char_boxes))
    _check_page(page_res, segments, groups, texts, line_boxes)
    chunks16 = -(-n_seg // 16)
    res16 = counted(f"restore_lines, bucket 16, {chunks16} chunks",
                    chunks16, lambda: lines16.restore_lines(segments))
    stitched16 = _stitch(res16, groups)

    # each bucket-16 result against restore on the same chunk, called
    # directly; device time per chunk from CUDA events
    chunk_ms, slots = [], []
    for c, start in enumerate(range(0, n_seg, 16)):
        reqs = segments[start:start + 16]
        chunk = lines16._chunk(reqs, 16)
        slots.append(chunk.inputs[1].shape[1])
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = net.restore(*chunk.inputs)
        sr, priors = _pack_uint8(out.sr), _pack_uint8(out.priors)
        ev1.record()
        torch.cuda.synchronize()
        chunk_ms.append(ev0.elapsed_time(ev1))
        sr, priors = sr.cpu().numpy(), priors.cpu().numpy()
        for i, r in enumerate(res16[start:start + 16]):
            n_ch = r.priors.shape[0]
            if not (np.array_equal(r.sr, sr[i, :, :r.sr.shape[1]]) and
                    np.array_equal(r.priors, priors[i, :n_ch])):
                raise AssertionError(f"chunk {c} line {i}: restore_lines "
                                     f"differs from restore on its chunk")
    if set(slots) != {4, 8, 16}:
        raise AssertionError(f"slot buckets of the chunks: {slots}")
    say(f"[page] {PAGE_LINES} lines ({n_wide} split) -> {n_seg} segments; "
        f"bucket 16: {chunks16} chunks with {slots} slots, each result "
        f"equal to restore + _pack_uint8 on its chunk")

    levels, share = _page_diff(page_res, stitched16)
    say(f"[page] bf16, buckets {b64} vs 16 (measured, not held): max "
        f"{levels} uint8 levels, {share:.3e} of pixels differ")

    # no host synchronisation inside restore (it would serialise the loop)
    chunk = lines16._chunk(segments[:16], 16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _pack_uint8(net.restore(*chunk.inputs).sr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()]
    say(f"[page] host synchronisations inside restore + pack: {len(syncs)}"
        + "".join(f"\n  {m}" for m in syncs))
    if syncs:
        raise AssertionError("restore synchronises with the host")

    # warm throughput, host prep per chunk, idle share of the loop
    prep = []
    make_chunk = lines16._chunk

    def timed_chunk(reqs, b):
        t0 = time.perf_counter()
        c = make_chunk(reqs, b)
        prep.append(time.perf_counter() - t0)
        return c

    lines16._chunk = timed_chunk
    t0 = time.perf_counter()
    lines16.restore_page(page, line_boxes, texts, char_boxes)
    t16 = time.perf_counter() - t0
    t0 = time.perf_counter()
    page_server.restore_page(page, line_boxes, texts, char_boxes)
    t64 = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lines16.restore_lines(segments)
        torch.cuda.synchronize()
    lines16._chunk = make_chunk
    busy = _busy(prof)
    idle = ("not measured (no device time recorded)" if busy is None else
            f"device busy {busy[0]:.2f} ms of a {busy[1]:.2f} ms window, "
            f"idle share {100 * (1 - busy[0] / busy[1]):.2f}%")
    say(f"[page] warm restore_page bf16, bucket 16: {t16 * 1e3:.1f} ms = "
        f"{PAGE_LINES / t16:.2f} lines/s ({n_seg / t16:.2f} segments/s); "
        f"default buckets ({b64}): {t64 * 1e3:.1f} ms = "
        f"{PAGE_LINES / t64:.2f} lines/s; on {smi}")
    say(f"[page] bucket 16 per chunk: host prep "
        f"{1e3 * sum(prep[:chunks16]) / chunks16:.2f} ms, device (restore "
        f"+ pack) {sum(chunk_ms) / len(chunk_ms):.2f} ms "
        f"({', '.join(f'{m:.2f}' for m in chunk_ms)}); profile of "
        f"restore_lines: {idle}")
    del net
    torch.cuda.empty_cache()
    _batch_sensitivity()
    _page_invariance(page, line_boxes, texts, char_boxes)
    return launches


# ---------------------------------------------------------------------------
# style interpolation
# ---------------------------------------------------------------------------

INTERP_S, INTERP_N = 11, 8
# f32, TF32 off: a prior batch of 88 slots against one of 8, so cuDNN may
# take other algorithms and sum in other orders
INTERP_TOL = 1e-4


def phase_interpolate() -> None:
    """``interpolate_styles`` at full width in f32, S=11 blends of N=8
    labels between the styles of two encoded lines; its endpoints against
    ``generate_priors`` at each style."""
    net = MARCONet(dtype=torch.float32, device="cuda", seed=0)
    gen = np.random.default_rng(7)
    lq = torch.from_numpy(gen.uniform(-1, 1, (2, 32, 512, 3))
                          .astype(np.float32))
    _, _, w = net.encode(lq)
    labels = torch.from_numpy(gen.integers(0, BLANK_INDEX, INTERP_N))
    weights = torch.linspace(0.0, 1.0, INTERP_S)
    imgs = net.interpolate_styles(w[0], w[1], labels, weights)
    torch.cuda.synchronize()
    if tuple(imgs.shape) != (INTERP_S, INTERP_N, 128, 128, 3) or \
            not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"interpolate_styles: {tuple(imgs.shape)} or "
                             f"non-finite values")
    errs = []
    with torch.inference_mode():
        for i, style in ((0, w[1]), (-1, w[0])):   # weight 0: w2; 1: w1
            pri = net.generate_priors(style[None], labels[None].cuda())
            errs.append(max_abs(imgs[i], pri.image.permute(0, 2, 3, 1)))
    ms = cuda_ms(lambda: net.interpolate_styles(w[0], w[1], labels,
                                                weights), iters=3, warmup=1)
    say(f"[interpolate] f32 S={INTERP_S} N={INTERP_N}: endpoints against "
        f"generate_priors max_abs_diff {errs[0]:.3e} (w2), {errs[1]:.3e} "
        f"(w1) (limit {INTERP_TOL:g}); {ms:.2f} ms")
    if max(errs) > INTERP_TOL:
        raise AssertionError(f"interpolate_styles endpoints differ by "
                             f"{errs}")
    del net
    torch.cuda.empty_cache()



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
    if min(launches[k] for k, v in TRAIN_LAUNCHES.items() if v) == 0:
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
    if _busy(prof) is None:
        say("[train] profile: no device time recorded (not measured)")
        return
    busy, window = _busy(prof)
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
    report["conv3x3_same"], k3 = phase_conv3x3(smi)
    phase_parity()
    serve = phase_serve(smi)
    page = phase_page(smi)
    phase_interpolate()
    phase_train_parity()
    train = phase_train(smi)
    kernels = [dict(name=name, **KERNELS[name],
                    launches=k3[name] + serve[name] + page[name]
                    + train[name], **report[name])
               for name in KERNELS]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
