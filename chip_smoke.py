#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``marconet_tpu_torch``) once on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It checks and times the port's hand-written kernels; the nets and the
entry points on the card are held against the CPU by the ``cuda``-marked
tests (``tests/test_torch_cuda.py``, ``tests/test_torch_cuda_nets.py``),
and the port's speed is measured by ``port_bench/``. Phases, each
printing its own lines; any failure raises and exits nonzero:

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
   achieved GB/s beside the memory rate. The backward kernels report f32
   and bf16 (``bf16_*`` keys) at the largest training shape, and are held
   on their pack-of-one paths too (C a multiple of neither 16-byte pack,
   and x or g one element past an aligned address).
4. conv3x3: K3 (the 3x3 implicit-GEMM conv) on its paths, the SFT window
   convs of one serving batch in bf16 (12 launches, counted, all on the
   TMA + wgmma kernel) and in f32 (12 launches, all on the FMA kernel);
   then against its plain version at the four SFT window shapes in bf16
   (within one bf16 ulp) and in f32 (within 1e-5 of the largest value)
   and two ragged shapes in each, all against f64 ``F.conv2d``; kernel,
   bound, plain and cuDNN times. At the four bf16 SFT shapes the general
   mma.sync kernel runs on the same inputs too, held to the same ulp and
   timed beside the wgmma one, which must be faster.
5. nets: one full-width f32 ``MARCONet.restore`` (B=1, 4 slots, 3 valid)
   and one full-width f32 ``MARCONetTrainer.train_step`` (B=2, 16 slots),
   each with the kernels' launch counters set to 0 just before it and
   read just after; outputs and losses must be finite, a restore must
   launch K1 and K2 and no backward kernel, and a step every K1 / K2
   launch's backward once. Their values are held against the CPU by
   ``tests/test_torch_cuda_nets.py``, which also owns the exact counts.
The line before the last is a JSON object describing each kernel, with
its launches in that restore and that step; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from marconet_tpu_torch import native
from marconet_tpu_torch.alphabet import BLANK_INDEX
from marconet_tpu_torch.dryrun import seeded_batch
from marconet_tpu_torch.models.pipeline import MARCONet
from marconet_tpu_torch.models.srnet import window_geometry
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
from marconet_tpu_torch.train.train_step import (
    MARCONetTrainer,
    TrainBatch,
    TrainConfig,
)

SERVE_BATCH = 16    # bench.py's workload: 16 lines of 8 characters
SERVE_SLOTS = 8
TRAIN_BATCH = 2     # options/train.yml:20 batch_size_per_gpu
TRAIN_SLOTS = 16
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
             height: int, width: int, hw: int, dtype, dev, c: int = 256):
    """The sft_32 / sft_64 write-back shapes with S=16 slots: rows mix
    overlapping windows, truncated edge windows and invalid slots."""
    s = 16
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


def _bf16_row(ms, plain_ms, bound_ms, bound_by) -> dict:
    """A backward kernel's bf16 numbers beside its f32 ones (the bf16
    training step runs them), with the kernel's share of its bound."""
    return dict(bf16_ms=ms, bf16_plain_ms=plain_ms, bf16_bound_ms=bound_ms,
                bf16_bound_by=bound_by, bf16_share=bound_ms / ms)


def phase_kernels() -> dict:
    """Each kernel against its plain version at the main paths' shapes.

    K1 / K2 at the serving shapes (bf16 restore) and the training shapes;
    K1b / the write-back's backward at the training shapes (the only path
    that runs them), f32 and bf16 each. The report keeps, per kernel, the
    largest error and the times and bound of its reported case: bf16 at
    the largest serving shape for K1 / K2 (as in earlier runs), f32 at the
    largest training shape for the backward kernels, and beside it that
    shape's bf16 numbers (``bf16_*``, the bf16 training step's).
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
                elif name == "fused_leaky_relu_bwd" and x.dim() == 4:
                    rep.update(_bf16_row(ms, plain_ms, bound_ms, bound_by))
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
                elif name == "sft_writeback_bwd" and label == "sft_64 train":
                    rep.update(_bf16_row(ms, plain_ms, bound_ms, bound_by))
            del canvas, res, g
    _pack_of_one_cases(gen, tgen, dev, report)
    torch.cuda.empty_cache()
    for rep in report.values():
        rep["library_ms"] = None      # no one PyTorch call computes these
    return report


def _misaligned(shape, dtype, dev, tgen) -> torch.Tensor:
    """A contiguous tensor one element past a 16-byte aligned address."""
    n = math.prod(shape)
    buf = torch.randn(n + 1, device=dev, generator=tgen).to(dtype)
    out = buf[1:].view(shape)
    assert out.data_ptr() % 16 != 0
    return out


def _pack_of_one_cases(gen, tgen, dev, report) -> None:
    """The backward kernels where 16-byte packs do not fit, so each runs
    with a pack of one element: C = 127 (K1b) / 254 (K2 bwd), a multiple of
    neither pack (8 bf16, 4 f32), and a 16-byte pack's C with x or g one
    element past an aligned address; bit-exact to the plain versions."""
    rows = TRAIN_BATCH * TRAIN_SLOTS
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        size = torch.tensor([], dtype=dtype).element_size()
        odd = (rows, 64, 64, 127)               # NHWC storage
        x = torch.randn(odd, device=dev, generator=tgen).to(dtype)
        g = torch.randn(odd, device=dev, generator=tgen).to(dtype)
        k1b = {f"C=127 ({rows}, 127, 64, 64)": (x.permute(0, 3, 1, 2),
                                               g.permute(0, 3, 1, 2)),
               f"misaligned x ({rows * 64 * 64}, 128)":
                   (_misaligned((rows * 64 * 64, 128), dtype, dev, tgen),
                    torch.randn(rows * 64 * 64, 128, device=dev,
                                generator=tgen).to(dtype))}
        for label, (x, g) in k1b.items():
            bias = torch.randn(x.shape[1], device=dev, generator=tgen)
            n, c = x.numel(), x.shape[1]
            _held("fused_leaky_relu_bwd", f"K1b {label}", dn, report,
                  lambda: fused_leaky_relu_bwd(x, bias, g),
                  lambda: fused_leaky_relu_bwd_plain(x, bias, g),
                  _bound(3 * n * size + c * size, 3 * n))
        del x, g, k1b
        height, width, hw = 64, 1024, 32
        for label, c, shift in (("C=254", 254, False),
                                ("misaligned g, C=256", 256, True)):
            canvas, res, x1, length, valid = _k2_case(
                gen, tgen, TRAIN_BATCH, height, width, hw, dtype, dev, c)
            win = 2 * hw
            cov = _covered_columns(x1, length, valid, width, win)
            g = (_misaligned(canvas.shape, dtype, dev, tgen) if shift else
                 torch.randn(canvas.shape, device=dev, generator=tgen).to(
                     dtype))
            tables = 3 * x1.numel() * 4
            _held("sft_writeback_bwd",
                  f"K2 backward sft_64 train {label} B={TRAIN_BATCH}", dn,
                  report,
                  lambda: sft_writeback_bwd(g, x1, length, valid, win),
                  lambda: sft_writeback_bwd_plain(g, x1, length, valid,
                                                  win),
                  _bound((res.numel() + cov * height * c) * size + tables,
                         0))
            del canvas, res, g


def _held(name, label, dn, report, kern, plain, bound) -> None:
    """One case of a kernel held bit-exact to its plain version, timed."""
    bound_ms, bound_by = bound
    err = max_abs(kern(), plain())
    ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    say(f"[kernels] {label} {dn} (pack of one): max_abs_err={err} kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    _check_exact(name, f"{label}, {dn}", err)
    report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)


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


def phase_conv3x3(smi: str) -> dict:
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
    return report


def _launched(fn) -> tuple:
    """(``fn()``, the kernel launches it made): the counters are set to 0
    just before the call and read just after it."""
    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, _counts()


def phase_nets() -> dict:
    """Phase 5 (see the module docstring): {"restore": launches, "step":
    launches}."""
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(5)
    net = MARCONet(dtype=torch.float32, device=dev, seed=0)
    labels = np.full((1, 4), BLANK_INDEX, np.int64)
    labels[0, :3] = gen.integers(0, BLANK_INDEX, 3)
    locs = np.zeros((1, 8), np.float32)
    locs[0, 0:6:2], locs[0, 1:6:2] = (0.1, 0.45, 0.8), 0.03
    inputs = (torch.from_numpy(gen.uniform(-1, 1, (1, 32, 512, 3))
                               .astype(np.float32)),
              torch.from_numpy(labels), torch.from_numpy(locs),
              torch.tensor([[1.0, 1.0, 1.0, 0.0]]))
    out, restore = _launched(lambda: net.restore(*inputs))
    finite = all(bool(torch.isfinite(getattr(out, k)).all())
                 for k in ("sr", "priors", "w"))
    del net, out
    trainer = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                              allow_random_lpips=True)
    batch = TrainBatch.from_numpy(
        seeded_batch(gen, TRAIN_BATCH, TRAIN_SLOTS, (8, 8)), dev)
    metrics, step = _launched(lambda: trainer.train_step(batch))
    finite = finite and all(math.isfinite(float(v))
                            for v in metrics.values())
    del trainer, batch
    torch.cuda.empty_cache()
    say(f"[nets] f32 full width, launches in one restore (B=1, 4 slots): "
        f"{restore}; in one train_step (B={TRAIN_BATCH}, {TRAIN_SLOTS} "
        f"slots): {step}; finite outputs and losses: {finite}")
    fwd_bwd = (("fused_leaky_relu", "fused_leaky_relu_bwd"),
               ("sft_writeback", "sft_writeback_bwd"))
    if not (finite
            and all(restore[f] > 0 and restore[b] == 0 for f, b in fwd_bwd)
            and all(step[f] == step[b] > 0 for f, b in fwd_bwd)):
        raise AssertionError(f"nets: restore launched {restore}, the step "
                             f"{step}, finite {finite}")
    return {"restore": restore, "step": step}


def main() -> None:
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    report = phase_kernels()
    report["conv3x3_same"] = phase_conv3x3(smi)
    launches = phase_nets()
    kernels = [dict(name=name, **KERNELS[name],
                    launches={run: n[name] for run, n in launches.items()},
                    **report[name])
               for name in KERNELS]
    say(f"[smoke] phases 1-5 in {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
