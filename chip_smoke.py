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
5. parity: full-width f32 ``restore`` (B=1, 4 slots, 3 valid) on the card
   (kernels, TF32 off) against the CPU (plain versions), same seeded
   weights, within the tolerances of
   tests/test_convert.py::test_full_pipeline_chain_matches_torch.
6. serving: bf16 ``restore`` at full width on bench.py's workload (16
   lines of 8 characters) over several batches, its parameters cast to
   bf16 as bench.py casts them; checks shapes, finite
   values, sr in [-1, 1] and that every kernel of the path launched;
   prints crops/s from CUDA events and the per-stage split.
7. page server: full-width bf16 ``TextPageRestorer`` (bf16 parameters,
   as phase 6) on a seeded page of
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
11. front-end: ``CharacterFrontend`` at full size (YOLO11-m with one
   class, the default ``OCRConfig`` recognizer) from seeded weights saved
   with ``torch.save`` and loaded by ``from_checkpoints``, on the card and
   on the CPU over two seeded lines: YOLO scores and boxes before NMS, the
   kept set (a fixed count per line), int boxes within 1 px, recognizer
   logits and ids; detection, recognition and the whole front-end timed
   per line (CUDA events and the host clock).
12. CLIs: ``test_sr`` (``-m`` and with the front-end), ``test_w`` and
   ``serve_demo`` (front-end, ``--repeat`` 4) in-process at full width on
   seeded line PNGs written with the port's codec, then the page server
   with the front-end on lines without text (a split line detected per
   segment); exact K1 / K2 launches per restore (19 / 2, no other kernel),
   every output decoded by ``read_png`` at its shape; prints
   ``serve_demo``'s warm lines/s (bf16 compute over the checkpoint's f32
   parameters, as the JAX tool computes).
13. training driver: ``load_config("options/train.yml")`` (full width, 16
   slots, batch 2) and ``train.loop.train`` with its spawned workers
   synthesizing through the port's TrueType renderer (``font_dir`` the
   fixture font ``tests/data/fonts/``, DejaVu Sans), the real
   degradations, batching and ``prepare_train_batch``: 6 steps, then a
   resume from the newest checkpoint (step 4) to step 8 with three steps
   profiled. Checks the exact kernel launches of every step and every
   val pass, the event file (framing, CRCs, loss / speed scalars,
   ``val/*`` grids, the ``val/1_pred_text`` panel a 32 x 512 green-on-
   black PNG), that
   ``step_4.pt`` restores into a fresh trainer with equal tensors, and
   that the resumed step, learning rates and Adam counts continue;
   prints the loop's samples/s beside phase 10's, the queue wait a step,
   the device's idle share over the profiled steps, one worker's host ms
   a batch by stage (``render`` is the TrueType render, ``degradation``
   includes the libjpeg-exact JPEG step of BSRGAN) and ``os.cpu_count()``.
14. data-parallel training: (a) ``train.loop.train`` from
   ``options/train.yml`` at full width (glyphs in the fixture font, as
   phase 13) for 4 steps under a one-rank NCCL
   process group started by ``parallel.distributed.maybe_initialize``:
   exact launches per step, CUDA events around every
   ``all_reduce_grads`` (the gradient buckets of the G, D and SRD phases),
   the loop's samples/s beside phase 10's; (b) two spawned ranks sharing
   the card over gloo with CUDA tensors (NCCL refuses two ranks on one
   device), batch 2 each, on the halves of one seeded global batch of 4
   whose halves hold 8 and 20 valid characters, one ``train_step`` each,
   against one process's step at batch 4 run first and freed: every loss
   within phase 9's rtol 1e-3, each net's summed gradient within relative
   L2 1e-2, both ranks' nets (spectral u / v included) equal after the
   step, exact launches on each rank; peak memory of each rank and of the
   one process. The kernels are built once, in phase 2, before any rank
   starts. On an NVIDIA H100 80GB HBM3 at 700 W, phase 14 takes 56.4 s
   (a: 4 steps of ``train()`` in 17.0 s; b: 36.6 s) and peaks at 24.63
   GiB of device memory a rank and 44.35 GiB for the one process at
   batch 4; phases 1-14 take 216.5 s.

15. image input and the last tools: every JPEG fixture of
   ``tests/data/jpeg/`` decoded by ``utils/jpeg.py`` equal to its committed
   cv2 decode, with host ms a decode of the three timed ones;
   ``jpeg_roundtrip_u8`` on the sources of ``tests/data/jpeg/roundtrip/``
   equal to the decode of cv2's encodes of them at qualities 30, 60 and
   95, with host ms a round trip beside ``jpeg_np``'s; phase 12's
   lines written as BMP (a writer in this script) through ``test_sr -m``,
   ``serve_demo`` (front-end, ``--repeat`` 4) and ``test_w``, every output
   file equal to phase 12's from PNG bit for bit, ``w.gif`` walked block
   by block (11 frames of 10 hundredths, one NETSCAPE2.0 loop); the JPEG
   fixtures through ``test_sr -m`` and ``serve_demo -m`` (each output at
   its fixture's shape); ``parity_report`` twice at full width (f32) on
   checkpoints in the reference's key names from the port's seeded nets,
   a PNG and a JPEG line: ``NO_REFERENCE_OUTPUTS``, then ``PARITY``;
   ``profile_sr`` (bf16, 16 x 8, 3 traced restores): the Chrome trace
   parses and holds exactly 3 x 19 K1 and 3 x 2 K2 kernels by their CUDA
   names, with the device-busy share and the five kernels with the most
   time; ``crop_bg_patches`` on a seeded 1200 x 900 PNG and the 400 x 400
   JPEG (8 patches); ``syndata_demo`` (4 samples in the fixture font: 16
   PNGs at their shapes, a text each) and the host ms of one hinted
   TrueType render a line over 40 seeds and a batch of 2 (beside the
   unhinted renderer's 13.72 / 37.1 in ``PERF.md``); the hinted glyphs on
   this host, which has no
   PIL: the port's ``getmask`` of each of the 177 glyphs the alphabet
   reaches at 32, 90, 115 and 140 px against the SHA-256 of PIL's in
   ``tests/data/DejaVuSans.hinted.json`` (any glyph that differs fails
   the phase); then one f32 training step's peak memory
   at batches 2 and 4, a linear fit, and one timed step at the largest batch the fit
   puts under the card's memory (no out-of-memory error is caught). Exact
   K1 / K2 (and in training K1b / K2 bwd) launches in every run.
16. mixed-precision training: ``MARCONetTrainer(dtype=torch.bfloat16)``
   (bf16 compute over f32 parameters and Adam states, the JAX package's
   ``tools/bench_train.py`` policy). First one bf16 and one f32 step from
   one seeded state and batch at the CPU suite's reduced size (width
   0.0625, 4 slots, B=2), each loss term and each net's gradient against
   the f32 step within ``BF16_LOSS_TOL`` / ``BF16_GRAD_RTOL``. Then at
   full width on ``tools/bench_train.py``'s batch (B=2 x 16 slots, 8 valid
   characters a line), an f32 and then a bf16 trainer: one warm-up step
   and 5 timed ones each (CUDA events; samples/s, the G / D / SRD split,
   peak memory), exact launches per step, every parameter, gradient,
   buffer and Adam state f32 after the steps, finite losses; one more bf16
   step under ``torch.profiler`` shows every K1 / K1b / K2 / K2 backward
   kernel of the step as its bf16 instantiation (19 / 19 / 2 / 2), with
   the step's idle share and self device time by operator. Prints the
   bf16 rate beside the f32 one of this batch and of phase 10.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import io
import json
import math
import multiprocessing as mp
import os
import queue
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from marconet_tpu_torch import native
from marconet_tpu_torch.cli import crop_bg_patches as cli_crop_bg_patches
from marconet_tpu_torch.cli import parity_report as cli_parity_report
from marconet_tpu_torch.cli import profile_sr as cli_profile_sr
from marconet_tpu_torch.cli import serve_demo as cli_serve_demo
from marconet_tpu_torch.cli import syndata_demo as cli_syndata_demo
from marconet_tpu_torch.cli import test_sr as cli_test_sr
from marconet_tpu_torch.cli import test_w as cli_test_w
from marconet_tpu_torch.data import synth as synth_module
from marconet_tpu_torch.data.batch_prep import prepare_train_batch
from marconet_tpu_torch.dryrun import seeded_batch
from marconet_tpu_torch.data.synth import (
    GT_H,
    GT_W,
    LQ_H,
    LQ_W,
    SynthConfig,
    TextLineSynthesizer,
)
from marconet_tpu_torch.alphabet import alphabet
from marconet_tpu_torch.models.convnext_ocr import ConvNextViT, OCRConfig
from marconet_tpu_torch.models.frontend import (
    CharacterFrontend,
    letterbox,
    mask_segment,
    prepare_segment,
)
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
from marconet_tpu_torch.parallel import distributed
from marconet_tpu_torch.ops.sft_writeback import (
    sft_writeback,
    sft_writeback_bwd,
    sft_writeback_bwd_plain,
    sft_writeback_plain,
)
from marconet_tpu_torch.serve import TextPageRestorer, _pack_uint8
from marconet_tpu_torch.models.yolo import BatchNorm, YOLO11, nms_static
from marconet_tpu_torch.train import checkpoint as ckpt
from marconet_tpu_torch.train import events
from marconet_tpu_torch.train.config import load_config
from marconet_tpu_torch.train.loop import train
from marconet_tpu_torch.train.train_step import (
    NETS,
    MARCONetTrainer,
    TrainBatch,
    TrainConfig,
    lr_at,
)
from marconet_tpu_torch.convert import REFERENCE_FILES
from marconet_tpu_torch.data.degrade.diffjpeg import jpeg_np
from marconet_tpu_torch.utils.jpeg import (
    decode_jpeg,
    jpeg_roundtrip_u8,
    read_jpeg,
)
from marconet_tpu_torch.utils import raster, text_draw, truetype
from marconet_tpu_torch.utils.png import decode_png, read_png, write_png
from tests.torch_render_report import ink_digest

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
    training step of phase 16 runs them), with the kernel's share of its
    bound."""
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
    # bf16 parameters, as bench.py casts its params
    net = MARCONet(dtype=torch.bfloat16, device="cuda", seed=0).to(
        torch.bfloat16)
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
        net = MARCONet(dtype=dtype, device="cuda", seed=0).to(dtype)
        alone, twice = net.restore(*inputs), net.restore(*doubled)
        say(f"[page] restore of 16 lines alone vs in a batch of 32, "
            f"{str(dtype).removeprefix('torch.')}: w max_abs_diff "
            f"{max_abs(alone.w, twice.w[:16]):.3e}, sr "
            f"{max_abs(alone.sr, twice.sr[:16]):.3e}")
        del net, alone, twice
    torch.cuda.empty_cache()


def _page_invariance(page, line_boxes, texts, char_boxes) -> None:
    """The page's lines of up to 8 characters in f32 (TF32 off), default
    buckets (one unpadded chunk of bucket 64 at 8 slots) against bucket
    16: within ``PAGE_INVARIANCE_MAX`` levels on at most
    ``PAGE_INVARIANCE_SHARE`` of the pixels. (64 lines at 16 slots in f32
    do not fit in 80 GB.)"""
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
    net = MARCONet(dtype=torch.bfloat16, device="cuda", seed=0).to(
        torch.bfloat16)                     # bench.py's bf16 parameters
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
        chunk = lines16._chunk(reqs)
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
    chunk = lines16._chunk(segments[:16])
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

    def timed_chunk(reqs):
        t0 = time.perf_counter()
        c = make_chunk(reqs)
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
# two ranks' summed gradients against one process's on the card (phase 14)
PARITY_GRAD_TOL_DP = 1e-2
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


def phase_train(smi: str) -> tuple:
    """Full-width f32 training throughput at batch 2 x 16 slots."""
    dev = torch.device("cuda", 0)
    trainer = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                              allow_random_lpips=True)
    gen = np.random.default_rng(4)
    batches = [TrainBatch.from_numpy(
        _train_arrays(gen, TRAIN_BATCH, TRAIN_SLOTS), dev) for _ in range(2)]
    _reset_counts()
    ms, split, peak, last = _timed_steps(trainer, batches, "train")
    launches = _counts()
    steps = TRAIN_STEPS + 1
    _check_counts("train", launches,
                  {k: v * steps for k, v in TRAIN_LAUNCHES.items()},
                  f"{steps} steps")
    say(f"[train] f32 B={TRAIN_BATCH} slots={TRAIN_SLOTS} full width, "
        f"TF32 off: {ms:.2f} ms/step = {TRAIN_BATCH * 1e3 / ms:.3f} "
        f"samples/s over {TRAIN_STEPS} steps on {smi}")
    say("[train] split (ms/step): " + ", ".join(
        f"{k} {v:.2f}" for k, v in split.items()))
    say(f"[train] peak device memory {peak:.2f} GiB; last losses: " +
        ", ".join(f"{k} {float(v):.4g}" for k, v in last.items()))
    _profile_step(trainer, batches[0])
    return launches, TRAIN_BATCH * 1e3 / ms


def _timed_steps(trainer, batches, phase: str) -> tuple:
    """A fresh trainer's warm-up step (after which every parameter with a
    gradient has moved), then ``TRAIN_STEPS`` timed ones with finite
    losses: (ms a step, G / D / SRD ms a step, peak GiB, the last
    metrics), from CUDA events."""
    dev = trainer.device
    params = {f"{n}.{k}": p for n in NETS
              for k, p in trainer.net(n).named_parameters()}
    before = {k: p.detach().clone() for k, p in params.items()}
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.train_step(batches[0])                 # warm-up
    torch.cuda.synchronize()
    _check_moved(params, before, phase)
    del before
    marks, metrics = [], []
    for i in range(TRAIN_STEPS):
        metrics.append(trainer.train_step(batches[i % 2], marks=marks))
    torch.cuda.synchronize()
    if trainer.step != TRAIN_STEPS + 1:
        raise AssertionError(f"step is {trainer.step}, expected "
                             f"{TRAIN_STEPS + 1}")
    for m in metrics:
        for k, v in m.items():
            if not bool(torch.isfinite(v)):
                raise AssertionError(f"{phase}: non-finite {k}")
    split = {"G": 0.0, "D": 0.0, "SRD": 0.0}
    for i in range(TRAIN_STEPS):
        m = marks[4 * i: 4 * i + 4]
        for j, name in enumerate(split):
            split[name] += m[j].elapsed_time(m[j + 1]) / TRAIN_STEPS
    ms = marks[0].elapsed_time(marks[-1]) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return ms, split, peak, metrics[-1]


def _check_moved(params: dict, before: dict, phase: str) -> None:
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
    say(f"[{phase}] after the warm-up step {len(params) - len(quiet)} of "
        f"{len(params)} parameter tensors moved; without a gradient above "
        f"1e-6: {quiet}")


_CUPTI_MARKER = "Command Buffer Full"


def _profile_step(trainer, batch, phase: str = "train"):
    """Device busy time and the operators that take it, over one more
    training step (``torch.profiler``; counts outside the timed steps).
    Returns the profile."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    if _busy(prof) is None:
        say(f"[{phase}] profile: no device time recorded (not measured)")
        return prof
    busy, window = _busy(prof)
    ops = sorted(((e.self_device_time_total, e.key)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key != _CUPTI_MARKER
                  and e.self_device_time_total > 0), reverse=True)
    say(f"[{phase}] profile of one step: device busy {busy:.2f} ms of a "
        f"{window:.2f} ms window (idle share {100 * (1 - busy / window):.2f}"
        f"%); self device time by op: " + ", ".join(
            f"{k} {t / 1e3:.2f} ms ({100 * t / 1e3 / busy:.1f}%)"
            for t, k in ops[:12]))
    return prof


# ---------------------------------------------------------------------------
# the front-end: YOLO11-m + ConvNextViT
# ---------------------------------------------------------------------------

# the seed of the front-end's random weights and the detect head's class
# bias, chosen so that each smoke line gives FE_BOXES[i] boxes (1 to 16):
# at -2.0 every anchor scores above the 0.07 threshold by at least 0.043
# and NMS keeps 6 and 5 of them, on the card and on its machine's CPU
# (torch 2.11; torch's CPU generator draws other weights in other
# versions, so the counts belong to that machine)
FE_SEED = 0
FE_CLS_BIAS = -2.0
FE_BOXES = (6, 5)
# the smoke's lines: (height, width) of each, from FE_LINE_SEED
FE_LINES = ((64, 1024), (48, 700))
FE_LINE_SEED = 8
# the recognizer's positional embedding: 75 tokens, a canonical input of
# 300 x 32 (a 5-box window of square characters squeezed or padded to it);
# the released model's length is not in the repository
OCR_SEQ_LEN = 75
# card (cuDNN, TF32 off) against CPU, f32: YOLO before NMS with the
# tolerances of tests/test_frontend.py's whole-graph oracle (scores rtol /
# atol 2e-4; boxes rtol 2e-4, atol 2e-2 px); recognizer logits within
# OCR_LOGIT_TOL, and ids equal wherever the CPU's top-2 margin exceeds
# twice that
YOLO_TOL = {"scores": (2e-4, 2e-4), "boxes": (2e-4, 2e-2)}
OCR_LOGIT_TOL = 1e-3
FE_ITERS = 5


def _fe_lines() -> list:
    gen = np.random.default_rng(FE_LINE_SEED)
    return [gen.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in FE_LINES]


def _write_frontend_checkpoints(path: str) -> None:
    """Seeded full-size front-end weights, saved as the files
    ``CharacterFrontend.from_checkpoints`` looks for: YOLO11-m (one class)
    with BatchNorm statistics drawn as ``tests/yolo_oracle.py`` draws them
    (at their init, activations fade over the 23 layers and every anchor
    scores the same to 1e-5) and the class bias set to ``FE_CLS_BIAS``;
    the default ``OCRConfig`` recognizer under ModelScope's
    ``recognizer.`` prefix; and the alphabet as its vocabulary (class 0
    the blank)."""
    g = torch.Generator().manual_seed(FE_SEED)
    det = YOLO11(nc=1, device="cpu", generator=g)
    with torch.no_grad():
        for m in det.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(
                    0.5 + 0.5 * torch.randn(c, generator=g).abs())
        for head in det.model[23].cv3:
            head[2].bias.fill_(FE_CLS_BIAS)
    torch.save(det.state_dict(),
               os.path.join(path, "yolo11m_character_sd.pth"))
    ocr = ConvNextViT(OCRConfig(seq_len=OCR_SEQ_LEN), device="cpu",
                      generator=g)
    torch.save({f"recognizer.{k}": v for k, v in ocr.state_dict().items()},
               os.path.join(path, "ocr_convnext_sd.pth"))
    with open(os.path.join(path, "ocr_vocab.txt"), "w",
              encoding="utf-8") as f:
        f.writelines(f"{c}\n" for c in alphabet())


def _timed(fn, iters: int = FE_ITERS) -> tuple:
    """(CUDA-event ms, host ms) per call of ``fn`` after one warm-up call;
    ``fn`` returns host arrays, so both clocks span the same work."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / iters,
            (time.perf_counter() - t0) * 1e3 / iters)


def phase_frontend(smi: str, ckpt_dir: str) -> None:
    """``CharacterFrontend`` at full size (YOLO11-m, ConvNeXt-T + 12 ViT
    blocks over 6736 classes) from seeded checkpoints written to
    ``ckpt_dir``, on the card and on the CPU: YOLO before NMS within
    ``YOLO_TOL``, the same kept boxes (``FE_BOXES`` per line), int boxes
    within 1 px, recognizer logits within ``OCR_LOGIT_TOL`` and ids equal
    where the margin allows; then detection, recognition and the whole
    front-end timed per line."""
    torch.set_num_threads(os.cpu_count() or 1)
    _write_frontend_checkpoints(ckpt_dir)
    gpu = CharacterFrontend.from_checkpoints(ckpt_dir, device="cuda")
    cpu = CharacterFrontend.from_checkpoints(ckpt_dir, device="cpu")
    counts = []
    for i, img in enumerate(_fe_lines()):
        padded, _, _ = letterbox(img, gpu.imgsz)
        x = torch.from_numpy(padded[None].astype(np.float32) / 255.0)
        with torch.inference_mode():
            got = gpu.yolo(x.cuda())
            want = cpu.yolo(x)
            for name, g, w in zip(("boxes", "scores"), got, want):
                rtol, atol = YOLO_TOL[name]
                say(f"[frontend] line {i} {tuple(img.shape)}: YOLO {name} "
                    f"{tuple(g.shape)} max_abs_diff {max_abs(g.cpu(), w):.3e}"
                    f" (rtol {rtol:g}, atol {atol:g})")
                torch.testing.assert_close(g.cpu(), w, rtol=rtol, atol=atol)
            kept = []
            for net_out in (got, want):
                top, _, valid = nms_static(
                    net_out[0][0], net_out[1][0, :, 0], gpu.max_det,
                    gpu.iou, gpu.conf)
                kept.append(top[valid > 0].cpu())
        sg = want[1][0, :, 0]
        near = float((sg - gpu.conf).abs().min())
        say(f"[frontend] line {i}: kept {len(kept[0])} (card) / "
            f"{len(kept[1])} (CPU) boxes; nearest score to the threshold "
            f"{gpu.conf} is {near:.3e} away; top scores "
            f"{sg.topk(4).values.tolist()}")
        # the same boxes kept, in the same score order
        torch.testing.assert_close(kept[0], kept[1], rtol=YOLO_TOL["boxes"][0],
                                   atol=YOLO_TOL["boxes"][1])
        boxes_g, boxes_c = gpu.detect_boxes(img), cpu.detect_boxes(img)
        if boxes_g.shape != boxes_c.shape or (
                len(boxes_g) and np.abs(boxes_g - boxes_c).max() > 1):
            raise AssertionError(f"line {i}: card boxes {boxes_g.tolist()} "
                                 f"against CPU {boxes_c.tolist()}")
        counts.append(len(boxes_g))

        segs = [mask_segment(img, boxes_c, j)[0] for j in range(len(boxes_c))]
        prep = np.stack([prepare_segment(s, gpu.ocr.config.canonical_width)
                         for s in segs]).astype(np.float32)
        prep = torch.from_numpy((prep / 255.0 - 0.5) / 0.5)
        with torch.inference_mode():
            lg, lc = gpu.ocr(prep.cuda()).cpu(), cpu.ocr(prep)
        top2 = lc.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > 2 * OCR_LOGIT_TOL
        same = lg.argmax(-1) == lc.argmax(-1)
        say(f"[frontend] line {i}: recognizer logits {tuple(lc.shape)} "
            f"max_abs_diff {max_abs(lg, lc):.3e} (limit {OCR_LOGIT_TOL:g}); "
            f"ids equal on {int(same.sum())} of {same.numel()} frames, "
            f"{int(sure.sum())} with a margin over {2 * OCR_LOGIT_TOL:g}")
        if max_abs(lg, lc) > OCR_LOGIT_TOL or not bool(same[sure].all()):
            raise AssertionError(f"line {i}: recognizer differs")
        res_g, res_c = gpu(img), cpu(img)
        say(f"[frontend] line {i}: text {res_g.text!r} (card), "
            f"{res_c.text!r} (CPU)")

        ms = {"detect_boxes": _timed(lambda: gpu.detect_boxes(img)),
              "recognize_segments": _timed(
                  lambda: gpu.recognize_segments(segs)),
              "__call__": _timed(lambda: gpu(img))}
        say(f"[frontend] line {i} {tuple(img.shape)}, {len(segs)} boxes, "
            f"f32 on {smi}: ms per line (CUDA events / host clock): " +
            ", ".join(f"{k} {e:.2f} / {h:.2f}" for k, (e, h) in ms.items()))
    del gpu, cpu
    torch.cuda.empty_cache()
    say(f"[frontend] boxes per line: {counts} (expected {list(FE_BOXES)})")
    if counts != list(FE_BOXES):
        raise AssertionError(f"boxes per line {counts}, expected "
                             f"{list(FE_BOXES)}")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

CLI_COPIES = 3          # files per smoke line: 6 line PNGs
CLI_REPEAT = 4


def _cli_counted(what: str, restores, fn):
    """Run ``fn`` with the kernel counts from 0; hold K1 / K2 to 19 / 2 per
    restore (``restores(result)``) and every other kernel to 0."""
    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = _counts()
    n = restores(out)
    _check_counts("cli", got, {k: v * n for k, v in
                               RESTORE_LAUNCHES.items()},
                  f"{what} ({n} restores)")
    return out, got


def _check_pngs(paths, shapes, what: str) -> None:
    for path, shape in zip(paths, shapes):
        img = read_png(path)
        if img.shape != shape:
            raise AssertionError(f"{what}: {os.path.basename(path)} is "
                                 f"{img.shape}, expected {shape}")


def phase_cli(smi: str, ckpt_dir: str, work: str) -> dict:
    """The three CLIs in-process at full width on the card, on seeded line
    PNGs written with the port's codec: ``test_sr`` with ``-m`` and with
    the front-end of ``ckpt_dir``, ``test_w``, ``serve_demo`` (front-end,
    ``--repeat`` 4), then the page server with the front-end on a page
    whose over-wide line has no text. Exact K1 / K2 launches per restore,
    every output decoded by ``read_png`` at its expected shape."""
    lines_dir = os.path.join(work, "lines")
    os.makedirs(lines_dir)
    chars = [c for c in alphabet() if c.isalnum()]
    gen = np.random.default_rng(9)
    names = []
    for i, img in enumerate(_fe_lines()):
        for c in range(CLI_COPIES):
            text = "".join(chars[j] for j in gen.integers(0, len(chars),
                                                          3 + c))
            names.append(f"line{i}c{c}_{text}.png")
            write_png(os.path.join(lines_dir, names[-1]), img)
    shows = {n: round(FE_LINES[int(n[4])][1] * 128 / FE_LINES[int(n[4])][0])
             for n in names}
    launches = dict.fromkeys(_WRAPPERS, 0)

    def add(got):
        for k, v in got.items():
            launches[k] += v

    common = ["--ckpt_dir", ckpt_dir, "--device", "cuda"]
    for flag in (["-m"], []):
        out = os.path.join(work, f"sr{''.join(flag)}")
        t0 = time.perf_counter()
        done, got = _cli_counted(
            f"test_sr {' '.join(flag) or '(front-end)'}",
            lambda d: sum(r for _, _, r in d),
            lambda: cli_test_sr.main(["-i", lines_dir, "-o", out] + flag
                                     + common))
        if [d[0] for d in done] != sorted(names):
            raise AssertionError(f"test_sr {flag}: restored {done}")
        _check_pngs([os.path.join(out, f"{os.path.splitext(n)[0]}_"
                                  f"{t.replace(os.sep, '_')}.png")
                     for n, t, _ in done],
                    [(4 * 128, shows[n], 3) for n, _, _ in done],
                    "test_sr collage")
        say(f"[cli] test_sr {' '.join(flag) or '(front-end)'}: "
            f"{len(done)} collages, texts "
            f"{[t for _, t, _ in done]}, {time.perf_counter() - t0:.2f} s")
        add(got)

    out = os.path.join(work, "w")
    w1, w2 = (os.path.join(lines_dir, names[i]) for i in (0, CLI_COPIES))
    # one prior batch: the prior's 19 K1 launches, no SR net
    _reset_counts()
    paths = cli_test_w.main(["-w1", w1, "-w2", w2, "-o", out] + common)
    torch.cuda.synchronize()
    got = _counts()
    _check_counts("cli", got, {**dict.fromkeys(_WRAPPERS, 0),
                               "fused_leaky_relu": 19}, "test_w")
    add(got)
    n_lab = read_png(paths[0]).shape[1] // 128
    _check_pngs(paths, [(128, 128 * n_lab, 3)] * len(paths), "test_w")
    if len(paths) != 11:
        raise AssertionError(f"test_w wrote {len(paths)} blends")
    say(f"[cli] test_w: {len(paths)} blends of {n_lab} characters")

    out = os.path.join(work, "serve")
    res, got = _cli_counted(
        f"serve_demo --repeat {CLI_REPEAT}", lambda r: 2 * r["chunks"],
        lambda: cli_serve_demo.main(["-i", lines_dir, "-o", out,
                                     "--repeat", str(CLI_REPEAT)] + common))
    add(got)
    n = len(names) * CLI_REPEAT
    if len(res["results"]) != n:
        raise AssertionError(f"serve_demo: {len(res['results'])} results")
    _check_pngs([os.path.join(out, f"{i:03d}_{os.path.splitext(m)[0]}.png")
                 for i, m in enumerate(res["names"])],
                [(128, shows[m], 3) for m in res["names"]], "serve_demo")
    say(f"[cli] serve_demo (front-end, bf16 compute over f32 parameters) "
        f"{n} lines in {res['chunks']} chunk(s) a pass: first pass "
        f"{res['first_s']:.2f} s, warm "
        f"{res['warm_s'] * 1e3:.1f} ms = {res['lines_per_s']:.2f} lines/s "
        f"on {smi}")

    # the page server with the front-end: a line without text, and one
    # over-wide line without text that is detected per segment
    fe = CharacterFrontend.from_checkpoints(ckpt_dir, device="cuda")
    net = MARCONet(dtype=torch.bfloat16, device="cuda", seed=0)
    img0, img1 = _fe_lines()
    page = np.zeros((img0.shape[0] + img1.shape[0], 2 * img1.shape[1], 3),
                    np.uint8)
    page[:img0.shape[0], :img0.shape[1]] = img0
    page[img0.shape[0]:, :img1.shape[1]] = img1
    page[img0.shape[0]:, img1.shape[1]:] = img1
    boxes = [(0, 0, img0.shape[1], img0.shape[0]),
             (0, img0.shape[0], page.shape[1], page.shape[0])]
    server = TextPageRestorer(net, frontend=fe)
    segs, groups = server._page_requests(page, boxes, None, None)
    result, got = _cli_counted(
        "restore_page with the front-end", lambda r: 1,
        lambda: server.restore_page(page, boxes))
    add(got)
    texts = [fe(r.image).text for r in segs]
    want = ["".join(texts[j] for j in g) for g in groups]
    if [r.text for r in result] != want or len(groups[1]) < 2:
        raise AssertionError(f"page texts {[r.text for r in result]}, "
                             f"expected {want} over {groups}")
    say(f"[cli] restore_page with the front-end: {len(segs)} segments "
        f"({[len(g) for g in groups]} a line), texts {want}")
    del net, fe
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the training driver: YAML config, data workers, loop, events, checkpoints
# ---------------------------------------------------------------------------

LOOP_CONFIG = "options/train.yml"
LOOP_STEPS = 6            # train(max_steps=6), then resume (from step 4)
LOOP_RESUME_STEPS = 8
LOOP_PRINT, LOOP_VAL, LOOP_SAVE = 1, 2, 4
LOOP_PROFILE = (1, 4)     # the resumed run's steps 6..8, relative [1, 4)
LOOP_TAGS = ("losses/l_g_total", "speed/samples_per_sec",
             "speed/data_wait_ms", "val/1_gt_sr_lq", "val/3_char_prior",
             "val/1_pred_text")
HOST_BATCHES = 3          # batches synthesized in this process, timed
# the fixture font (DejaVu Sans): the synthesizer draws its lines with it
FONT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "data", "fonts")
# SHA-256 of the ink of PIL's masks of its glyphs, written on a host with
# PIL by ``python -m tests.torch_render_report --write-digests``
HINTED_DIGESTS = os.path.join(os.path.dirname(FONT_DIR),
                              "DejaVuSans.hinted.json")
PRED_TEXT_SHAPE = (32, 512, 3)  # the val/1_pred_text panel
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def _launches_per_call(log: list):
    """Record the kernel launches of every ``train_step`` and
    ``visual_forward`` call (host counters, read as each call returns)."""
    saved = {"step": MARCONetTrainer.train_step,
             "val": MARCONetTrainer.visual_forward}

    def counted(kind, fn):
        def call(self, *args, **kwargs):
            before = _counts()
            out = fn(self, *args, **kwargs)
            log.append((kind, {k: v - before[k]
                               for k, v in _counts().items()}))
            return out
        return call

    MARCONetTrainer.train_step = counted("step", saved["step"])
    MARCONetTrainer.visual_forward = counted("val", saved["val"])
    try:
        yield
    finally:
        MARCONetTrainer.train_step = saved["step"]
        MARCONetTrainer.visual_forward = saved["val"]


def _host_batch_ms() -> dict:
    """One worker's host milliseconds a batch, in this process: the
    degradations, the LQ resize and padding, ``prepare_train_batch``, the
    TrueType render (DejaVu Sans) and the rest (background, jitter,
    stacking)."""
    synth = TextLineSynthesizer(SynthConfig(font_dir=FONT_DIR))
    spent = dict.fromkeys(("degradation", "resize/pad",
                           "prepare_train_batch", "render"), 0.0)

    def timed(key, fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[key] += time.perf_counter() - t
            return out
        return call

    synth.degrade = timed("degradation", synth.degrade)
    synth.fit = timed("resize/pad", synth.fit)
    synth.render = timed("render", synth.render)
    prep = synth_module.prepare_train_batch
    synth_module.prepare_train_batch = timed("prepare_train_batch", prep)
    rng = np.random.default_rng(7)
    try:
        t = time.perf_counter()
        for _ in range(HOST_BATCHES):
            synth.batch(TRAIN_BATCH, rng)
        total = time.perf_counter() - t
    finally:
        synth_module.prepare_train_batch = prep
    out = {k: v * 1e3 / HOST_BATCHES for k, v in spent.items()}
    out["other"] = total * 1e3 / HOST_BATCHES - sum(out.values())
    out["total"] = total * 1e3 / HOST_BATCHES
    return out


def _trace_idle(path: str) -> dict:
    """Window, device busy time (the union of kernels, copies and sets)
    and the marked host spans of a ``torch.profiler`` chrome trace, ms."""
    with open(path) as f:
        trace = json.load(f)
    spans = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and "dur" in e]
    start = min(e["ts"] for e in spans)
    end = max(e["ts"] + e["dur"] for e in spans)
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                    if e.get("cat") in DEVICE_CATS
                    and e.get("name") != _CUPTI_MARKER)
    if not device:
        raise AssertionError(f"{path}: no device activity in the trace")
    busy, reach = 0.0, device[0][0]
    for lo, hi in device:
        busy += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    marks = {}
    for e in spans:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith("train/"):
            marks[e["name"]] = marks.get(e["name"], 0.0) + e["dur"] / 1e3
    return {"window": (end - start) / 1e3, "busy": busy / 1e3,
            "marks": marks}


def _check_loop_events(tb_dir: str, steps, val_steps) -> list:
    """Every event file under ``tb_dir`` reads back with valid framing and
    CRCs; the tags, loss steps and val steps are the expected ones.
    Returns the events."""
    files = events.event_files(tb_dir)
    evs = [e for path in files for e in events.read_events(path)]
    if sum("file_version" in e for e in evs) != len(files):
        raise AssertionError(f"{tb_dir}: a file without its version record")
    tags = {v[0] for e in evs for v in e["values"]}
    missing = [t for t in LOOP_TAGS if t not in tags]
    if missing:
        raise AssertionError(f"{tb_dir}: no {missing} in {sorted(tags)}")
    loss_steps = [s for s, _ in events.scalars(tb_dir, "losses/l_g_total")]
    got_val = [e["step"] for e in evs for v in e["values"]
               if v[0] == "val/1_pred_text"]
    if loss_steps != list(steps) or got_val != list(val_steps):
        raise AssertionError(f"loss steps {loss_steps}, val steps {got_val}"
                             f"; expected {list(steps)}, {list(val_steps)}")
    for e in evs:
        for tag, kind, payload in e["values"]:
            if tag == "val/1_pred_text":
                _check_pred_text(kind, payload)
            elif kind == "image":
                png, h, w = payload
                if not png.startswith(b"\x89PNG") or h < 128 or w < 128:
                    raise AssertionError(f"{tag}: {h} x {w} image")
            if kind == "scalar" and not math.isfinite(payload):
                raise AssertionError(f"{tag} = {payload}")
    return evs


def _check_pred_text(kind: str, payload) -> None:
    """``val/1_pred_text`` is the predicted text drawn in the font of
    ``font_dir``: a 32 x 512 PNG, green on black."""
    if kind != "image":
        raise AssertionError(f"val/1_pred_text is a {kind} entry, not an "
                             "image")
    png, h, w = payload
    img = decode_png(png, "val/1_pred_text")
    if (h, w) + (3,) != PRED_TEXT_SHAPE or img.shape != PRED_TEXT_SHAPE \
            or img[..., [0, 2]].any():
        raise AssertionError(f"val/1_pred_text: {img.shape} image, red or "
                             "blue ink")


def _check_restore(ckpt_dir: str, step: int, config) -> None:
    """``step_<step>.pt`` restores into a fresh trainer with every tensor
    equal to the file's."""
    fresh = MARCONetTrainer(config.train, device="cuda", seed=1,
                            allow_random_lpips=True)
    ckpt.restore_state(ckpt_dir, fresh, step=step)
    saved = torch.load(os.path.join(ckpt_dir, f"step_{step}.pt"),
                       map_location="cuda", weights_only=True)
    got = fresh.state_dict()
    n = 0
    for name in NETS:
        for k, v in saved["nets"][name].items():
            if not torch.equal(got["nets"][name][k], v):
                raise AssertionError(f"restored {name}.{k} differs")
            n += 1
        for idx, state in saved["optimizers"][name]["state"].items():
            for k, v in state.items():
                if not torch.equal(got["optimizers"][name]["state"][idx][k],
                                   v):
                    raise AssertionError(f"restored {name} Adam {idx}.{k}")
                n += 1
    if fresh.step != step or saved["step"] != step:
        raise AssertionError(f"restored step {fresh.step}, expected {step}")
    say(f"[loop] step_{step}.pt restores into a fresh trainer: {n} tensors "
        "equal")
    del fresh, saved, got
    torch.cuda.empty_cache()


def phase_loop(smi: str, bare_samples_per_s: float) -> dict:
    """The training driver at ``options/train.yml``'s full width (batch 2,
    16 slots) through the entry points a user calls: ``load_config``,
    ``train(max_steps=6)`` with the config's spawned workers drawing in
    the fixture font, then a resume from the newest checkpoint to step 8
    with three steps profiled. Exact launches per step and per val pass,
    the event file, checkpoint restore and the resumed step and rates;
    prints the loop's samples/s beside phase 10's bare steps, one
    worker's host ms a batch, the queue wait a step and the device's
    idle share."""
    config = load_config(LOOP_CONFIG)
    t, loop = config.train, config.loop
    if (t.width, t.max_chars, loop.batch_size) != (1.0, 16, TRAIN_BATCH):
        raise AssertionError(f"{LOOP_CONFIG}: width {t.width}, slots "
                             f"{t.max_chars}, batch {loop.batch_size}")
    with tempfile.TemporaryDirectory(prefix="loop_") as work:
        return _run_loop(smi, bare_samples_per_s, config, work)


def _run_loop(smi: str, bare_samples_per_s: float, config, work: str
              ) -> dict:
    t, loop = config.train, config.loop
    loop.experiments_root = work
    loop.print_freq, loop.val_freq, loop.save_freq = \
        LOOP_PRINT, LOOP_VAL, LOOP_SAVE
    loop.allow_random_lpips = True
    loop.font_dir = FONT_DIR
    run_dir = os.path.join(work, loop.name)
    tb_dir, ckpt_dir = (os.path.join(run_dir, "tb"),
                        os.path.join(run_dir, "checkpoints"))
    profile_dir = os.path.join(work, "profile")
    say(f"[loop] {LOOP_CONFIG}: width {t.width}, {t.max_chars} slots, batch "
        f"{loop.batch_size}, {loop.num_workers} spawned workers; "
        f"os.cpu_count() {os.cpu_count()}")
    calls: list = []
    _reset_counts()
    try:
        with _launches_per_call(calls):
            t0 = time.perf_counter()
            trainer = train(config, max_steps=LOOP_STEPS)
            first_s = time.perf_counter() - t0
            if trainer.step != LOOP_STEPS:
                raise AssertionError(f"step {trainer.step}")
            del trainer
            torch.cuda.empty_cache()
            first = _check_loop_events(tb_dir, range(1, LOOP_STEPS + 1),
                                       range(LOOP_VAL, LOOP_STEPS + 1,
                                             LOOP_VAL))
            saved = ckpt.latest_step(ckpt_dir)
            if saved != LOOP_SAVE:
                raise AssertionError(f"newest checkpoint {saved}")
            _check_restore(ckpt_dir, saved, config)

            loop.resume_state = ckpt_dir
            os.environ["MARCONET_PROFILE"] = profile_dir
            t0 = time.perf_counter()
            trainer = train(config, max_steps=LOOP_RESUME_STEPS,
                            profile_steps=LOOP_PROFILE)
            resume_s = time.perf_counter() - t0
        launches = _counts()
    finally:
        os.environ.pop("MARCONET_PROFILE", None)

    # launches: every step and every val pass exactly, and in sum
    steps = [c for kind, c in calls if kind == "step"]
    vals = [c for kind, c in calls if kind == "val"]
    n_steps = LOOP_STEPS + LOOP_RESUME_STEPS - saved
    n_vals = LOOP_STEPS // LOOP_VAL + (LOOP_RESUME_STEPS - saved) // LOOP_VAL
    if len(steps) != n_steps or len(vals) != n_vals:
        raise AssertionError(f"{len(steps)} steps and {len(vals)} val "
                             f"passes, expected {n_steps} and {n_vals}")
    for kind, got in calls:
        want = TRAIN_LAUNCHES if kind == "step" else RESTORE_LAUNCHES
        if got != want:
            raise AssertionError(f"a {kind} call launched {got}, expected "
                                 f"{want}")
    _check_counts("loop", launches,
                  {k: n_steps * TRAIN_LAUNCHES[k] + n_vals * v
                   for k, v in RESTORE_LAUNCHES.items()},
                  f"{n_steps} loop steps and {n_vals} val passes")

    # the resumed run: step, learning rates and Adam's count continue
    if trainer.step != LOOP_RESUME_STEPS:
        raise AssertionError(f"resumed to step {trainer.step}")
    for name, opt in trainer.optimizers.items():
        want = lr_at(trainer.base_lr[name], LOOP_RESUME_STEPS - 1,
                     t.milestones, t.lr_gamma)
        counts = {float(s["step"]) for s in opt.state.values()}
        if [g["lr"] for g in opt.param_groups] != [want] or \
                counts != {float(LOOP_RESUME_STEPS)}:
            raise AssertionError(f"{name}: lr {opt.param_groups[0]['lr']} "
                                 f"(expected {want}), Adam steps {counts}")
    del trainer
    torch.cuda.empty_cache()
    evs = _check_loop_events(
        tb_dir, list(range(1, LOOP_STEPS + 1))
        + list(range(saved + 1, LOOP_RESUME_STEPS + 1)),
        list(range(LOOP_VAL, LOOP_STEPS + 1, LOOP_VAL))
        + list(range(saved + LOOP_VAL, LOOP_RESUME_STEPS + 1, LOOP_VAL)))
    say(f"[loop] train() to step {LOOP_STEPS} in {first_s:.1f} s, resumed "
        f"from step {saved} to {LOOP_RESUME_STEPS} in {resume_s:.1f} s; "
        f"{len(evs)} events ({len(first)} in the first run's file), "
        "CRCs valid; learning rates and Adam step counts continue")
    say(f"[loop] launches per step {steps[0]}, per val pass {vals[0]} "
        f"(every one of {n_steps} steps and {n_vals} val passes)")

    # speed: the first run's steps whose interval holds no val or save
    rate = dict(events.scalars(tb_dir, "speed/samples_per_sec")[
        :LOOP_STEPS])
    wait = dict(events.scalars(tb_dir, "speed/data_wait_ms")[:LOOP_STEPS])
    steady = [s for s in range(2, LOOP_STEPS + 1)
              if (s - 1) % LOOP_VAL and (s - 1) % LOOP_SAVE]
    loop_rate = len(steady) / sum(1.0 / rate[s] for s in steady)
    say(f"[loop] samples/s over steps {steady}: {loop_rate:.3f} (each "
        + ", ".join(f"{rate[s]:.3f}" for s in steady)
        + f"); phase 10's bare train_step {bare_samples_per_s:.3f}; on "
        f"{smi}")
    say("[loop] queue wait ms a step: " + ", ".join(
        f"step {s} {w:.1f}" for s, w in sorted(wait.items())))
    traces = sorted(os.listdir(profile_dir))
    idle = _trace_idle(os.path.join(profile_dir, traces[0]))
    say(f"[loop] profile of the resumed run's steps "
        f"{saved + LOOP_PROFILE[0] + 1}-{saved + LOOP_PROFILE[1]} "
        f"({traces[0]}): device busy {idle['busy']:.2f} ms of a "
        f"{idle['window']:.2f} ms window, idle share "
        f"{100 * (1 - idle['busy'] / idle['window']):.2f}%; host spans "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
            idle["marks"].items())))
    host = _host_batch_ms()
    say(f"[loop] one worker's host ms a batch of {TRAIN_BATCH} (this "
        f"process, {HOST_BATCHES} batches): " + ", ".join(
            f"{k} {v:.1f}" for k, v in host.items()))
    return launches


# ---------------------------------------------------------------------------
# phase 14: data-parallel training
# ---------------------------------------------------------------------------

DP_STEPS = 4              # the one-rank NCCL loop: train(max_steps=4)
DP_WORLD = 2              # ranks sharing the one card over gloo
# valid characters of the global batch's rows: rank 0 holds 8, rank 1 20,
# so per-rank masked means would not be the global batch's
DP_COUNTS = (3, 5, 8, 12)
DP_RANK_TIMEOUT_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _grad_vector(trainer, net: str) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for _, p in sorted(
        trainer.net(net).named_parameters()) if p.grad is not None])


def _state_digest(trainer) -> str:
    """SHA-256 of every net's parameters and buffers (spectral u / v
    included), in a fixed order."""
    h = hashlib.sha256()
    for net in NETS:
        for k, v in sorted(trainer.net(net).state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def phase_dp(smi: str, bare_samples_per_s: float) -> dict:
    """Data-parallel training: (a) ``train.loop.train`` from
    ``options/train.yml`` at full width under a one-rank NCCL group; (b)
    one ``train_step`` on two spawned ranks sharing the card over gloo
    (CUDA tensors), each on its half of one seeded global batch of 4 whose
    halves hold different counts of valid characters, against one process
    over the whole batch. Returns the kernel launches of both runs."""
    launches = _dp_one_rank_loop(smi, bare_samples_per_s)
    for name, n in _dp_two_ranks(smi).items():
        launches[name] += n
    return launches


def _dp_one_rank_loop(smi: str, bare_samples_per_s: float) -> dict:
    config = load_config(LOOP_CONFIG)
    t, loop = config.train, config.loop
    if (t.width, t.max_chars, loop.batch_size) != (1.0, 16, TRAIN_BATCH):
        raise AssertionError(f"{LOOP_CONFIG}: width {t.width}, slots "
                             f"{t.max_chars}, batch {loop.batch_size}")
    loop.print_freq, loop.val_freq, loop.save_freq = 1, 0, 10 ** 9
    loop.allow_random_lpips = True
    loop.font_dir = FONT_DIR
    spans: list = []
    reduce_grads = distributed.all_reduce_grads

    def timed(params, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        n = reduce_grads(params, *args, **kwargs)
        end.record()
        spans.append((start, end, n))
        return n

    calls: list = []
    with tempfile.TemporaryDirectory(prefix="dp_") as work:
        loop.experiments_root = work
        if not distributed.maybe_initialize(f"localhost:{_free_port()}", 1,
                                            0, backend="nccl"):
            raise AssertionError("no process group started")
        distributed.all_reduce_grads = timed
        _reset_counts()
        try:
            backend = torch.distributed.get_backend()
            with _launches_per_call(calls):
                t0 = time.perf_counter()
                trainer = train(config, max_steps=DP_STEPS)
                seconds = time.perf_counter() - t0
            launches = _counts()
        finally:
            distributed.all_reduce_grads = reduce_grads
            distributed.shutdown()
        rate = dict(events.scalars(os.path.join(work, loop.name, "tb"),
                                   "speed/samples_per_sec"))
    torch.cuda.synchronize()
    if trainer.step != DP_STEPS or backend != "nccl":
        raise AssertionError(f"step {trainer.step}, backend {backend}")
    if [k for k, _ in calls] != ["step"] * DP_STEPS or \
            any(c != TRAIN_LAUNCHES for _, c in calls):
        raise AssertionError(f"calls and launches {calls}, expected "
                             f"{DP_STEPS} steps of {TRAIN_LAUNCHES}")
    _check_counts("dp", launches, {k: DP_STEPS * v for k, v in
                                   TRAIN_LAUNCHES.items()},
                  f"{DP_STEPS} loop steps on one NCCL rank")
    if len(spans) != 3 * DP_STEPS:
        raise AssertionError(f"{len(spans)} gradient all-reduces, expected "
                             f"3 a step")
    grad_bytes = sum(p.numel() * p.element_size() for net in NETS
                     for p in trainer.net(net).parameters())
    ar_ms = [sum(s.elapsed_time(e) for s, e, _ in spans[3 * i:3 * i + 3])
             for i in range(DP_STEPS)]
    buckets = sum(n for _, _, n in spans) / DP_STEPS
    steady = list(range(2, DP_STEPS + 1))
    loop_rate = len(steady) / sum(1.0 / rate[s] for s in steady)
    say(f"[dp] (a) {LOOP_CONFIG} full width, batch {loop.batch_size}, "
        f"{DP_STEPS} steps of train() under a one-rank {backend} group in "
        f"{seconds:.1f} s; launches per step {calls[0][1]}")
    say(f"[dp] (a) gradient all-reduce (G, D, SRD; {buckets:.0f} buckets of "
        f"up to 25 MiB over {grad_bytes / 2 ** 20:.1f} MiB of f32 gradients "
        f"a step), CUDA events: step 1 {ar_ms[0]:.3f} ms (NCCL sets up its "
        f"communicator at the first collective), steps {steady} " + ", ".join(
            f"{m:.3f}" for m in ar_ms[1:]) + f" ms, mean "
        f"{sum(ar_ms[1:]) / len(steady):.3f} ms a step; loop samples/s over "
        f"steps {steady}: "
        f"{loop_rate:.3f} (each " + ", ".join(f"{rate[s]:.3f}"
                                              for s in steady)
        + f"); phase 10's bare train_step {bare_samples_per_s:.3f}; on {smi}")
    del trainer
    torch.cuda.empty_cache()
    return launches


def _dp_rank(rank: int, init: str, arrays, ref_path: str, out_q) -> None:
    """One rank of phase 14 (b), in a spawned process on the one card."""
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        distributed.maybe_initialize(init, DP_WORLD, rank, backend="gloo",
                                     device=dev)
        try:
            trainer = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                                      allow_random_lpips=True)
            for net in NETS:
                distributed.broadcast_module_state(trainer.net(net))
            local = distributed.local_batch_slice(arrays, len(arrays["lq"]))
            _reset_counts()
            metrics = trainer.train_step(TrainBatch.from_numpy(local, dev))
            torch.cuda.synchronize()
            out = {"launches": _counts(),
                   "metrics": {k: float(v) for k, v in metrics.items()},
                   "valid": float(local["char_valid"].sum()),
                   "peak": torch.cuda.max_memory_allocated(dev)}
            ref = torch.load(ref_path, map_location=dev, weights_only=True)
            out["grad_rel_l2"] = {
                net: _rel_l2(_grad_vector(trainer, net), ref["grads"][net])
                for net in NETS}
            del ref
            out["digest"] = _state_digest(trainer)
            distributed.barrier()
        finally:
            distributed.shutdown()
        out_q.put((rank, out))
    except BaseException:
        out_q.put((rank, traceback.format_exc()))


def _dp_two_ranks(smi: str) -> dict:
    dev = torch.device("cuda", 0)
    arrays = seeded_batch(np.random.default_rng(11), len(DP_COUNTS),
                          TRAIN_SLOTS, DP_COUNTS)
    with tempfile.TemporaryDirectory(prefix="dp_") as work:
        # one process over the global batch of 4, first, then freed
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        one = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                              allow_random_lpips=True)
        want = {k: float(v) for k, v in one.train_step(
            TrainBatch.from_numpy(arrays, dev)).items()}
        torch.cuda.synchronize()
        one_peak = torch.cuda.max_memory_allocated(dev)
        ref_path = os.path.join(work, "reference.pt")
        torch.save({"grads": {net: _grad_vector(one, net).cpu()
                              for net in NETS}}, ref_path)
        del one
        torch.cuda.empty_cache()

        ctx = mp.get_context("spawn")
        out_q = ctx.Queue()
        init = "file://" + os.path.join(work, "rendezvous")
        procs = [ctx.Process(target=_dp_rank,
                             args=(r, init, arrays, ref_path, out_q))
                 for r in range(DP_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        results = {}
        try:
            while len(results) < DP_WORLD:
                try:
                    rank, out = out_q.get(timeout=DP_RANK_TIMEOUT_S)
                except queue.Empty:
                    raise AssertionError(f"ranks {sorted(results)} of "
                                         f"{DP_WORLD} reported") from None
                if isinstance(out, str):
                    raise AssertionError(f"rank {rank} failed:\n{out}")
                results[rank] = out
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
        seconds = time.perf_counter() - t0
    ranks = [results[r] for r in range(DP_WORLD)]
    if ranks[0]["valid"] == ranks[1]["valid"]:
        raise AssertionError("the halves hold equal valid counts")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("the ranks' nets differ after the step")
    launches = dict.fromkeys(TRAIN_LAUNCHES, 0)
    for r, out in enumerate(ranks):
        _check_counts("dp", out["launches"], TRAIN_LAUNCHES,
                      f"rank {r}'s step")
        for k, v in out["launches"].items():
            launches[k] += v
        for k, w in want.items():
            got = out["metrics"][k]
            if not math.isclose(got, w, rel_tol=PARITY_LOSS_TOL[0],
                                abs_tol=PARITY_LOSS_TOL[1]):
                raise AssertionError(f"rank {r}: {k} {got} against one "
                                     f"process's {w}")
        for net, err in out["grad_rel_l2"].items():
            if not err <= PARITY_GRAD_TOL_DP:
                raise AssertionError(f"rank {r}: {net} gradient relative L2 "
                                     f"{err} > {PARITY_GRAD_TOL_DP}")
    say(f"[dp] (b) {DP_WORLD} ranks on one card over gloo (CUDA tensors), "
        f"full width f32, batch 2 a rank x {TRAIN_SLOTS} slots, valid "
        f"characters {ranks[0]['valid']:.0f} / {ranks[1]['valid']:.0f}, in "
        f"{seconds:.1f} s; against one process at batch 4: losses within "
        f"rtol {PARITY_LOSS_TOL[0]} (l_g_total "
        f"{ranks[0]['metrics']['l_g_total']:.6f} / "
        f"{want['l_g_total']:.6f}), gradient relative L2 " + ", ".join(
            f"{net} {max(o['grad_rel_l2'][net] for o in ranks):.2e}"
            for net in NETS) + f" (limit {PARITY_GRAD_TOL_DP}); nets equal "
        f"on both ranks after the step (spectral u / v included)")
    say(f"[dp] (b) peak device memory: rank 0 "
        f"{ranks[0]['peak'] / 2 ** 30:.2f} GiB, rank 1 "
        f"{ranks[1]['peak'] / 2 ** 30:.2f} GiB, one process at batch 4 "
        f"{one_peak / 2 ** 30:.2f} GiB; on {smi}")
    return launches


# ---------------------------------------------------------------------------
# image input and the last tools: JPEG / BMP through the CLIs, test_w's GIF,
# parity_report, profile_sr, crop_bg_patches, the largest training batch
# ---------------------------------------------------------------------------

JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "jpeg")
JPEG_ROUNDTRIP = os.path.join(JPEG_FIXTURES, "roundtrip")
JPEG_TIMED = ("line_512x32_420", "line_1400x72_progressive", "bg_400x400")
JPEG_REPEATS = 5
SYNDATA_SAMPLES = 4
RENDER_SEEDS = 40          # the render's host time, as on the CPU suite
GIF_DELAY_CS = 10
PROFILE_ITERS = 3
CROP_IMAGE = (900, 1200)            # (H, W) of the seeded PNG to mine
CROP_PATCHES = 8                    # 3 scales x 2 + 1 scale x 2 (400 px)
# one training step's peak device memory, fitted at batches 2 and 4 in this
# phase: the largest batch is the largest B whose fitted peak fits the card
FIT_BATCHES = (2, 4)


def _write_bmp(path: str, rgb: np.ndarray) -> None:
    """A 24-bit bottom-up BI_RGB BMP of an (H, W, 3) uint8 RGB image."""
    h, w = rgb.shape[:2]
    pitch = (3 * w + 3) & -4
    rows = np.zeros((h, pitch), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    offset = 14 + 40
    header = b"BM" + struct.pack("<IHHI", offset + rows.size, 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 0, 0,
                       0, 0)
    with open(path, "wb") as f:
        f.write(header + info + rows.tobytes())


def _same_files(got_dir: str, want_dir: str, what: str) -> int:
    """Equal file names and bytes in two directories; returns the count."""
    names = sorted(os.listdir(want_dir))
    if sorted(os.listdir(got_dir)) != names:
        raise AssertionError(f"{what}: files {sorted(os.listdir(got_dir))}"
                             f", expected {names}")
    for name in names:
        with open(os.path.join(got_dir, name), "rb") as a, \
                open(os.path.join(want_dir, name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{what}: {name} differs")
    return len(names)


def _gif_blocks(data: bytes) -> dict:
    """Image descriptors, frame delays (hundredths of a second) and loop
    extensions of a GIF89a, by walking its block structure."""
    if data[:6] != b"GIF89a":
        raise AssertionError("w.gif is not a GIF89a")
    flags = data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    frames, delays, loops = 0, [], 0

    def skip_sub_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while data[pos] != 0x3B:
        kind = data[pos]
        if kind == 0x21:
            label = data[pos + 1]
            if label == 0xF9:
                delays.append(struct.unpack("<H", data[pos + 4:pos + 6])[0])
            elif label == 0xFF and data[pos + 3:pos + 14] == b"NETSCAPE2.0":
                loops += 1
            pos = skip_sub_blocks(pos + 2)
        elif kind == 0x2C:
            frames += 1
            flags = data[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)          # LZW minimum code size
        else:
            raise AssertionError(f"w.gif: unknown block 0x{kind:02x}")
    return {"frames": frames, "delays": delays, "loops": loops}


def _collage_width(shape) -> int:
    """The shown width of a line at 128 rows (``preprocess_line``)."""
    h, w = shape[:2]
    return int(round(w * (128 / h)))


def _io_cli(smi: str, ckpt_dir: str, work: str, add) -> None:
    """BMP copies of phase 12's lines through ``test_sr -m`` and
    ``serve_demo`` (equal to phase 12's PNG outputs, bit for bit), the
    JPEG fixtures through both, and ``test_w`` on two JPEG lines."""
    lines_dir = os.path.join(work, "lines")
    bmp_dir = os.path.join(work, "lines_bmp")
    os.makedirs(bmp_dir)
    for name in sorted(os.listdir(lines_dir)):
        stem = os.path.splitext(name)[0]
        _write_bmp(os.path.join(bmp_dir, stem + ".bmp"),
                   read_png(os.path.join(lines_dir, name)))
    common = ["--ckpt_dir", ckpt_dir, "--device", "cuda"]
    out = os.path.join(work, "sr-m-bmp")
    t0 = time.perf_counter()
    done, got = _cli_counted(
        "test_sr -m on BMP", lambda d: sum(r for _, _, r in d),
        lambda: cli_test_sr.main(["-i", bmp_dir, "-o", out, "-m"] + common))
    add(got)
    n = _same_files(out, os.path.join(work, "sr-m"), "test_sr -m on BMP")
    say(f"[io] test_sr -m on {len(done)} BMP lines: {n} collages equal to "
        f"phase 12's from PNG, bit for bit ({time.perf_counter() - t0:.2f} "
        "s)")
    out = os.path.join(work, "serve-bmp")
    res, got = _cli_counted(
        f"serve_demo --repeat {CLI_REPEAT} on BMP",
        lambda r: 2 * r["chunks"],
        lambda: cli_serve_demo.main(["-i", bmp_dir, "-o", out, "--repeat",
                                     str(CLI_REPEAT)] + common))
    add(got)
    n = _same_files(out, os.path.join(work, "serve"), "serve_demo on BMP")
    say(f"[io] serve_demo (front-end, bf16) on BMP: {n} lines equal to "
        f"phase 12's from PNG, bit for bit; warm {res['lines_per_s']:.2f} "
        f"lines/s on {smi}")

    jpeg_dir = os.path.join(work, "lines_jpeg")
    os.makedirs(jpeg_dir)
    shapes = {}
    for name in sorted(os.listdir(JPEG_FIXTURES)):
        if name.endswith(".jpg"):
            shutil.copy(os.path.join(JPEG_FIXTURES, name), jpeg_dir)
            shapes[name] = read_png(os.path.join(
                JPEG_FIXTURES, name[:-4] + ".png")).shape
    out = os.path.join(work, "sr-m-jpeg")
    done, got = _cli_counted(
        "test_sr -m on JPEG", lambda d: sum(r for _, _, r in d),
        lambda: cli_test_sr.main(["-i", jpeg_dir, "-o", out, "-m"] + common))
    add(got)
    fits = sorted(n for n, s in shapes.items()
                  if round(s[1] * 32 / s[0]) <= 512)
    if sorted(d[0] for d in done) != fits:
        raise AssertionError(f"test_sr on JPEG restored {done}, expected "
                             f"{fits}")
    _check_pngs([os.path.join(out, f"{os.path.splitext(n)[0]}_{t}.png")
                 for n, t, _ in done],
                [(4 * 128, _collage_width(shapes[n]), 3)
                 for n, _, _ in done], "test_sr on JPEG")
    # serve_demo, like the JAX tool, takes lines of at most 512 at 32 rows
    fit_dir = os.path.join(work, "lines_jpeg_fit")
    os.makedirs(fit_dir)
    for name in fits:
        shutil.copy(os.path.join(jpeg_dir, name), fit_dir)
    out = os.path.join(work, "serve-jpeg")
    res, got = _cli_counted(
        "serve_demo -m on JPEG", lambda r: 2 * r["chunks"],
        lambda: cli_serve_demo.main(["-i", fit_dir, "-o", out, "-m"]
                                    + common))
    add(got)
    _check_pngs([os.path.join(out, f"{i:03d}_{os.path.splitext(m)[0]}.png")
                 for i, m in enumerate(res["names"])],
                [(128, _collage_width(shapes[m]), 3) for m in res["names"]],
                "serve_demo on JPEG")
    say(f"[io] JPEG fixtures: test_sr -m restored {len(done)} (the "
        f"{len(shapes) - len(fits)} wider than 512 at 32 rows skipped, as "
        f"the JAX tool skips it), serve_demo -m {len(res['names'])}; "
        "every output at its fixture's shape")

    # test_w on the BMP copies of phase 12's two lines: its 11 PNGs and
    # w.gif equal phase 12's, and w.gif has the structure of an animation
    out = os.path.join(work, "w-bmp")
    names = sorted(os.listdir(bmp_dir))
    w1, w2 = (os.path.join(bmp_dir, names[i]) for i in (0, CLI_COPIES))
    _reset_counts()
    t0 = time.perf_counter()
    paths = cli_test_w.main(["-w1", w1, "-w2", w2, "-o", out] + common)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = _counts()
    _check_counts("io", got, {**dict.fromkeys(_WRAPPERS, 0),
                              "fused_leaky_relu": 19}, "test_w on BMP")
    add(got)
    n = _same_files(out, os.path.join(work, "w"), "test_w on BMP")
    if len(paths) != 11 or n != 12:
        raise AssertionError(f"test_w wrote {len(paths)} blends, {n} files")
    n_lab = read_png(paths[0]).shape[1] // 128
    with open(os.path.join(out, "w.gif"), "rb") as f:
        gif = _gif_blocks(f.read())
    if gif != {"frames": 11, "delays": [GIF_DELAY_CS] * 11, "loops": 1}:
        raise AssertionError(f"w.gif: {gif}")
    say(f"[io] test_w on BMP: 11 PNGs of {n_lab} characters and w.gif "
        f"(11 frames of {GIF_DELAY_CS} cs, one loop extension, "
        f"{os.path.getsize(os.path.join(out, 'w.gif'))} bytes) equal to "
        f"phase 12's from PNG; {seconds:.2f} s with the GIF")


def _io_decode(smi: str) -> None:
    """Every JPEG fixture decodes to its committed cv2 decode; host ms a
    decode of the three timed ones."""
    times = {}
    for name in sorted(os.listdir(JPEG_FIXTURES)):
        if not name.endswith(".jpg"):
            continue
        path = os.path.join(JPEG_FIXTURES, name)
        want = read_png(path[:-4] + ".png")
        got = read_jpeg(path)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{name}: decode differs from cv2's")
        stem = name[:-4]
        if stem in JPEG_TIMED:
            ms = []
            for _ in range(JPEG_REPEATS):
                t0 = time.perf_counter()
                read_jpeg(path)
                ms.append((time.perf_counter() - t0) * 1e3)
            times[stem] = (statistics.median(ms), min(ms), got.shape)
    say("[io] JPEG fixtures equal their cv2 decodes, byte for byte; host ms "
        f"a decode (median / min of {JPEG_REPEATS}): " + ", ".join(
            f"{k} {v[2][1]}x{v[2][0]} {v[0]:.2f} / {v[1]:.2f}"
            for k, v in times.items())
        + f"; os.cpu_count() {os.cpu_count()}; card {smi}")


def _io_roundtrip(smi: str) -> None:
    """``jpeg_roundtrip_u8`` (the BSRGAN and paired degradations' JPEG
    step) on the committed sources equals the decode of cv2's encodes of
    them at each committed quality; host ms a round trip, beside
    ``jpeg_np``'s (the numpy DCT round trip it replaced there)."""
    times = []
    names = sorted(os.listdir(JPEG_ROUNDTRIP))
    for src_name in (n for n in names if n.endswith(".png")):
        src = read_png(os.path.join(JPEG_ROUNDTRIP, src_name))
        stem = src_name[:-4]
        jpgs = [n for n in names if n.startswith(stem + "_q")]
        if not jpgs:
            raise AssertionError(f"{src_name}: no encodes beside it")
        for jpg in jpgs:
            quality = int(jpg[len(stem) + 2:-4])
            with open(os.path.join(JPEG_ROUNDTRIP, jpg), "rb") as f:
                want = decode_jpeg(f.read())
            got = jpeg_roundtrip_u8(src, quality)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{jpg}: jpeg_roundtrip_u8 differs "
                                     "from the decode of cv2's encode")
            ms, np_ms = [], []
            for _ in range(JPEG_REPEATS):
                t0 = time.perf_counter()
                jpeg_roundtrip_u8(src, quality)
                t1 = time.perf_counter()
                jpeg_np(src / np.float32(255), quality)
                ms.append((t1 - t0) * 1e3)
                np_ms.append((time.perf_counter() - t1) * 1e3)
            times.append(f"{jpg} {statistics.median(ms):.3f} "
                         f"({statistics.median(np_ms):.3f})")
    say("[io] jpeg_roundtrip_u8 equals the decode of cv2's encode, byte for "
        f"byte, on {len(times)} fixtures; host ms a round trip, median of "
        f"{JPEG_REPEATS} (jpeg_np's in brackets): " + ", ".join(times)
        + f"; card {smi}")


def _io_parity(work: str, add) -> None:
    """``parity_report`` twice at full width (f32) on checkpoints in the
    reference's key names from the port's own seeded nets, a PNG line and
    a JPEG line: NO_REFERENCE_OUTPUTS, then PARITY against the goldens."""
    ckpts = os.path.join(work, "parity_ckpts")
    os.makedirs(ckpts)
    net = MARCONet(device="cuda", seed=7)
    for name, module in zip(REFERENCE_FILES,
                            (net.encoder, net.prior, net.srnet)):
        torch.save({"params": {k: v.cpu() for k, v in
                               module.state_dict().items()}},
                   os.path.join(ckpts, name))
    del net
    testset = os.path.join(work, "parity_testset")
    os.makedirs(testset)
    png_line = sorted(os.listdir(os.path.join(work, "lines")))[0]
    shutil.copy(os.path.join(work, "lines", png_line), testset)
    shutil.copy(os.path.join(JPEG_FIXTURES, "line_512x32_420.jpg"), testset)
    goldens = os.path.join(work, "goldens_torch")
    common = ["--ckpt_dir", ckpts, "--testset", testset, "--golden_dir",
              goldens, "--device", "cuda"]
    verdicts = []
    for i, extra in enumerate(([], ["--ref_outputs", goldens])):
        report = os.path.join(work, f"parity_report{i}.json")
        t0 = time.perf_counter()
        rep, got = _cli_counted(
            f"parity_report run {i + 1}", lambda r: 2 * 2,
            lambda: cli_parity_report.main(common + ["--report", report]
                                           + extra))
        add(got)
        with open(report) as f:
            if json.load(f) != json.loads(json.dumps(rep)):
                raise AssertionError("parity_report: the JSON report is "
                                     "not the returned one")
        verdicts.append((rep["verdict"], rep.get("mean_psnr_vs_reference"),
                         time.perf_counter() - t0))
    if [v[0] for v in verdicts] != ["NO_REFERENCE_OUTPUTS", "PARITY"]:
        raise AssertionError(f"parity_report verdicts {verdicts}")
    bands = sorted(os.listdir(goldens))
    for name in bands:
        if read_png(os.path.join(goldens, name)).shape != (128, 2048, 3):
            raise AssertionError(f"golden {name} is not a 128 x 2048 band")
    say(f"[io] parity_report (f32, full width, a PNG and a JPEG line): "
        f"{verdicts[0][0]} ({verdicts[0][2]:.2f} s), then {verdicts[1][0]} "
        f"at {verdicts[1][1]} dB ({verdicts[1][2]:.2f} s); goldens {bands}")


def _io_profile(smi: str, work: str, add) -> None:
    """``profile_sr`` (bf16, 16 lines x 8 slots, 3 traced restores): the
    Chrome trace parses and its device kernels include exactly 3 x 19 K1
    and 3 x 2 K2 launches by their CUDA function names."""
    path, got = _cli_counted(
        "profile_sr (1 warm-up + 3 traced restores)",
        lambda r: 1 + PROFILE_ITERS,
        lambda: cli_profile_sr.main(["-o", os.path.join(work, "profile"),
                                     "--iters", str(PROFILE_ITERS)]))
    add(got)
    with open(path) as f:
        trace = json.load(f)
    kernels = [e for e in trace["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    k1 = sum("fused_lrelu_fwd_kernel" in e["name"] for e in kernels)
    k2 = sum("sft_writeback_kernel" in e["name"] for e in kernels)
    want = (PROFILE_ITERS * RESTORE_LAUNCHES["fused_leaky_relu"],
            PROFILE_ITERS * RESTORE_LAUNCHES["sft_writeback"])
    if (k1, k2) != want:
        raise AssertionError(f"profile_sr trace: {k1} K1 and {k2} K2 "
                             f"kernels, expected {want}")
    idle = _trace_idle(path)
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    say(f"[io] profile_sr trace {os.path.getsize(path)} bytes: {k1} K1 and "
        f"{k2} K2 kernels in {PROFILE_ITERS} restores; device busy "
        f"{idle['busy']:.2f} of {idle['window']:.2f} ms "
        f"({100 * idle['busy'] / idle['window']:.2f}%); top kernels by self "
        "time: " + "; ".join(f"{k[:70]} {v:.2f} ms" for k, v in top)
        + f"; on {smi}")


def _io_crop(work: str) -> None:
    """``crop_bg_patches`` on a seeded 1200 x 900 PNG and the 400 x 400
    JPEG fixture."""
    src = os.path.join(work, "crop_in")
    os.makedirs(src)
    gen = np.random.default_rng(15)
    write_png(os.path.join(src, "seeded.png"),
              gen.integers(0, 256, CROP_IMAGE + (3,), dtype=np.uint8))
    shutil.copy(os.path.join(JPEG_FIXTURES, "bg_400x400.jpg"), src)
    t0 = time.perf_counter()
    paths = cli_crop_bg_patches.main(["-i", src, "-o",
                                      os.path.join(work, "crop_out")])
    seconds = time.perf_counter() - t0
    if len(paths) != CROP_PATCHES:
        raise AssertionError(f"crop_bg_patches wrote {len(paths)} patches")
    _check_pngs(paths, [(400, 400, 3)] * len(paths), "crop_bg_patches")
    say(f"[io] crop_bg_patches: {len(paths)} patches of 400 x 400 x 3 from "
        f"a {CROP_IMAGE[1]} x {CROP_IMAGE[0]} PNG and the 400 x 400 JPEG in "
        f"{seconds:.2f} s (host)")


def _io_syndata(smi: str, work: str) -> None:
    """``syndata_demo`` (4 samples in the fixture font, flat backgrounds):
    16 PNGs at their shapes and a text per sample; then the host ms of
    one render over ``RENDER_SEEDS`` seeds (one flat background, a fresh
    synthesizer, so the font is parsed and the glyphs rasterized inside
    the timed renders), the timing of ``tests/torch_render_report.py``."""
    out = os.path.join(work, "syndata")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        cli_syndata_demo.main(["-o", out, "-n", str(SYNDATA_SAMPLES),
                               "--font_dir", FONT_DIR,
                               "--bg_dir", os.path.join(work, "no_bg")])
    seconds = time.perf_counter() - t0
    lines = printed.getvalue().splitlines()
    texts = [ln for ln in lines if ln.startswith("sample ")]
    if len(texts) != SYNDATA_SAMPLES or any(ln.endswith("text=''")
                                            for ln in texts):
        raise AssertionError(f"syndata_demo printed {lines}")
    shapes = {"gt": (GT_H, GT_W, 3), "mask": (GT_H, GT_W, 3),
              "lq": (LQ_H, LQ_W, 3), "locs": (GT_H, GT_W, 3)}
    paths, want = [], []
    for i in range(SYNDATA_SAMPLES):
        for name, shape in shapes.items():
            paths.append(os.path.join(out, f"{i:03d}_{name}.png"))
            want.append(shape)
    _check_pngs(paths, want, "syndata_demo")
    if sorted(os.listdir(out)) != sorted(os.path.basename(p) for p in paths):
        raise AssertionError(f"syndata_demo wrote {sorted(os.listdir(out))}")
    say(f"[io] syndata_demo: {SYNDATA_SAMPLES} samples, {len(paths)} PNGs "
        f"in {seconds:.2f} s (host); " + "; ".join(texts))

    raster.glyph_bitmap.cache_clear()
    truetype.load_face.cache_clear()
    synth = TextLineSynthesizer(SynthConfig(font_dir=FONT_DIR))
    bg = synth.background(np.random.default_rng(0))
    drawn, t0 = 0, time.perf_counter()
    for seed in range(RENDER_SEEDS):
        drawn += synth.render(np.random.default_rng(seed), bg) is not None
    ms = (time.perf_counter() - t0) * 1e3 / RENDER_SEEDS
    if drawn < RENDER_SEEDS // 2:
        raise AssertionError(f"{drawn} of {RENDER_SEEDS} renders drawn")
    batch_ms = _host_batch_ms()["render"]
    say(f"[io] render (hinted TrueType, DejaVu Sans): {ms:.2f} host ms a "
        f"line over {RENDER_SEEDS} seeds ({drawn} drawn, cold caches), "
        f"{batch_ms:.1f} host ms a batch of {TRAIN_BATCH} (unhinted before: "
        f"13.72 / 37.1), os.cpu_count() {os.cpu_count()}; on {smi}")
    _io_hinted_glyphs()


def _io_hinted_glyphs() -> None:
    """The port's hinted glyphs on this host against PIL's: each
    character of the digest fixture at each of its sizes, cold caches."""
    with open(HINTED_DIGESTS) as f:
        fixture = json.load(f)
    font_path = os.path.join(os.path.dirname(HINTED_DIGESTS),
                             fixture["font"])
    raster.glyph_bitmap.cache_clear()
    truetype.load_face.cache_clear()
    differ, n = [], 0
    t0 = time.perf_counter()
    for size, digests in fixture["digests"].items():
        font = text_draw.truetype(font_path, int(size))
        for ch, want in zip(fixture["chars"], digests):
            n += 1
            if ink_digest(*font.getmask(ch)) != want:
                differ.append((int(size), ch))
    seconds = time.perf_counter() - t0
    if differ or not n:
        raise AssertionError(f"{len(differ)} of {n} hinted glyphs differ "
                             f"from PIL's ({fixture['made_with']}): "
                             f"{differ[:20]}")
    say(f"[io] hinted glyphs: {n} of {n} ({len(fixture['chars'])} glyphs x "
        f"{len(fixture['digests'])} sizes) ink what PIL's do "
        f"({fixture['made_with']}; SHA-256 in "
        f"{os.path.relpath(HINTED_DIGESTS)}), {seconds:.2f} s on this host")


def _io_largest_batch(smi: str, add) -> None:
    """One f32 training step at the largest batch whose peak memory, fitted
    linearly to steps at batches 2 and 4, fits the card."""
    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    trainer = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                              allow_random_lpips=True)
    gen = np.random.default_rng(16)
    peaks = {}
    _reset_counts()
    for b in FIT_BATCHES:
        batch = TrainBatch.from_numpy(_train_arrays(gen, b, TRAIN_SLOTS),
                                      dev)
        torch.cuda.reset_peak_memory_stats(dev)
        trainer.train_step(batch)
        torch.cuda.synchronize()
        peaks[b] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        del batch
    (b0, p0), (b1, p1) = peaks.items()
    slope = (p1 - p0) / (b1 - b0)
    base = p0 - slope * b0
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    largest = int((total - base) // slope)
    say(f"[io] training step peak memory: {p0:.2f} GiB at B={b0}, {p1:.2f} "
        f"GiB at B={b1}: fit {base:.2f} + {slope:.2f} B GiB; card "
        f"{total:.2f} GiB -> largest B={largest} (fit "
        f"{base + slope * largest:.2f} GiB)")
    batch = TrainBatch.from_numpy(_train_arrays(gen, largest, TRAIN_SLOTS),
                                  dev)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.train_step(batch)                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    got = _counts()
    steps = len(FIT_BATCHES) + 2
    _check_counts("io", got, {k: v * steps for k, v in
                              TRAIN_LAUNCHES.items()},
                  f"{steps} training steps")
    add(got)
    for k, v in metrics.items():
        if not bool(torch.isfinite(v)):
            raise AssertionError(f"non-finite {k} at B={largest}")
    say(f"[io] f32 train_step at B={largest} x {TRAIN_SLOTS} slots: peak "
        f"{peak:.2f} GiB of {total:.2f}, {seconds * 1e3:.2f} ms = "
        f"{largest / seconds:.3f} samples/s (host clock, one step after a "
        f"warm-up) on {smi}")
    del trainer, batch
    torch.cuda.empty_cache()


def phase_io_tools(smi: str, ckpt_dir: str, work: str) -> dict:
    """Phase 15 (see the module docstring). Returns its kernel launches."""
    launches = dict.fromkeys(_WRAPPERS, 0)

    def add(got):
        for k, v in got.items():
            launches[k] += v

    _io_decode(smi)
    _io_roundtrip(smi)
    _io_cli(smi, ckpt_dir, work, add)
    _io_parity(work, add)
    _io_profile(smi, work, add)
    _io_crop(work)
    _io_syndata(smi, work)
    _io_largest_batch(smi, add)
    return launches


# ---------------------------------------------------------------------------
# phase 16: mixed-precision training (bf16 compute over f32 parameters)
# ---------------------------------------------------------------------------

# the bf16 step against the f32 step from one state and batch at the CPU
# suite's reduced size (width 0.0625, 4 slots, B=2): each loss term within
# BF16_LOSS_TOL = (rtol, atol) of its f32 value, each net's gradient within
# BF16_GRAD_RTOL relative L2 of its f32 one. Bounds: about twice the
# largest bf16-vs-f32 distances seen at that size, on the CPU over two
# seeds and on the card (NVIDIA H100 80GB HBM3, 700 W; this phase's
# batch): loss terms within 4.7 % of their value + 1e-4 (the hinge terms
# near 0; the others within 0.83 %); gradients' relative L2: encoder
# 0.18-0.34, SR net 0.04-0.38, prior 0.055-0.082, discriminators
# 0.005-0.018. Random-weight nets in bf16 cross ReLU and leaky-ReLU
# boundaries the f32 nets do not, which moves the encoder's and SR net's
# gradients most
BF16_PARITY = dict(width=0.0625, max_chars=4)
BF16_LOSS_TOL = (0.1, 1e-4)
BF16_GRAD_RTOL = {"encoder": 0.7, "prior": 0.2, "srnet": 0.75,
                  "net_d": 0.05, "net_srd": 0.05}
# the CUDA kernels of the training path, by the names of their templates
TRAIN_KERNEL_NAMES = {"fused_leaky_relu": "fused_lrelu_fwd_kernel",
                      "fused_leaky_relu_bwd": "fused_lrelu_bwd_kernel",
                      "sft_writeback": "sft_writeback_kernel",
                      "sft_writeback_bwd": "sft_writeback_bwd_kernel"}


def _bench_train_arrays(gen: np.random.Generator, batch: int):
    """``tools/bench_train.py``'s batch (lines 60-72): seeded GT lines and
    ink masks, 16 slots with 8 valid characters a line at lefts
    0.05 + 0.115 i, 0.05 wide, through the port's ``prepare_train_batch``."""
    gt = gen.uniform(-1, 1, (batch, 128, 2048, 3)).astype(np.float32)
    ink = (gen.uniform(0, 1, (batch, 128, 2048, 3)) > 0.7).astype(np.float32)
    lq = gen.uniform(-1, 1, (batch, 32, 512, 3)).astype(np.float32)
    labels = np.full((batch, 16), BLANK_INDEX, np.int64)
    box = np.zeros((batch, 32), np.float32)
    lefts = 0.05 + 0.115 * np.arange(8)
    for i in range(batch):
        labels[i, :8] = gen.integers(0, 6735, 8)
        box[i, 0:16:2] = lefts
        box[i, 1:16:2] = lefts + 0.05
    return prepare_train_batch(gt, ink, labels, box, lq)


def _check_f32_state(trainer, what: str) -> None:
    """Parameters, their gradients, buffers and Adam states are f32."""
    for name in NETS:
        net = trainer.net(name)
        for key, p in net.named_parameters():
            if p.dtype != torch.float32 or (p.grad is not None and
                                            p.grad.dtype != torch.float32):
                raise AssertionError(f"{what}: {name}.{key} is {p.dtype}, "
                                     f"grad {getattr(p.grad, 'dtype', None)}")
        for key, b in net.named_buffers():
            if b.dtype != torch.float32:
                raise AssertionError(f"{what}: {name}.{key} is {b.dtype}")
        for st in trainer.optimizers[name].state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                if st[key].dtype != torch.float32:
                    raise AssertionError(f"{what}: {name} Adam {key} is "
                                         f"{st[key].dtype}")


def _bf16_parity() -> None:
    """One bf16 and one f32 step from one seeded state and batch at the
    reduced size, on the card."""
    dev = torch.device("cuda", 0)
    arrays = _train_arrays(np.random.default_rng(17), TRAIN_BATCH,
                           BF16_PARITY["max_chars"])
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        trainer = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                                  allow_random_lpips=True, dtype=dtype,
                                  **BF16_PARITY)
        metrics = trainer.train_step(TrainBatch.from_numpy(arrays, dev))
        grads = {n: torch.cat([p.grad.flatten() for p in
                               trainer.net(n).parameters()])
                 for n in NETS}
        out[dtype] = ({k: float(v) for k, v in metrics.items()}, grads)
    (l32, g32), (lbf, gbf) = out[torch.float32], out[torch.bfloat16]
    rtol, atol = BF16_LOSS_TOL
    worst = max((abs(lbf[k] - l32[k]) - rtol * abs(l32[k]), k) for k in l32)
    rel = {n: _rel_l2(gbf[n], g32[n]) for n in NETS}
    say(f"[train16] bf16 vs f32 step at width {BF16_PARITY['width']}, "
        f"{BF16_PARITY['max_chars']} slots, B={TRAIN_BATCH}: loss terms "
        + ", ".join(f"{k} {abs(lbf[k] - l32[k]):.3g}/{abs(l32[k]):.4g}"
                    for k in l32)
        + f" (limit {rtol:g} x |f32| + {atol:g}); gradients' relative L2 "
        + ", ".join(f"{n} {rel[n]:.4f} (limit {BF16_GRAD_RTOL[n]:g})"
                    for n in NETS))
    if worst[0] > atol:
        raise AssertionError(f"bf16 loss term {worst[1]} off the f32 one")
    for n in NETS:
        if not rel[n] <= BF16_GRAD_RTOL[n]:
            raise AssertionError(f"bf16 gradient of {n}: relative L2 "
                                 f"{rel[n]} > {BF16_GRAD_RTOL[n]}")


def _template(name: str) -> str:
    """``kernel<args>`` of a demangled kernel name (the name itself when it
    has no template arguments)."""
    start, end = name.find("<"), name.find(">(")
    if start < 0 or end < 0:
        return name
    return name[:start].rsplit("::", 1)[-1] + name[start:end + 1]


def _step_kernels(trainer, batch) -> dict:
    """The training path's CUDA kernels in one more step, by name, from
    ``torch.profiler`` (the step's busy time and top operators printed):
    {wrapper: [kernel names]}."""
    prof = _profile_step(trainer, batch, "train16")
    seen = {k: [] for k in TRAIN_KERNEL_NAMES}
    ms = dict.fromkeys(TRAIN_KERNEL_NAMES, 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for wrapper, kernel in TRAIN_KERNEL_NAMES.items():
            if kernel in e.name:
                seen[wrapper].append(e.name)
                ms[wrapper] += e.time_range.elapsed_us() / 1e3
    say("[train16] the port's kernels in that step (device ms): " +
        ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return seen


def phase_train_bf16(smi: str, f32_samples_per_s: float) -> dict:
    """Phase 16 (see the module docstring). Returns its kernel launches."""
    total = dict.fromkeys(_WRAPPERS, 0)

    def add(got):
        for k, v in got.items():
            total[k] += v

    _reset_counts()
    _bf16_parity()
    got = _counts()
    _check_counts("train16", got, {k: 2 * v for k, v in
                                   TRAIN_LAUNCHES.items()},
                  "the two reduced-size steps")
    add(got)
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(18)
    batches = [TrainBatch.from_numpy(_bench_train_arrays(gen, TRAIN_BATCH),
                                     dev) for _ in range(2)]
    steps = TRAIN_STEPS + 1
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        torch.cuda.empty_cache()
        trainer = MARCONetTrainer(TrainConfig(), device=dev, seed=0,
                                  allow_random_lpips=True, dtype=dtype)
        _reset_counts()
        ms, split, peak, last = _timed_steps(trainer, batches, "train16")
        launches = _counts()
        _check_counts("train16", launches,
                      {k: v * steps for k, v in TRAIN_LAUNCHES.items()},
                      f"{steps} {dn} steps")
        _check_f32_state(trainer, f"{dn} trainer")
        add(launches)
        results[dtype] = (ms, split, peak, last)
        if dtype == torch.bfloat16:
            _reset_counts()
            seen = _step_kernels(trainer, batches[0])
            add(_counts())
            for wrapper, names in seen.items():
                want = TRAIN_LAUNCHES[wrapper]
                if len(names) != want or not all("bfloat16" in n
                                                 for n in names):
                    raise AssertionError(
                        f"bf16 step: {len(names)} "
                        f"{TRAIN_KERNEL_NAMES[wrapper]} kernels, expected "
                        f"{want} bf16 ones: {sorted(set(names))}")
            say("[train16] one profiled bf16 step: " + ", ".join(
                f"{len(v)} x " + ", ".join(map(_template, sorted(set(v))))
                for v in seen.values()))
        say(f"[train16] {dn} compute (f32 parameters and Adam states) "
            f"B={TRAIN_BATCH} x {TRAIN_SLOTS} slots, 8 valid characters a "
            f"line (tools/bench_train.py's batch), full width, TF32 off: "
            f"{ms:.2f} ms/step = {TRAIN_BATCH * 1e3 / ms:.3f} samples/s "
            f"over {TRAIN_STEPS} steps; split (ms/step) " + ", ".join(
                f"{k} {v:.2f}" for k, v in split.items())
            + f"; peak device memory {peak:.2f} GiB; last losses: "
            + ", ".join(f"{k} {float(v):.4g}" for k, v in last.items())
            + f" on {smi}")
        del trainer
    (ms32, *_), (msbf, _, peakbf, _) = (results[torch.float32],
                                       results[torch.bfloat16])
    say(f"[train16] bf16 / f32 samples/s on this batch: "
        f"{TRAIN_BATCH * 1e3 / msbf:.3f} / {TRAIN_BATCH * 1e3 / ms32:.3f} "
        f"= {ms32 / msbf:.3f}x; phase 10's f32 rate (3 valid characters a "
        f"line) {f32_samples_per_s:.3f}; bf16 peak {peakbf:.2f} GiB")
    torch.cuda.empty_cache()
    return total


def main() -> None:
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    report = phase_kernels()
    report["conv3x3_same"], k3 = phase_conv3x3(smi)
    phase_parity()
    serve = phase_serve(smi)
    page = phase_page(smi)
    phase_interpolate()
    phase_train_parity()
    train_launches, bare_rate = phase_train(smi)
    with tempfile.TemporaryDirectory() as work:
        ckpt_dir = os.path.join(work, "checkpoints")
        os.makedirs(ckpt_dir)
        phase_frontend(smi, ckpt_dir)
        cli = phase_cli(smi, ckpt_dir, work)
        say(f"[smoke] phases 1-12 in {time.perf_counter() - t0:.1f} s")
        loop = phase_loop(smi, bare_rate)
        say(f"[smoke] phases 1-13 in {time.perf_counter() - t0:.1f} s")
        t14 = time.perf_counter()
        dp = phase_dp(smi, bare_rate)
        say(f"[smoke] phase 14 in {time.perf_counter() - t14:.1f} s")
        t15 = time.perf_counter()
        tools = phase_io_tools(smi, ckpt_dir, work)
        say(f"[smoke] phase 15 in {time.perf_counter() - t15:.1f} s")
    t16 = time.perf_counter()
    train16 = phase_train_bf16(smi, bare_rate)
    say(f"[smoke] phase 16 in {time.perf_counter() - t16:.1f} s")
    kernels = [dict(name=name, **KERNELS[name],
                    launches=k3[name] + serve[name] + page[name]
                    + train_launches[name] + cli[name] + loop[name]
                    + dp[name] + tools[name] + train16[name],
                    **report[name])
               for name in KERNELS]
    say(f"[smoke] phases 1-16 in {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
