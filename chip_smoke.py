#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``marconet_tpu_torch``) once on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits nonzero:

1. device: refuse to run without CUDA; print the card's name and power
   limit (nvidia-smi) and the TF32 switches, which are set off.
2. build: compile the hand-written kernels (csrc/) and time the build.
3. kernels: K1 (fused bias-LeakyReLU) and K2 (SFT write-back) against
   their plain PyTorch versions at the main path's shapes, f32 and bf16;
   max abs difference (expected 0: both do f32 math and round once) and
   CUDA-event times of both.
4. parity: full-width f32 ``restore`` (B=1, 4 slots, 3 valid) on the card
   (kernels, TF32 off) against the CPU (plain versions), same seeded
   weights, within the tolerances of
   tests/test_convert.py::test_full_pipeline_chain_matches_torch.
5. serving: bf16 ``restore`` at full width on bench.py's workload (16
   lines of 8 characters) over several batches; checks shapes, finite
   values, sr in [-1, 1] and that every kernel of the path launched;
   prints crops/s from CUDA events and the per-stage split.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from marconet_tpu_torch import native
from marconet_tpu_torch.models.pipeline import BLANK_INDEX, MARCONet
from marconet_tpu_torch.models.srnet import window_geometry
from marconet_tpu_torch.ops.fused_act import (
    fused_leaky_relu,
    fused_leaky_relu_plain,
)
from marconet_tpu_torch.ops.sft_writeback import (
    sft_writeback,
    sft_writeback_plain,
)

SERVE_BATCH = 16    # bench.py's workload: 16 lines of 8 characters
SERVE_SLOTS = 8
SERVE_REQUESTS = 4  # distinct batches standing in for requests
SERVE_ITERS = 12
KERNELS = {
    "fused_leaky_relu": dict(
        route="cuda", source="marconet_tpu_torch/csrc/fused_act.cu",
        replaces="marconet_tpu/ops/fused_act.py:48"),
    "sft_writeback": dict(
        route="cuda", source="marconet_tpu_torch/csrc/sft_writeback.cu",
        replaces="marconet_tpu/ops/pallas_sft.py:70"),
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
        f" cuda {torch.version.cuda}; cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")
    native.require_hopper(torch.device("cuda", 0))
    return smi


def phase_build() -> None:
    path, seconds = native.build()
    native.library()
    say(f"[build] kernels built in {seconds:.2f} s -> "
        f"{os.path.relpath(path)}")


def _k2_case(gen: np.random.Generator, tgen: torch.Generator, height: int,
             width: int, hw: int, dtype, dev):
    """The sft_32 / sft_64 write-back shapes with S=16 slots: rows mix
    overlapping windows, truncated edge windows and invalid slots."""
    b, s, c = SERVE_BATCH, 16, 256
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


def phase_kernels() -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(0)
    tgen = torch.Generator(device=dev).manual_seed(0)
    report = {name: {"max_abs_err": 0.0} for name in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        k1_cases = {   # 4-D inputs are NHWC-stored (channels_last)
            "style-MLP (128, 512)": (128, 512),
            "StyledConv@128 (128, 128, 128, 128) channels_last":
                (128, 128, 128, 128),
        }
        for label, shape in k1_cases.items():
            x = torch.randn(shape, device=dev, generator=tgen).to(dtype)
            if x.dim() == 4:
                x = x.permute(0, 3, 1, 2)          # channels_last view
            bias = torch.randn(x.shape[1], device=dev, generator=tgen)
            err = max_abs(fused_leaky_relu(x, bias),
                          fused_leaky_relu_plain(x, bias))
            ms = cuda_ms(lambda: fused_leaky_relu(x, bias))
            plain_ms = cuda_ms(lambda: fused_leaky_relu_plain(x, bias))
            say(f"[kernels] K1 {label} {dn}: max_abs_err={err} "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            rep = report["fused_leaky_relu"]
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            if err != 0.0:
                raise AssertionError(f"K1 differs from its plain version "
                                     f"by {err} ({label}, {dn})")
            rep["ms"], rep["plain_ms"] = ms, plain_ms   # last: largest bf16
            del x
        for label, (height, width, hw) in (("sft_32", (32, 512, 16)),
                                           ("sft_64", (64, 1024, 32))):
            args = _k2_case(gen, tgen, height, width, hw, dtype, dev)
            err = max_abs(sft_writeback(*args), sft_writeback_plain(*args))
            ms = cuda_ms(lambda: sft_writeback(*args))
            plain_ms = cuda_ms(lambda: sft_writeback_plain(*args))
            say(f"[kernels] K2 {label} B={SERVE_BATCH} S=16 H={height} "
                f"W={width} win={2 * hw} C=256 {dn}: max_abs_err={err} "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            rep = report["sft_writeback"]
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            if err != 0.0:
                raise AssertionError(f"K2 differs from its plain version "
                                     f"by {err} ({label}, {dn})")
            rep["ms"], rep["plain_ms"] = ms, plain_ms   # last: sft_64 bf16
            del args
    torch.cuda.empty_cache()
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


def phase_serve(smi: str) -> dict:
    """bf16 restore on bench.py's workload, several batches."""
    b, n = SERVE_BATCH, SERVE_SLOTS
    net = MARCONet(dtype=torch.bfloat16, device="cuda", seed=0)
    gen = np.random.default_rng(2)
    centers = [0.06 + 0.11 * c for c in range(n)]   # bench.py's layout
    requests = [[t.cuda() for t in _lines(gen, b, n, n, centers)]
                for _ in range(SERVE_REQUESTS)]

    fused_leaky_relu.launches = 0
    sft_writeback.launches = 0
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
    launches = {"fused_leaky_relu": fused_leaky_relu.launches,
                "sft_writeback": sft_writeback.launches}
    ms = start.elapsed_time(end) / SERVE_ITERS
    for out in outs:
        _check_serving(out, b, n)
    calls = SERVE_ITERS + 1
    expected = {"fused_leaky_relu": calls * 19, "sft_writeback": calls * 2}
    say(f"[serve] launches over {calls} restores: {launches} "
        f"(expected {expected})")
    for name, count in launches.items():
        if count != expected[name]:
            raise AssertionError(f"{name} launched {count} times, "
                                 f"expected {expected[name]}")
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


def main() -> None:
    smi = phase_device()
    phase_build()
    report = phase_kernels()
    phase_parity()
    launches = phase_serve(smi)
    kernels = [dict(name=name, **KERNELS[name], launches=launches[name],
                    **report[name]) for name in KERNELS]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
