"""Capture a ``torch.profiler`` trace of the restore pipeline (counterpart
of ``tools/profile_sr.py``).

A seeded random bf16 ``MARCONet`` restores ``--batch`` lines of
``--slots`` characters (the JAX tool's inputs: numpy seed 0, labels below
6735, ``bench.py``'s character layout): one warm-up restore, then
``--iters`` restores under ``torch.profiler`` (host and, on the card,
CUDA activity; each restore a ``marconet/restore`` span), exported as a
Chrome trace (``chrome://tracing``, Perfetto) to
``<out_dir>/restore_trace.json``::

    python -m marconet_tpu_torch.cli.profile_sr -o traces/ [--device cpu]

Training traces: ``MARCONET_PROFILE=<dir>`` for ``cli/train.py``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from marconet_tpu_torch.models.pipeline import MARCONet

TRACE = "restore_trace.json"


def restore_inputs(batch: int, slots: int, seed: int = 0):
    """The JAX tool's (lq, labels, locs, mask) as numpy arrays."""
    rng = np.random.default_rng(seed)
    lq = rng.uniform(-1, 1, (batch, 32, 512, 3)).astype(np.float32)
    labels = rng.integers(0, 6735, (batch, slots)).astype(np.int64)
    locs = np.tile([[0.06 + 0.11 * c if i == 0 else 0.03
                     for c in range(slots) for i in range(2)]],
                   (batch, 1)).astype(np.float32)
    mask = np.ones((batch, slots), np.float32)
    return lq, labels, locs, mask


def profile_restore(net: MARCONet, out_dir: str, batch: int = 16,
                    slots: int = 8, iters: int = 3) -> str:
    """Warm up, then trace ``iters`` restores of ``net``; returns the
    Chrome trace's path."""
    dev = net.device
    inputs = [torch.from_numpy(a).to(dev)
              for a in restore_inputs(batch, slots)]
    float(net.restore(*inputs).sr.float().mean())     # warm-up + sync
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(iters):
            with record_function("marconet/restore"):
                out = net.restore(*inputs)
        float(out.sr.float().mean())
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, TRACE)
    prof.export_chrome_trace(path)
    print(f"trace written to {path}")
    return path


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-o", "--out_dir", default="marconet_trace")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the networks run (cuda or cpu)")
    return p


def main(argv=None) -> str:
    args = parser().parse_args(argv)
    net = MARCONet(dtype=torch.bfloat16, device=args.device, seed=0)
    return profile_restore(net, args.out_dir, args.batch, args.slots,
                           args.iters)


if __name__ == "__main__":
    main()
