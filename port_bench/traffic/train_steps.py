"""Training traffic: the bare three-phase step over a pool of seeded
batches on the device.

The general generator of every training-step mix. A workload's
parameters say what a batch is: ``batch`` lines of ``slots`` character
slots (a GT canvas 128 x 128 * slots), each with a number of valid
characters drawn from ``chars`` with ``size_seed`` (the same for every
run seed) and laid out one a slot, ``box_px`` wide; the run seed draws
the pixels (uniform GT and LQ in [-1, 1], an ink mask of 30%), the
labels (uniform over the alphabet) and each box's offset and width. The
program's ``prepare_train_batch`` turns each into a ``TrainBatch`` on the
device in set-up.

Set-up builds ``MARCONetTrainer`` from the configuration with the
benchmark's weights and runs its first three steps on the pool's first
three batches, recording what the check compares (each step's losses,
every parameter's first gradient as Adam holds it, every parameter's
change over the three steps). The window then runs steps over the pool,
in order, until its seconds have passed, and ends with
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench.reference import nets
from port_bench.reference import train as ref_train

CHECK_STEPS = 3
LOSSES = ("l_g_total", "l_d", "l_srd")


def batch_sizes(params: Dict) -> List[List[int]]:
    """Valid characters of each line of each pool batch, from
    ``size_seed``."""
    gen = np.random.default_rng(params["size_seed"])
    lo, hi = params["chars"]
    return [[int(v) for v in gen.integers(lo, hi + 1, params["batch"])]
            for _ in range(params["batches"])]


def make_batch(gen: np.random.Generator, valid: List[int], slots: int,
               box_px) -> tuple:
    """(gt, ink, labels, boxinfo_lr, lq) numpy arrays of one batch."""
    b, w = len(valid), 128 * slots
    gt = gen.uniform(-1, 1, (b, 128, w, 3)).astype(np.float32)
    ink = (gen.uniform(0, 1, (b, 128, w, 3)) > 0.7).astype(np.float32)
    lq = gen.uniform(-1, 1, (b, 32, w // 4, 3)).astype(np.float32)
    labels = np.full((b, slots), nets.BLANK, np.int64)
    box = np.zeros((b, 2 * slots), np.float32)
    for i, n in enumerate(valid):
        labels[i, :n] = gen.integers(0, nets.BLANK, n)
        width = gen.integers(box_px[0], box_px[1] + 1, n)
        left = np.arange(n) * 128 + gen.integers(0, 128 - width + 1)
        box[i, 0:2 * n:2] = left / w
        box[i, 1:2 * n:2] = (left + width) / w
    return gt, ink, labels, box, lq


def make_pool(params: Dict, seed: int) -> List[tuple]:
    gen = np.random.default_rng(seed)
    return [make_batch(gen, v, params["slots"], params["box_px"])
            for v in batch_sizes(params)]


def specs(width: float, max_chars: int = nets.MAX_CHARS) -> Dict[str, list]:
    return {"encoder": nets.encoder_spec(width, max_chars=max_chars),
            "prior": nets.prior_spec(width),
            "srnet": nets.srnet_spec(width),
            "net_d": nets.disc_spec(3, width),
            "net_srd": nets.disc_spec(6, width),
            "lpips": nets.lpips_spec(width)}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(tensors)
    if not keys:
        return {}
    norms = torch.stack([tensors[k].float().norm() for k in keys]).tolist()
    return dict(zip(keys, norms))


class Driver:
    """Set-up, window and check of one training-step cell."""

    def __init__(self, config: Dict, params: Dict, seed: int,
                 trace: bool, device="cuda"):
        self.config, self.params, self.seed = config, params, seed
        self.trace = trace
        self.device = torch.device(device)
        self.pool = make_pool(params, seed)
        self.check_records: Dict = {}

    def setup(self) -> None:
        from marconet_tpu_torch.data.batch_prep import prepare_train_batch
        from marconet_tpu_torch.train.train_step import (
            NETS,
            MARCONetTrainer,
            TrainBatch,
            TrainConfig,
        )

        from port_bench.weights import make_weights

        cfg = self.config
        slots = self.params["slots"]
        weights = make_weights(specs(cfg["width"], slots), self.seed,
                               self.device)
        tr = MARCONetTrainer(TrainConfig(width=cfg["width"], max_chars=slots),
                             device=self.device, seed=0,
                             allow_random_lpips=True,
                             dtype=getattr(torch, cfg["compute_dtype"]))
        for name, sd in weights.items():
            getattr(tr, name).load_state_dict(sd, strict=True)
        del weights
        self.trainer = tr
        self.batches = [TrainBatch.from_numpy(prepare_train_batch(*raw),
                                              self.device)
                        for raw in self.pool]
        # the first steps, through the window's own call, recorded for the
        # check
        named = {n: dict(tr.net(n).named_parameters()) for n in NETS}
        start = {n: {k: p.detach().clone() for k, p in ps.items()}
                 for n, ps in named.items()}
        self.losses: List[Dict[str, float]] = []
        for i in range(CHECK_STEPS):
            out = tr.train_step(self.batches[i])
            self.losses.append({k: float(out[k]) for k in LOSSES})
            if i == 0:
                self.grads = {}
                for n, ps in named.items():
                    st = tr.optimizers[n].state
                    self.grads[n] = leaf_norms(
                        {k: st[p]["exp_avg"] for k, p in ps.items()
                         if p in st})
        self.changes = {n: leaf_norms({k: p.detach() - start[n][k]
                                       for k, p in ps.items()})
                        for n, ps in named.items()}
        del start
        self.next = CHECK_STEPS
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def program(self) -> list:
        """The program's objects, whose counts the harness reads."""
        return [self.trainer]

    def run(self, seconds: float) -> None:
        tr, pool = self.trainer, self.batches
        self.marks: List[list] = []
        totals = []
        steps = 0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            marks = [] if self.trace else None
            with torch.profiler.record_function("bench/step"):
                out = tr.train_step(pool[self.next % len(pool)], marks=marks)
            totals.append(out["l_g_total"])
            if marks is not None:
                self.marks.append(marks)
            self.next += 1
            steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - start
        self.steps = steps
        finite = torch.isfinite(torch.stack(totals)) if totals else None
        self.failed = int((~finite).sum()) if totals else 0
        self.attempted = steps

    def end_to_end(self) -> Dict[str, float]:
        return {"train_samples_per_s":
                self.params["batch"] * self.steps / self.window_s}

    def records(self) -> Dict:
        phases = [[a.elapsed_time(b) for a, b in zip(m, m[1:])]
                  for m in self.marks]
        return {"kind": "train", "phases_ms": phases, "steps": self.steps,
                "window_s": self.window_s, "batch": self.params["batch"],
                "slots": self.params["slots"]}

    def free(self) -> None:
        self.trainer = None
        self.batches = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ------------------------------------------------------

    def reference(self, rounding=None, count: bool = False) -> Dict:
        """The reference's first three steps from the same weights and
        batches: losses, first gradients' and changes' leaf norms. With
        ``rounding`` "tf32" (the control) every product's operands are
        rounded to TF32, and on the card cuDNN and cuBLAS compute in TF32
        (the backward's products too)."""
        from port_bench.counts import flops
        from port_bench.reference.quant import ROUNDINGS
        from port_bench.weights import make_weights

        width = self.config["width"]
        weights = make_weights(specs(width, self.params["slots"]), self.seed,
                               self.device)
        ref = ref_train.Reference(weights, width,
                                  q=ROUNDINGS[rounding] if rounding else None)
        tf32 = self.config["allow_tf32"] or rounding == "tf32"
        del weights
        start = {n: [p.detach().clone() for p in ref.params[n]]
                 for n in ref.opt}
        keys = {n: [k for k in ref.sd[n]
                    if not k.endswith(("weight_u", "weight_v"))]
                for n in ref.opt}
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        out = {"losses": []}
        try:
            for i in range(CHECK_STEPS):
                arrays = ref_train.prepare_batch(*self.pool[i])
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in arrays.items()}
                if i == 0 and count:
                    box = {}
                    out["step_ops"] = flops.count(
                        lambda: box.setdefault("l", ref.step(batch)))
                    losses = box["l"]
                else:
                    losses = ref.step(batch)
                out["losses"].append(losses)
                if i == 0:
                    out["grads"] = {n: leaf_norms({
                        k: g for k, g in zip(keys[n], ref.first_moments(n))
                        if g is not None}) for n in ref.opt}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flags[0]
            torch.backends.cudnn.allow_tf32 = flags[1]
        out["changes"] = {n: leaf_norms({
            k: p.detach() - s for k, p, s in zip(keys[n], ref.params[n],
                                                start[n])})
            for n in ref.opt}
        return out

    def check(self, rounding=None) -> List[tuple]:
        want = self.reference(count=self.trace)
        if "step_ops" in want:
            self.check_records["step_ops"] = want["step_ops"]
        got = self.reference(rounding) if rounding else {
            "losses": self.losses, "grads": self.grads,
            "changes": self.changes}
        return compare(got, want, self.config["limits"])


def _gap(got: Dict[str, float], want: Dict[str, float], keys) -> float:
    """The worst leaf's gap of norms, against the larger of its own
    reference norm and the median leaf's."""
    if not keys:
        return 0.0
    med = float(np.median([want[k] for k in want]))
    return max(abs(got.get(k, 0.0) - want[k]) / max(want[k], med, 1e-30)
               for k in keys)


def compare(got: Dict, want: Dict, limits: Dict) -> List[tuple]:
    """The numbers compared: the worst relative gap of the three steps'
    losses, of a leaf's first-gradient norm and of a leaf's change over the
    three steps (leaves whose reference gradient is under a thousandth of
    the median leaf's are left out of the change)."""
    loss = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
               for g, w in zip(got["losses"], want["losses"]) for k in LOSSES)
    grad = change = 0.0
    for n, wg in want["grads"].items():
        grad = max(grad, _gap(got["grads"][n], wg, list(wg)))
        med = float(np.median(list(wg.values())))
        moved = [k for k in want["changes"][n]
                 if wg.get(k, 0.0) >= 1e-3 * med]
        change = max(change, _gap(got["changes"][n], want["changes"][n],
                                  moved))
    return [("loss_gap", loss, limits["loss_gap"]),
            ("grad_norm_gap", grad, limits["grad_norm_gap"]),
            ("change_norm_gap", change, limits["change_norm_gap"])]
