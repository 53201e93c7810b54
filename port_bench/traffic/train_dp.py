"""Data-parallel training traffic: the bare three-phase step on several
cards, one rank a card, over ``parallel/distributed.py``.

The harness's process is rank 0 on its device: set-up opens the group's
store at a free port of ``localhost`` and starts ranks 1 .. ``world`` - 1 as
processes of this file on the next devices (``cuda:r``, or the CPU with
gloo), which join the group through
``parallel/distributed.maybe_initialize`` (NCCL on CUDA). Each rank holds its own pool of ``batches`` batches of
``batch`` lines x ``slots`` slots, made as
:mod:`port_bench.traffic.train_steps` makes them with ``size_seed`` offset
by the rank and the pixels drawn from (run seed, rank); the global batch is
``world`` x ``batch`` lines. Every rank draws the same weights from the run
seed, and rank 0's are broadcast over them.

Set-up runs the first three steps on every rank, rank 0 recording its
global losses, its first gradients (Adam's first moment, beta1 0) and the
changes of its parameters over the three steps. In the window every rank
steps over its pool in a closed loop; before each step rank 0 tells the
others through a gloo group whether the window goes on.

The check recomputes the three steps with :class:`GlobalReference`: one
process over the ranks' batches of each step, each batch's loss terms
weighted by its share of the global batch (its characters, boxes or
patches over the global counts for masked means, 1 / ``world`` for plain
means), the gradients summed over the batches, which is the program's
sum over ranks of its global-batch shares. ``python3 port_bench/traffic/
train_dp.py --rank r ...`` is a rank's entry point.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from typing import Dict, List

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench.reference import train as ref_train  # noqa: E402
from port_bench.traffic import train_steps  # noqa: E402

# the mask that weighs each loss term's share of the global batch (None: a
# plain mean, 1 / world); every other term is a mean over the characters
TERM_MASK = {"l_ctc": None, "l_loc_center": None, "l_loc": None,
             "l_sr_pix": None, "l_loc_iou": "box_valid",
             "l_sr_percep": "patch_valid"}
JOIN_S = 300
INIT_TIMEOUT = timedelta(minutes=5)


def rank_pool(params: Dict, seed: int, rank: int) -> List[tuple]:
    """Rank ``rank``'s pool: sizes from ``size_seed + rank``, pixels from
    (``seed``, ``rank``)."""
    return train_steps.make_pool(
        dict(params, size_seed=params["size_seed"] + rank), [seed, rank])


def _add(a, b):
    if a is None:
        return b
    return a if b is None else a + b


class GlobalReference(ref_train.Reference):
    """The reference's step over the global batch of several local
    batches, one local batch in memory at a time."""

    def _vectors(self, names):
        return {n: {k: v for k, v in self.sd[n].items()
                    if k.endswith(("weight_u", "weight_v"))} for n in names}

    def _grads(self, name_params, losses):
        """Gradients of the sum of ``losses`` (callables, one at a time)
        over ``name_params``; returns (gradients, summed loss)."""
        grads, total = [None] * len(name_params), 0.0
        for loss_fn in losses:
            loss = loss_fn()
            gs = torch.autograd.grad(loss, name_params, allow_unused=True)
            grads = [_add(a, g) for a, g in zip(grads, gs)]
            total += float(loss.detach())
        return grads, total

    def global_step(self, batches: List[Dict]) -> Dict[str, float]:
        """One G / D / SRD step over ``batches`` (one a rank); returns its
        three global losses."""
        counts = {k: sum(float(b[k].sum()) for b in batches)
                  for k in ("char_valid", "box_valid", "patch_valid")}

        def weight(b, mask):
            if mask is None:
                return 1.0 / len(batches)
            return float(b[mask].sum()) / counts[mask]

        vectors = self._vectors(self.sd)
        crops = []

        def g_loss(b):
            def run():
                for n, vs in vectors.items():
                    self.sd[n].update(vs)
                _, m, c = self.g_loss(b)
                crops.append(c)
                return sum(m[k] * weight(b, TERM_MASK.get(k, "char_valid"))
                           for k in m)
            return run

        flat = [p for n in ref_train.G_NETS for p in self.params[n]]
        grads, l_g = self._grads(flat, [g_loss(b) for b in batches])
        it = iter(grads)
        for n in ref_train.G_NETS:
            self._step(n, [next(it) for _ in self.params[n]])
        l_d = self._global_d("net_d", [
            (sr_chars, gt_rgb, b, weight(b, "char_valid"))
            for (sr_chars, gt_rgb, _), b in zip(crops, batches)])
        l_srd = self._global_d("net_srd", [
            (torch.cat([sr_chars, prior], -1),
             torch.cat([gt_rgb, b["gt_chars"]], -1), b,
             weight(b, "char_valid"))
            for (sr_chars, gt_rgb, prior), b in zip(crops, batches)])
        return {"l_g_total": l_g, "l_d": l_d, "l_srd": l_srd}

    def _global_d(self, name, items) -> float:
        start = self._vectors([name])[name]

        def d_loss(fake, real, b, w):
            def run():
                self.sd[name].update(start)
                mask = b["char_valid"][:, :, None]
                f = self._judge(name, fake, train=True)
                r = self._judge(name, real, train=True)
                return (ref_train.masked_mean(F.relu(1.0 - r), mask)
                        + ref_train.masked_mean(F.relu(1.0 + f), mask)) * w
            return run

        grads, total = self._grads(self.params[name],
                                   [d_loss(*item) for item in items])
        self._step(name, grads)
        return total


class Driver(train_steps.Driver):
    """Set-up, window and check of one rank of a data-parallel cell (rank 0
    is the harness's)."""

    def __init__(self, config: Dict, params: Dict, seed: int,
                 trace: bool, device="cuda", rank: int = 0,
                 port: int = 0):
        self.config, self.params, self.seed = config, params, seed
        self.trace = trace
        self.device = torch.device(device)
        self.rank, self.world = rank, int(params["world"])
        self.port = port
        self.pool = rank_pool(params, seed, rank)
        self.check_records: Dict = {}
        self.procs: List[subprocess.Popen] = []

    def _spawn(self) -> None:
        base = [sys.executable, os.path.abspath(__file__), "--port",
                str(self.port), "--seed", str(self.seed), "--config",
                json.dumps(self.config), "--params", json.dumps(self.params)]
        env = dict(os.environ, PYTHONPATH=ROOT)
        for r in range(1, self.world):
            dev = "cpu" if self.device.type == "cpu" else f"cuda:{r}"
            self.procs.append(subprocess.Popen(
                base + ["--rank", str(r), "--device", dev], cwd=ROOT,
                env=env, stdout=subprocess.DEVNULL))

    def setup(self) -> None:
        import torch.distributed as dist

        from marconet_tpu_torch.data.batch_prep import prepare_train_batch
        from marconet_tpu_torch.parallel import distributed
        from marconet_tpu_torch.train.train_step import (
            NETS,
            MARCONetTrainer,
            TrainBatch,
            TrainConfig,
        )

        from port_bench.weights import make_weights

        if self.rank == 0:
            # rank 0 holds the rendezvous port before the other ranks start,
            # so that no other socket can take it in between
            self.store = dist.TCPStore("localhost", 0, self.world, True,
                                       timeout=INIT_TIMEOUT,
                                       wait_for_workers=False)
            self.port = self.store.port
            self._spawn()
            dist.init_process_group(
                "nccl" if self.device.type == "cuda" else "gloo",
                store=dist.PrefixStore("default_pg", self.store),
                world_size=self.world, rank=0, timeout=INIT_TIMEOUT)
        else:
            distributed.maybe_initialize(f"localhost:{self.port}",
                                         self.world, self.rank,
                                         device=self.device)
        self.ctrl = dist.new_group(backend="gloo")
        cfg, slots = self.config, self.params["slots"]
        weights = make_weights(train_steps.specs(cfg["width"], slots),
                               self.seed, self.device)
        tr = MARCONetTrainer(TrainConfig(width=cfg["width"], max_chars=slots),
                             device=self.device, seed=0,
                             allow_random_lpips=True,
                             dtype=getattr(torch, cfg["compute_dtype"]))
        for name, sd in weights.items():
            net = getattr(tr, name)
            net.load_state_dict(sd, strict=True)
            distributed.broadcast_module_state(net)
        del weights
        self.trainer = tr
        self.batches = [TrainBatch.from_numpy(prepare_train_batch(*raw),
                                              self.device)
                        for raw in self.pool]
        named = {n: dict(tr.net(n).named_parameters()) for n in NETS}
        start = {n: {k: p.detach().clone() for k, p in ps.items()}
                 for n, ps in named.items()}
        self.losses: List[Dict[str, float]] = []
        for i in range(train_steps.CHECK_STEPS):
            out = tr.train_step(self.batches[i])
            self.losses.append({k: float(out[k]) for k in train_steps.LOSSES})
            if i == 0:
                self.grads = {}
                for n, ps in named.items():
                    st = tr.optimizers[n].state
                    self.grads[n] = train_steps.leaf_norms(
                        {k: st[p]["exp_avg"] for k, p in ps.items()
                         if p in st})
        self.changes = {n: train_steps.leaf_norms(
            {k: p.detach() - start[n][k] for k, p in ps.items()})
            for n, ps in named.items()}
        del start
        self.next = train_steps.CHECK_STEPS
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def run(self, seconds: float) -> None:
        import torch.distributed as dist

        tr, pool = self.trainer, self.batches
        self.marks: List[list] = []
        totals = []
        steps = 0
        flag = torch.ones(1, dtype=torch.int32)
        start = time.perf_counter()
        while True:
            if self.rank == 0:
                flag[0] = int(time.perf_counter() - start < seconds)
            dist.broadcast(flag, 0, group=self.ctrl)
            if not int(flag[0]):
                break
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
        return {"train_samples_per_s": self.world * self.params["batch"]
                * self.steps / self.window_s}

    def records(self) -> Dict:
        rec = super().records()
        rec.update(kind="train_dp", world=self.world)
        return rec

    def free(self) -> None:
        from marconet_tpu_torch.parallel import distributed

        if getattr(self, "trainer", None) is not None:
            distributed.barrier()
            distributed.shutdown()
        self.store = None
        for p in self.procs:
            try:
                p.wait(JOIN_S)
            except subprocess.TimeoutExpired:
                p.kill()
                self.failed = max(getattr(self, "failed", 0), 1)
            if p.returncode:
                self.failed = max(getattr(self, "failed", 0), 1)
        self.procs = []
        super().free()

    # -- correctness ------------------------------------------------------

    def reference(self, rounding=None, count: bool = False) -> Dict:
        """The reference's first three global steps from the same weights
        and every rank's batches: losses, first gradients' and changes'
        leaf norms (with ``rounding`` "tf32", the control)."""
        from port_bench.reference.quant import ROUNDINGS
        from port_bench.weights import make_weights

        width = self.config["width"]
        weights = make_weights(train_steps.specs(width, self.params["slots"]),
                               self.seed, self.device)
        ref = GlobalReference(weights, width,
                              q=ROUNDINGS[rounding] if rounding else None)
        del weights
        pools = [rank_pool(self.params, self.seed, r)
                 for r in range(self.world)]
        tf32 = self.config["allow_tf32"] or rounding == "tf32"
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
            for i in range(train_steps.CHECK_STEPS):
                batches = [{k: torch.from_numpy(v).to(self.device)
                            for k, v in ref_train.prepare_batch(
                                *pool[i]).items()} for pool in pools]
                out["losses"].append(ref.global_step(batches))
                if i == 0:
                    out["grads"] = {n: train_steps.leaf_norms({
                        k: g for k, g in zip(keys[n], ref.first_moments(n))
                        if g is not None}) for n in ref.opt}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flags[0]
            torch.backends.cudnn.allow_tf32 = flags[1]
        out["changes"] = {n: train_steps.leaf_norms({
            k: p.detach() - s for k, p, s in zip(keys[n], ref.params[n],
                                                start[n])})
            for n in ref.opt}
        return out

    def check(self, rounding=None) -> List[tuple]:
        want = self.reference()
        got = self.reference(rounding) if rounding else {
            "losses": self.losses, "grads": self.grads,
            "changes": self.changes}
        return train_steps.compare(got, want, self.config["limits"])


def main(argv=None) -> int:
    """A rank other than 0: set up, step until rank 0 ends the window,
    leave the group."""
    p = argparse.ArgumentParser(description=main.__doc__)
    for name in ("--rank", "--port", "--seed"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--params", required=True)
    args = p.parse_args(argv)
    config = json.loads(args.config)
    from port_bench import harness

    harness.set_threads(config)
    harness.set_precision(config)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # oneDNN's strided 1x1 channels_last conv backward over 8 channels
        # (the encoder at small widths) corrupts the heap on some CPU builds
        torch.backends.mkldnn.enabled = False
    drv = Driver(config, json.loads(args.params), args.seed, False,
                 device=device, rank=args.rank, port=args.port)
    drv.setup()
    drv.run(0.0)
    drv.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
