"""Data-parallel training on ``torch.distributed`` (counterpart of
``marconet_tpu/parallel/distributed.py``).

One process (rank) drives one device. Each rank synthesizes only its own
rows of the global batch, runs the three-phase step on them and adds its
gradients into every other rank's with an explicit ``all_reduce`` (SUM)
before each optimizer step. The step's losses are built so that each
rank's loss is its share of the loss over the global batch
(``train/losses.py``: masked means divide by the global mask sums, plain
means by the world size), so the summed gradients are the gradients of
one process over the global batch, as the JAX package's SPMD step
computes them.

No ``DistributedDataParallel`` wrapper: phase G differentiates only the
generator nets through frozen discriminators (``backward(inputs=...)``),
freeze groups leave parameters without gradients, and gloo on CUDA
tensors offers only ``all_reduce`` and ``broadcast``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Mapping, Optional

import torch
import torch.distributed as dist

# environment of a launch by the JAX package's conventions
ENV_COORDINATOR = "MARCONET_COORDINATOR"
ENV_NUM_PROCS = "MARCONET_NUM_PROCS"
ENV_PROC_ID = "MARCONET_PROC_ID"


def _init_method(coordinator: str) -> str:
    """``host:port`` (the JAX package's form) -> ``tcp://host:port``; a
    URL (``tcp://``, ``file://``, ``env://``) is used as given."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def maybe_initialize(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> bool:
    """Join this process to its process group; True when this call
    started one (the caller then ends it with :func:`shutdown`).

    The group is named by the arguments, else by ``MARCONET_COORDINATOR``
    / ``MARCONET_NUM_PROCS`` / ``MARCONET_PROC_ID`` (as the JAX package
    reads them), else by torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``. With none of them set it does nothing and
    the world size is 1. ``backend`` defaults to ``nccl`` when ``device``
    is a CUDA device and ``gloo`` otherwise. A group that is already up
    is kept (False).
    """
    if dist.is_initialized():
        return False
    env = os.environ
    coordinator = coordinator or env.get(ENV_COORDINATOR)
    if num_processes is None and env.get(ENV_NUM_PROCS):
        num_processes = int(env[ENV_NUM_PROCS])
    if process_id is None and env.get(ENV_PROC_ID):
        process_id = int(env[ENV_PROC_ID])
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError(f"coordinator {coordinator!r} needs the number "
                             "of processes and this process's id")
        init_method = _init_method(coordinator)
    elif env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        init_method = "env://"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    else:
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's device index on its host: torchrun's ``LOCAL_RANK``,
    else the rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def local_device(device="cuda") -> torch.device:
    """``device``, with a CUDA device that names no index made this rank's
    own, ``cuda:LOCAL_RANK``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank())
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def local_batch_slice(tree: Mapping[str, Any], global_rows: int
                      ) -> Dict[str, Any]:
    """This rank's contiguous axis-0 rows of a global batch held whole by
    every rank (tests, replays); the loop's workers make only their own
    rows instead."""
    n = world_size()
    if global_rows % n:
        raise ValueError(f"global batch {global_rows} not divisible by {n} "
                         "processes")
    per = global_rows // n
    lo = rank() * per
    return {k: v[lo:lo + per] for k, v in tree.items()}


def broadcast_module_state(module: torch.nn.Module, src: int = 0) -> None:
    """Every rank takes rank ``src``'s parameters and buffers (spectral-norm
    u / v included). No-op at world size 1."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            # NCCL and gloo's CUDA path take dense tensors only
            buf = t if t.is_contiguous() else t.contiguous()
            dist.broadcast(buf, src)
            if buf is not t:
                t.copy_(buf)


def all_reduce_grads(params: Iterable[torch.Tensor],
                     bucket_mb: float = 25) -> int:
    """Sum the ``.grad`` of ``params`` over all ranks in place: the
    gradients are flattened into buckets of about ``bucket_mb`` MiB per
    dtype and device, one ``all_reduce`` a bucket. Parameters without a
    gradient are skipped (every rank must hold gradients for the same
    ones). The buckets go through any group that is up, one of a single
    rank too (its cost is then the copies and the backend's own), and
    through none without a group. Returns the number of collectives."""
    if not dist.is_initialized():
        return 0
    groups: Dict[tuple, list] = {}
    for p in params:
        if p.grad is not None:
            groups.setdefault((p.grad.dtype, p.grad.device), []).append(
                p.grad)
    limit = int(bucket_mb * 2 ** 20)
    calls = 0
    for grads in groups.values():
        bucket, size = [], 0
        for i, g in enumerate(grads):
            bucket.append(g)
            size += g.numel() * g.element_size()
            if size >= limit or i == len(grads) - 1:
                flat = torch.cat([t.reshape(-1) for t in bucket])
                dist.all_reduce(flat)
                offset = 0
                for t in bucket:
                    n = t.numel()
                    t.copy_(flat[offset:offset + n].view_as(t))
                    offset += n
                calls += 1
                bucket, size = [], 0
    return calls


def all_reduce_metrics(metrics: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Sum 0-d loss tensors over all ranks with one ``all_reduce``: each
    rank's terms are its shares of the global batch's losses, so the sums
    are the global losses. Unchanged (no collective) at world size 1."""
    if world_size() == 1:
        return dict(metrics)
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(flat)
    return dict(zip(keys, flat.unbind()))


def barrier() -> None:
    """Wait for every rank (no-op at world size 1)."""
    if world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
