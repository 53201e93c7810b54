"""Training checkpoints with ``torch.save`` (counterpart of
``marconet_tpu/train/checkpoint.py``, whose Orbax manager this replaces).

One file per saved step, ``<dir>/step_<step>.pt``, holding the whole
training state: the five nets with their spectral u / v buffers, the five
optimizer states and the step count (``MARCONetTrainer.state_dict``);
not LPIPS, which is never trained and comes from its own files. Old
files beyond ``max_to_keep`` are deleted, as the reference's basicsr
checkpointing and the JAX package's Orbax manager do
(``tspgan_model.py:623-629``, ``train.yml:74,183-184``).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

_PATTERN = re.compile(r"^step_(\d+)\.pt$")


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_PATTERN.match,
                                               os.listdir(ckpt_dir)) if m)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.pt")


def save_state(ckpt_dir: str, trainer, max_to_keep: int = 5) -> str:
    """Save ``trainer``'s state under its step; keep the newest
    ``max_to_keep`` checkpoints. Returns the file written."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, trainer.step)
    tmp = path + ".tmp"
    torch.save(trainer.state_dict(), tmp)
    os.replace(tmp, path)           # a reader never sees a partial file
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest saved step, or ``None``."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_state(ckpt_dir: str, trainer, step: Optional[int] = None):
    """Load the checkpoint of ``step`` (default: the newest) into
    ``trainer``, onto its device. Returns ``trainer``."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    state = torch.load(_path(ckpt_dir, step), map_location=trainer.device,
                       weights_only=True)
    trainer.load_state_dict(state)
    return trainer
