"""YAML training configuration (counterpart of ``marconet_tpu/train/
config.py``).

Reads configs in the reference's ``Train/options/train.yml`` schema (loss
lambdas under ``train:``, per-net optimizers, scheduler milestones,
logger / val / dataset blocks) with the port's own YAML reader
(``utils/yaml_lite.py``; the card's machine has no PyYAML) and maps them
onto :class:`~marconet_tpu_torch.train.train_step.TrainConfig` plus loop
settings, field for field as the JAX package does. Unknown keys are kept
in ``raw``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from marconet_tpu_torch.train.train_step import TrainConfig
from marconet_tpu_torch.utils import yaml_lite


@dataclass
class LoopConfig:
    name: str = "train_marconet_tpu"
    total_iter: int = 8_000_000
    batch_size: int = 2           # per device (train.yml batch_size_per_gpu)
    num_workers: int = 2
    print_freq: int = 10
    save_freq: int = 1000
    val_freq: int = 20
    use_tb_logger: bool = True
    seed: int = 0
    experiments_root: str = "./experiments"
    resume_state: Optional[str] = None
    # dataset
    font_dir: str = ""
    bg_dir: str = ""
    corpus_paths: Tuple[str, ...] = ()
    # warm starts (released torch checkpoints)
    pretrain_dir: Optional[str] = None
    # opt-in to training without pretrained LPIPS VGG weights
    allow_random_lpips: bool = False
    # device count (reference `num_gpu`, train.yml:4); None = "auto". The
    # port trains on one device until its data-parallel slice exists.
    num_devices: Optional[int] = None


@dataclass
class FullConfig:
    train: TrainConfig
    loop: LoopConfig
    raw: Dict[str, Any] = field(default_factory=dict)


def check_one_device(loop: LoopConfig) -> None:
    """Refuse ``num_devices`` above 1: data-parallel training (the JAX
    package's ``parallel/*``) is a later slice of the port (ROADMAP:
    DDP)."""
    if loop.num_devices is not None and loop.num_devices > 1:
        raise ValueError(
            f"num_gpu {loop.num_devices}: the PyTorch port trains on one "
            "device; data-parallel training (torch.distributed DDP, the "
            "counterpart of marconet_tpu/parallel) is not ported yet")


def _get(d: Dict, path: str, default=None):
    cur = d
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def load_config(path: str) -> FullConfig:
    raw = yaml_lite.load(path)

    t = raw.get("train", {})
    train = TrainConfig(
        lr_g=float(_get(t, "optim_g.lr", 1e-5)),
        lr_d=float(_get(t, "optim_d.lr", 1e-4)),
        lr_encoder=float(_get(t, "optim_encoder.lr", 2e-5)),
        lr_sr=float(_get(t, "optim_sr.lr", 5e-5)),
        lr_srd=float(_get(t, "optim_srd.lr", 5e-5)),
        g_reg_every=int(t.get("net_g_reg_every", 4)),
        d_reg_every=int(t.get("net_d_reg_every", 16)),
        milestones=tuple(_get(t, "scheduler.milestones",
                              (600_000, 700_000))),
        lr_gamma=float(_get(t, "scheduler.gamma", 0.5)),
        pixel_weight=float(_get(t, "pixel_opt.loss_weight", 10.0)),
        lambda128=float(t.get("pixel_loss_lambda128", 2.0)),
        lambda64=float(t.get("pixel_loss_lambda64", 1.0)),
        lambda32=float(t.get("pixel_loss_lambda32", 1.0)),
        lambda_pix_iou=float(t.get("pixel_loss_iou", 5.0)),
        ctc_lambda=float(t.get("ctc_loss_lambda", 1.0)),
        loc_lambda=float(t.get("loc_loss_lambda", 0.1)),
        iou_lambda=float(t.get("iou_loss_lambda", 1.0)),
        gan_lambda=float(t.get("gan_loss_lambda", 0.02)),
        srgan_lambda=float(t.get("srgan_loss_lambda", 0.02)),
        lpips_lambda=float(t.get("lpips_loss_lambda", 1.0)),
        srpixel_weight=float(_get(t, "srpixel_opt.loss_weight", 10.0)),
        width=float(t.get("model_width", 1.0)),
        max_chars=int(t.get("model_max_chars", 16)),
        freeze=tuple(t.get("freeze", ()) or ()),
    )

    ds = _get(raw, "datasets.train", {}) or {}
    corpus = tuple(p for p in (ds.get("corpus_path1"),
                               ds.get("corpus_path2"),
                               ds.get("corpus_path3")) if p)
    loop = LoopConfig(
        name=raw.get("name", "train_marconet_tpu"),
        total_iter=int(t.get("total_iter", 8_000_000)),
        batch_size=int(ds.get("batch_size_per_gpu", 2)),
        num_workers=int(ds.get("num_worker_per_gpu", 2)),
        print_freq=int(_get(raw, "logger.print_freq", 10)),
        save_freq=int(_get(raw, "logger.save_checkpoint_freq", 1000)),
        val_freq=int(_get(raw, "val.val_freq", 20)),
        use_tb_logger=bool(_get(raw, "logger.use_tb_logger", True)),
        resume_state=_get(raw, "path.resume_state"),
        font_dir=ds.get("path_font", ""),
        bg_dir=ds.get("path_bg", ""),
        corpus_paths=corpus,
        pretrain_dir=_get(raw, "path.pretrain_dir"),
        allow_random_lpips=bool(t.get("allow_random_lpips", False)),
        num_devices=None if str(raw.get("num_gpu", "auto")) == "auto"
        else int(raw["num_gpu"]),
    )
    check_one_device(loop)
    return FullConfig(train=train, loop=loop, raw=raw)
