"""The three-phase GAN training step (G + encoder + SR / D / SRD).

Counterpart of ``marconet_tpu/train/train_step.py`` (reference
``TSPGANModel.optimize_parameters``, ``Train/tspgan/models/
tspgan_model.py:317-607``), eager PyTorch:

* phase G: encoder -> priors for all B x N slots -> SR net, 13 loss terms
  (CTC, locations, glyph pixels / IoU, GAN terms through the frozen
  discriminators, SR pixels, LPIPS); one backward and one Adam step for
  each of the three nets. The discriminators run in eval mode and the
  backward skips their weights, so their spectral vectors do not move; the
  SR net runs in training mode, so each of its spectral convs advances its
  u / v once; priors and locs are detached on entry to the SR net (the
  reference's train archs detach them, ``tsp_arch.py:202-205,246-249``).
* phase D: ``net_d`` on SR char crops (fake), then on GT char crops
  (real), each forward advancing u / v; hinge loss; one Adam step.
* phase SRD: the same for ``net_srd`` on (crop, glyph) pairs.

Five ``torch.optim.Adam`` with the reference's StyleGAN scaling
(``lr * ratio``, ``betas = (0, 0.99 ** ratio)``, ``eps = 1e-8``,
``ratio = 4/5`` for G nets and ``16/17`` for discriminators) and a
milestone schedule that steps as optax's ``piecewise_constant_schedule``.
Freeze groups keep named parameter groups out of their optimizer.

The state is plain PyTorch: the five nets (with their spectral buffers),
the five optimizers and the step count; ``state_dict`` /
``load_state_dict`` carry all of it (``train/checkpoint.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from marconet_tpu_torch.alphabet import BLANK_INDEX, NUM_CLASSES
from marconet_tpu_torch.models.encoder import MAX_CHARS, TextContextEncoder
from marconet_tpu_torch.models.pipeline import resolve_device
from marconet_tpu_torch.models.prior import StructurePriorGenerator
from marconet_tpu_torch.models.srnet import StructurePriorSRNet
from marconet_tpu_torch.ops.layers import nchw, nhwc
from marconet_tpu_torch.ops.resize import resize_bilinear
from marconet_tpu_torch.ops.window import resample2tap
from marconet_tpu_torch.train import losses as L
from marconet_tpu_torch.train.discriminators import UNetDiscriminatorSN
from marconet_tpu_torch.train.lpips import (
    LPIPS,
    check_lpips_weights,
    load_lpips,
)

NETS = ("encoder", "prior", "srnet", "net_d", "net_srd")


class TrainConfig(NamedTuple):
    """Loss lambdas and optimizer settings (``Train/options/train.yml``
    defaults, as the JAX package's ``TrainConfig``)."""

    lr_g: float = 1e-5
    lr_d: float = 1e-4
    lr_encoder: float = 2e-5
    lr_sr: float = 5e-5
    lr_srd: float = 5e-5
    g_reg_every: int = 4
    d_reg_every: int = 16
    milestones: Tuple[int, ...] = (600_000, 700_000)
    lr_gamma: float = 0.5
    pixel_weight: float = 10.0
    lambda128: float = 2.0
    lambda64: float = 1.0
    lambda32: float = 1.0
    lambda_pix_iou: float = 5.0
    ctc_lambda: float = 1.0
    loc_lambda: float = 0.1
    iou_lambda: float = 1.0
    gan_lambda: float = 0.02
    srgan_lambda: float = 0.02
    lpips_lambda: float = 1.0
    srpixel_weight: float = 10.0
    width: float = 1.0
    max_chars: int = MAX_CHARS
    freeze: Tuple[str, ...] = ()


class TrainBatch(NamedTuple):
    """One training batch, NHWC like the JAX package's (see
    ``marconet_tpu_torch.data.batch_prep.prepare_train_batch``)."""

    lq: torch.Tensor           # (B, 32, 32N, 3) in [-1, 1]
    gt: torch.Tensor           # (B, 128, 128N, 3) in [-1, 1]
    labels: torch.Tensor       # (B, N) int, blank-padded
    boxinfo_lr: torch.Tensor   # (B, 2N) normalized (left, right) pairs
    char_valid: torch.Tensor   # (B, N) 1.0 where width > 0 and not blank
    box_valid: torch.Tensor    # (B, N) 1.0 where width > 0
    gt_chars: torch.Tensor     # (B, N, 128, 128, 3) centered glyphs
    crop_idx: torch.Tensor     # (B, N, 128) int 2-tap resample index
    crop_w0: torch.Tensor      # (B, N, 128) f32 2-tap weight
    patch_valid: torch.Tensor  # (B, N) 128 px patch validity

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray],
                   device) -> "TrainBatch":
        """The batch of ``prepare_train_batch`` on ``device``; to a CUDA
        device through pinned host memory, with copies that do not block
        the host (they are ordered before the step's kernels on the
        stream)."""
        cuda = torch.device(device).type == "cuda"

        def move(a):
            t = torch.from_numpy(np.asarray(a))
            if cuda:
                return t.pin_memory().to(device, non_blocking=True)
            return t.to(device)

        return cls(**{name: move(arrays[name]) for name in cls._fields})


# Freeze group -> (net, frozen parameter-name prefixes): the JAX package's
# ``_FREEZE_GROUPS`` (the reference's stop_update_* switches,
# ``tsp_arch.py:292-294``, ``textvit_arch.py:6-10,100-134``) mapped to the
# port's module names. An empty prefix freezes the whole net.
_FREEZE_GROUPS = {
    "encoder.resnet": ("encoder", ("resnet.",)),
    "encoder.patch_embed": ("encoder", ("transformer.to_patch_embedding.",)),
    "encoder.backbone": ("encoder", ("transformer.transformer.layers.",)),
    "encoder.cls": ("encoder", ("transformer.transformer.layers_cls.",
                                "transformer.linear_cls.")),
    "encoder.locs": ("encoder", ("transformer.transformer.linear_seq_maxlen.",
                                 "transformer.transformer.layers_locs.",
                                 "transformer.linear_locs.")),
    "encoder.w": ("encoder", ("transformer.transformer.layers_w.",
                              "transformer.linear_w_maxlen.",
                              "transformer.linear_w.")),
    "encoder": ("encoder", ("",)),
    "prior": ("prior", ("",)),
    "srnet": ("srnet", ("",)),
    "net_d": ("net_d", ("",)),
    "net_srd": ("net_srd", ("",)),
}


def freeze_prefixes(freeze) -> Dict[str, Tuple[str, ...]]:
    """Net name -> frozen parameter-name prefixes, validated."""
    out: Dict[str, Tuple[str, ...]] = {}
    for name in freeze or ():
        if name not in _FREEZE_GROUPS:
            raise ValueError(f"unknown freeze group {name!r}; valid: "
                             f"{sorted(_FREEZE_GROUPS)}")
        net, prefixes = _FREEZE_GROUPS[name]
        out[net] = out.get(net, ()) + prefixes
    return out


def lr_at(base: float, step: int, milestones, gamma: float) -> float:
    """optax ``piecewise_constant_schedule``: the rate of update number
    ``step`` (0-based) is ``base * gamma ** #{m : step >= m}``."""
    return base * gamma ** sum(step >= int(m) for m in milestones)


def crop_chars(img, crop_idx, crop_w0):
    """Fixed-shape char crops with bilinear x-resampling.

    img (B, H, W, C), crop_idx / crop_w0 (B, N, 128) -> (B, N, H, 128, C):
    the reference's center +- 64 crop with resize-to-128 at truncated
    edges (``tspgan_model.py:524-546``).
    """
    return resample2tap(img, crop_idx, crop_w0)


def _resize_chars(chars, size: int):
    """(B, N, 128, 128, C) -> (B, N, size, size, C), bilinear with
    antialiasing (``jax.image.resize``)."""
    b, n, h, w, c = chars.shape
    out = resize_bilinear(nchw(chars.reshape(b * n, h, w, c)), (size, size))
    return nhwc(out).reshape(b, n, size, size, c)


def _judge(net, x):
    """A discriminator over (B, N, 128, 128, C) crops -> (B, N, 128 * 128)."""
    b, n = x.shape[:2]
    return net(nchw(x.reshape(b * n, *x.shape[2:]))).reshape(b, n, -1)


class MARCONetTrainer:
    """The five nets, LPIPS, five optimizers and the three-phase step.

    Args:
      config: loss lambdas and optimizer settings.
      device: where everything lives; CUDA unless named (never falls back).
      seed: seed of the ``torch.Generator`` that draws every random init.
      num_classes: recognizer / codebook classes (6736 with blank).
      width: channel multiplier of every net (1.0 = the reference; defaults
        to ``config.width``).
      max_chars: character slots per line (16 = the reference; the GT
        canvas is ``128 * max_chars`` wide; defaults to ``config.max_chars``).
      lpips_dir: directory holding the pretrained LPIPS weights.
      allow_random_lpips: train with a random VGG when those weights are
        absent (refused otherwise).
    """

    def __init__(self, config: TrainConfig = TrainConfig(), *,
                 device="cuda", seed: int = 0,
                 num_classes: int = NUM_CLASSES,
                 width: Optional[float] = None,
                 max_chars: Optional[int] = None,
                 lpips_dir: Optional[str] = None,
                 allow_random_lpips: bool = False):
        self.cfg = config
        self.device = resolve_device(device)
        self.width = config.width if width is None else width
        self.max_chars = config.max_chars if max_chars is None else max_chars
        g = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(device=self.device, generator=g)
        self.encoder = TextContextEncoder(num_classes, self.width,
                                          max_length=self.max_chars, **kw)
        self.prior = StructurePriorGenerator(
            num_classes, style_dim=self.encoder.w_dim, width=self.width,
            **kw)
        ch = self.prior.channels
        self.srnet = StructurePriorSRNet(ch[64], ch[32], **kw)
        disc_feat = max(8, int(round(64 * self.width)))
        self.net_d = UNetDiscriminatorSN(3, disc_feat, **kw)
        self.net_srd = UNetDiscriminatorSN(6, disc_feat, **kw)
        self.lpips = LPIPS(self.width, **kw).eval()
        check_lpips_weights(load_lpips(self.lpips, lpips_dir) is not None,
                            allow_random_lpips)

        c = config
        g_ratio = c.g_reg_every / (c.g_reg_every + 1)
        d_ratio = c.d_reg_every / (c.d_reg_every + 1)
        ratio = {"encoder": g_ratio, "prior": g_ratio, "srnet": g_ratio,
                 "net_d": d_ratio, "net_srd": d_ratio}
        lr = {"encoder": c.lr_encoder, "prior": c.lr_g, "srnet": c.lr_sr,
              "net_d": c.lr_d, "net_srd": c.lr_srd}
        self.base_lr = {n: lr[n] * ratio[n] for n in NETS}
        frozen = freeze_prefixes(c.freeze)
        self.optimizers: Dict[str, Optional[torch.optim.Adam]] = {}
        for name in NETS:
            prefixes = frozen.get(name, ())
            params = [p for key, p in self.net(name).named_parameters()
                      if not any(key.startswith(pre) for pre in prefixes)]
            # a wholly frozen net has no optimizer
            self.optimizers[name] = torch.optim.Adam(
                params, lr=self.base_lr[name],
                betas=(0.0, 0.99 ** ratio[name]), eps=1e-8) \
                if params else None
        self.step = 0

    def net(self, name: str) -> torch.nn.Module:
        if name not in NETS:
            raise KeyError(name)
        return getattr(self, name)

    # -- state ------------------------------------------------------------

    def state_dict(self) -> dict:
        """Nets (with spectral buffers), optimizer states and the step."""
        return {"step": self.step,
                "nets": {n: self.net(n).state_dict() for n in NETS},
                "optimizers": {n: (o.state_dict() if o is not None
                                   else None)
                               for n, o in self.optimizers.items()}}

    def load_state_dict(self, state: Mapping) -> None:
        for n in NETS:
            self.net(n).load_state_dict(state["nets"][n], strict=True)
            opt = self.optimizers[n]
            if (opt is None) != (state["optimizers"][n] is None):
                raise ValueError(f"optimizer of {n}: the state's freeze "
                                 "groups differ from this trainer's")
            if opt is not None:
                opt.load_state_dict(state["optimizers"][n])
        self.step = int(state["step"])

    # -- phases -----------------------------------------------------------

    def _update(self, name: str) -> None:
        opt = self.optimizers[name]
        if opt is None:
            return
        c = self.cfg
        for group in opt.param_groups:
            group["lr"] = lr_at(self.base_lr[name], self.step, c.milestones,
                                c.lr_gamma)
        opt.step()

    def _g_loss(self, batch: TrainBatch):
        """Phase G forward: (total loss, metrics, detached crops)."""
        cfg = self.cfg
        b, n = batch.lq.shape[0], self.max_chars
        metrics = {}

        # 1. encoder
        lq = nchw(batch.lq)
        logits, locs_lr, w = self.encoder(lq)
        pred_cw = L.lr_to_center_width(locs_lr)
        gt_cw = L.lr_to_center_width(batch.boxinfo_lr)
        metrics["l_ctc"] = L.ctc_loss(logits, batch.labels) * cfg.ctc_lambda

        # 2. localization (the reference includes padded slots in the
        # SmoothL1 terms; only the IoU term is validity-masked)
        metrics["l_loc_center"] = L.smooth_l1_loss(
            pred_cw[:, 0::2] * 2048.0, gt_cw[:, 0::2] * 2048.0) \
            * cfg.loc_lambda * 2.0
        metrics["l_loc"] = L.smooth_l1_loss(
            locs_lr * 2048.0, batch.boxinfo_lr * 2048.0) * cfg.loc_lambda
        metrics["l_loc_iou"] = L.box_iou_loss(
            pred_cw, gt_cw, batch.box_valid) * cfg.iou_lambda

        # 3. structure priors for all slots
        safe_labels = torch.where(batch.char_valid > 0, batch.labels,
                                  BLANK_INDEX).reshape(-1).long()
        pri = self.prior(w.repeat_interleave(n, dim=0), safe_labels)
        prior128 = nhwc(pri.image).reshape(b, n, 128, 128, 3)
        rgb64 = nhwc(pri.rgb64).reshape(b, n, 64, 64, 3)
        rgb32 = nhwc(pri.rgb32).reshape(b, n, 32, 32, 3)
        cmask = batch.char_valid[:, :, None, None, None]
        metrics["l_g_pix128"] = L.l1_loss(
            prior128, batch.gt_chars, mask=cmask,
            weight=cfg.pixel_weight * cfg.lambda128)
        metrics["l_g_iou128"] = L.soft_iou_loss(
            prior128, batch.gt_chars, mask=cmask) * cfg.lambda_pix_iou
        metrics["l_g_pix64"] = L.l1_loss(
            rgb64, _resize_chars(batch.gt_chars, 64), mask=cmask,
            weight=cfg.pixel_weight * cfg.lambda64)
        metrics["l_g_pix32"] = L.l1_loss(
            rgb32, _resize_chars(batch.gt_chars, 32), mask=cmask,
            weight=cfg.pixel_weight * cfg.lambda32)

        # 4. prior GAN loss (D frozen, spectral vectors not updated)
        cmask3 = batch.char_valid[:, :, None]
        metrics["l_g_gan"] = L.hinge_g_loss(
            _judge(self.net_d, prior128), mask=cmask3) * cfg.gan_lambda

        # 5. SR (priors and locs detached)
        sr = nhwc(self.srnet(lq, pri.feat64.detach(), pri.feat32.detach(),
                             pred_cw.detach(), batch.char_valid))
        metrics["l_sr_pix"] = L.l1_loss(sr, batch.gt,
                                        weight=cfg.srpixel_weight)

        # 6. char crops + GAN terms
        sr_chars = crop_chars(sr, batch.crop_idx, batch.crop_w0)
        gt_chars_rgb = crop_chars(batch.gt, batch.crop_idx, batch.crop_w0)
        metrics["l_sr_d_pr"] = L.hinge_g_loss(
            _judge(self.net_srd,
                   torch.cat([sr_chars, prior128.detach()], -1)),
            mask=cmask3) * cfg.srgan_lambda
        metrics["l_sr_d_r"] = L.hinge_g_loss(
            _judge(self.net_d, sr_chars), mask=cmask3) * cfg.gan_lambda

        # 7. perceptual loss on 128 px patches
        def patches(img):            # (B, 128, 128N, 3) -> (BN, 3, 128, 128)
            p = img.reshape(b, 128, n, 128, 3).permute(0, 2, 1, 3, 4)
            return nchw(p.reshape(b * n, 128, 128, 3))

        lp = self.lpips(patches(sr), patches(batch.gt))
        metrics["l_sr_percep"] = L.masked_mean(
            lp.reshape(b, n), batch.patch_valid) * cfg.lpips_lambda

        total = sum(metrics.values())
        metrics["l_g_total"] = total
        crops = {"sr_chars": sr_chars.detach(),
                 "gt_chars_rgb": gt_chars_rgb.detach(),
                 "prior128": prior128.detach()}
        return total, metrics, crops

    def g_phase(self, batch: TrainBatch):
        """Phase G forward and backward, no optimizer step: gradients are
        left in the encoder's, prior's and SR net's ``.grad``. Returns
        (metrics, detached crops)."""
        for name in ("encoder", "prior", "srnet"):
            self.net(name).train().zero_grad(set_to_none=True)
        self.net_d.eval()
        self.net_srd.eval()
        total, metrics, crops = self._g_loss(batch)
        # only the G nets' gradients: the discriminators pass gradients to
        # their inputs and compute none for their own weights
        total.backward(inputs=[p for name in ("encoder", "prior", "srnet")
                               for p in self.net(name).parameters()
                               if p.requires_grad])
        return metrics, crops

    def _d_phase(self, name: str, fake, real, mask) -> torch.Tensor:
        """Fake then real forward (each advancing u / v), hinge loss,
        backward and update."""
        net = self.net(name).train()
        net.zero_grad(set_to_none=True)
        fake_pred = _judge(net, fake)
        real_pred = _judge(net, real)
        loss = L.hinge_d_loss(real_pred, fake_pred, real_mask=mask,
                              fake_mask=mask)
        loss.backward()
        self._update(name)
        return loss.detach()

    def train_step(self, batch: TrainBatch, marks: Optional[list] = None
                   ) -> Dict[str, torch.Tensor]:
        """One G / D / SRD step; returns the loss terms as 0-d tensors on
        the device (no host sync).

        ``marks``: on CUDA, a list to which a recorded CUDA event is
        appended before phase G and after each phase (four in all), for
        timing the phases without a host sync.
        """
        def mark():
            if marks is not None:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()

        mark()
        metrics, crops = self.g_phase(batch)
        for name in ("encoder", "prior", "srnet"):
            self._update(name)
        metrics = {k: v.detach() for k, v in metrics.items()}
        mark()
        cmask3 = batch.char_valid[:, :, None]
        metrics["l_d"] = self._d_phase(
            "net_d", crops["sr_chars"], crops["gt_chars_rgb"], cmask3)
        mark()
        metrics["l_srd"] = self._d_phase(
            "net_srd",
            torch.cat([crops["sr_chars"], crops["prior128"]], -1),
            torch.cat([crops["gt_chars_rgb"], batch.gt_chars], -1), cmask3)
        mark()
        self.step += 1
        return metrics

    @torch.no_grad()
    def visual_forward(self, batch: TrainBatch) -> Dict[str, torch.Tensor]:
        """Eval pass for the periodic image grids (reference
        ``tspgan_model.py:244-314``): encoder -> priors -> SR with frozen
        spectral vectors. NHWC outputs, as the JAX package's."""
        b, n = batch.lq.shape[0], self.max_chars
        lq = nchw(batch.lq)
        modes = {name: self.net(name).training
                 for name in ("encoder", "prior", "srnet")}
        for name in modes:
            self.net(name).eval()
        try:
            logits, locs_lr, w = self.encoder(lq)
            pred_cw = L.lr_to_center_width(locs_lr)
            safe_labels = torch.where(batch.char_valid > 0, batch.labels,
                                      BLANK_INDEX).reshape(-1).long()
            pri = self.prior(w.repeat_interleave(n, dim=0), safe_labels)
            sr = self.srnet(lq, pri.feat64, pri.feat32, pred_cw,
                            batch.char_valid)
        finally:
            for name, mode in modes.items():
                self.net(name).train(mode)
        return {"sr": nhwc(sr),
                "prior128": nhwc(pri.image).reshape(b, n, 128, 128, 3),
                "pred_cw": pred_cw,
                "pred_ids": logits.argmax(dim=-1)}
