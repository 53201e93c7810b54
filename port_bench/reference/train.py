"""Plain reference of MARCONet's training step, in float32.

The reference's ``TSPGANModel.optimize_parameters``
(``Train/tspgan/models/tspgan_model.py``) with ``Train/options/train.yml``'s
settings, written with plain PyTorch over the functional networks of
:mod:`port_bench.reference.nets`:

* phase G: encoder -> priors of every slot -> SR net (priors and
  predicted locs detached, spectral vectors advanced once), thirteen loss
  terms (CTC, locations, glyph pixels and IoU, GAN terms through the
  discriminators with their stored spectral vectors, SR pixels, LPIPS),
  one gradient over the three nets and one Adam step each;
* phase D: ``net_d`` on the SR character crops (fake), then the GT crops
  (real), each forward advancing its spectral vectors; hinge loss; Adam;
* phase SRD: the same for ``net_srd`` on (crop, glyph) pairs.

Adam takes the StyleGAN scaling of the reference (``lr * ratio``,
``betas = (0, 0.99 ** ratio)``, ``eps = 1e-8``, ratio 4/5 for the G nets
and 16/17 for the discriminators). :func:`prepare_batch` derives the
batch's masks, glyph canvases and crop taps from the raw arrays, as the
reference's loop does.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import nets

G_NETS = ("encoder", "prior", "srnet")
D_NETS = ("net_d", "net_srd")
LR = {"encoder": 2e-5, "prior": 1e-5, "srnet": 5e-5, "net_d": 1e-4,
      "net_srd": 5e-5}
RATIO = {n: 4 / 5 for n in G_NETS} | {n: 16 / 17 for n in D_NETS}
CHAR = 128


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------


def _crop_taps(center: int, width: int, half: int = 64):
    x1 = 0 if center < half else center - half
    x2 = width if center + half > width else center + half
    lw = x2 - x1
    j = np.arange(2 * half)
    if lw == 2 * half:
        return (x1 + j).astype(np.int64), np.ones(2 * half, np.float32)
    s = np.clip((j + 0.5) * lw / (2.0 * half) - 0.5, 0.0, lw - 1.0)
    i0 = np.floor(s)
    return (x1 + i0).astype(np.int64), (1.0 - (s - i0)).astype(np.float32)


def prepare_batch(gt, ink, labels, boxinfo_lr, lq) -> Dict[str, np.ndarray]:
    """The reference loop's per-batch derivations (character masks, the
    centered ground-truth glyphs, the crop-and-resize taps of each
    character, the valid 128 px patches). Boxes wider than 128 px are not
    supported here."""
    b, n = labels.shape
    gt_w = gt.shape[2]
    out = {k: np.zeros((b, n), np.float32)
           for k in ("char_valid", "box_valid", "patch_valid")}
    out["gt_chars"] = np.full((b, n, CHAR, CHAR, 3), -1.0, np.float32)
    out["crop_idx"] = np.zeros((b, n, CHAR), np.int64)
    out["crop_w0"] = np.ones((b, n, CHAR), np.float32)
    for i in range(b):
        max_right = 0
        for c in range(n):
            left, right = boxinfo_lr[i, 2 * c], boxinfo_lr[i, 2 * c + 1]
            if right - left <= 0.0:
                continue
            out["box_valid"][i, c] = 1.0
            max_right = max(max_right, int(right * gt_w))
            if labels[i, c] == nets.BLANK:
                continue
            out["char_valid"][i, c] = 1.0
            lp, rp = int(left * gt_w), int(right * gt_w)
            if rp - lp > CHAR:
                raise ValueError("a character box wider than 128 px")
            if rp > lp:
                off = 64 - (rp - lp) // 2
                out["gt_chars"][i, c, :, off:off + rp - lp] = \
                    ink[i, :, lp:rp].astype(np.float32) * 2.0 - 1.0
            out["crop_idx"][i, c], out["crop_w0"][i, c] = _crop_taps(
                int((lp + rp) / 2), gt_w)
        out["patch_valid"][i, :min(max_right // CHAR + 1, n)] = 1.0
    out.update(lq=lq.astype(np.float32), gt=gt.astype(np.float32),
               labels=labels.astype(np.int64),
               boxinfo_lr=boxinfo_lr.astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def masked_mean(x, mask):
    m = torch.broadcast_to(mask, x.shape)
    return (x * m).sum() / m.sum().clamp(min=1e-8)


def smooth_l1(a, b):
    d = (a - b).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


def lr_to_cw(lr):
    left, right = lr[:, 0::2], lr[:, 1::2]
    return torch.stack([(left + right) / 2, (right - left) / 2],
                       -1).reshape(lr.shape)


def box_iou_loss(pred, gt, valid):
    pc, pw = pred[:, 0::2] * 2048.0, pred[:, 1::2] * 2048.0
    gc, gw = gt[:, 0::2] * 2048.0, gt[:, 1::2] * 2048.0
    inter = (torch.minimum(pc + pw, gc + gw)
             - torch.maximum(pc - pw, gc - gw)).clamp(min=0.0)
    union = 2 * pw + 2 * gw - inter
    return masked_mean(1.0 - inter / union.clamp(min=1e-6), valid)


def soft_iou(pred, target):
    p, t = (pred + 1) / 2, (target + 1) / 2
    return 1.0 - p * t / (p + t - p * t).clamp(min=1e-6)


def ctc(logits, labels):
    b, t, _ = logits.shape
    lengths = (labels != nets.BLANK).sum(1)
    per = F.ctc_loss(F.log_softmax(logits, -1).transpose(0, 1), labels,
                     torch.full((b,), t, dtype=torch.long,
                                device=logits.device),
                     lengths, blank=nets.BLANK, reduction="none")
    return (per / lengths.clamp(min=1).float()).mean()


def crop(img, idx, w0):
    """img (B, H, W, C) -> (B, N, H, 128, C): 2-tap resample at idx."""
    b, h, w, _ = img.shape
    i1 = (idx + 1).clamp(max=w - 1)
    bi = torch.arange(b, device=img.device)[:, None, None, None]
    hi = torch.arange(h, device=img.device)[None, None, :, None]
    wt = w0[:, :, None, :, None]
    return img[bi, hi, idx[:, :, None, :]] * wt + \
        img[bi, hi, i1[:, :, None, :]] * (1.0 - wt)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


class Reference:
    """The five nets' state (parameters, spectral vectors, Adam) and the
    three-phase step; ``lpips`` is frozen."""

    def __init__(self, weights: Dict[str, Dict[str, torch.Tensor]],
                 width: float = 1.0, q=None):
        self.width = width
        self.q = q
        self.sd = {}
        self.params: Dict[str, List[torch.Tensor]] = {}
        for name, sd in weights.items():
            sd = {k: v.detach().clone() for k, v in sd.items()}
            if name != "lpips":
                self.params[name] = [v.requires_grad_() for k, v in sd.items()
                                     if not k.endswith(("weight_u",
                                                        "weight_v"))]
            self.sd[name] = sd
        self.opt = {n: torch.optim.Adam(
            self.params[n], lr=LR[n] * RATIO[n],
            betas=(0.0, 0.99 ** RATIO[n]), eps=1e-8, foreach=False)
            for n in G_NETS + D_NETS}

    def ctx(self, name: str, train: bool = False) -> nets.Ctx:
        return nets.Ctx(self.sd[name], q=self.q, train=train)

    def _judge(self, name, x, train=False):
        b, n = x.shape[:2]
        out = nets.disc_forward(self.ctx(name, train),
                                x.reshape(b * n, *x.shape[2:])
                                .permute(0, 3, 1, 2))
        return out.reshape(b, n, -1)

    def g_loss(self, batch):
        b, n = batch["labels"].shape
        lq = batch["lq"].permute(0, 3, 1, 2)
        logits, locs_lr, w = nets.encoder_forward(self.ctx("encoder"), lq)
        pred_cw, gt_cw = lr_to_cw(locs_lr), lr_to_cw(batch["boxinfo_lr"])
        m = {"l_ctc": ctc(logits, batch["labels"]),
             "l_loc_center": smooth_l1(pred_cw[:, 0::2] * 2048.0,
                                       gt_cw[:, 0::2] * 2048.0) * 0.2,
             "l_loc": smooth_l1(locs_lr * 2048.0,
                                batch["boxinfo_lr"] * 2048.0) * 0.1,
             "l_loc_iou": box_iou_loss(pred_cw, gt_cw, batch["box_valid"])}
        valid = batch["char_valid"]
        labels = torch.where(valid > 0, batch["labels"], nets.BLANK)
        img, f64, f32, rgb64, rgb32 = nets.prior_forward(
            self.ctx("prior"), w.repeat_interleave(n, 0), labels.reshape(-1))
        def nhwc(t, size):
            return t.permute(0, 2, 3, 1).reshape(b, n, size, size, 3)

        prior128 = nhwc(img, 128)
        cmask = valid[:, :, None, None, None]
        gt_chars = batch["gt_chars"]

        def small(size):
            t = F.interpolate(gt_chars.reshape(b * n, 128, 128, 3)
                              .permute(0, 3, 1, 2), size=(size, size),
                              mode="bilinear", align_corners=False,
                              antialias=True)
            return t.permute(0, 2, 3, 1).reshape(b, n, size, size, 3)

        m["l_g_pix128"] = masked_mean((prior128 - gt_chars).abs(),
                                      cmask) * 20
        m["l_g_iou128"] = masked_mean(soft_iou(prior128, gt_chars), cmask) * 5
        m["l_g_pix64"] = masked_mean((nhwc(rgb64, 64) - small(64)).abs(),
                                     cmask) * 10
        m["l_g_pix32"] = masked_mean((nhwc(rgb32, 32) - small(32)).abs(),
                                     cmask) * 10
        cmask3 = valid[:, :, None]
        m["l_g_gan"] = -masked_mean(self._judge("net_d", prior128),
                                    cmask3) * 0.02
        sel = [torch.nonzero(valid[i] > 0)[:, 0] for i in range(b)]
        centers = pred_cw.detach()[:, 0::2]
        sr = nets.srnet_forward(
            self.ctx("srnet", train=True), lq,
            [f64.detach().reshape(b, n, *f64.shape[1:])[i][s]
             for i, s in enumerate(sel)],
            [f32.detach().reshape(b, n, *f32.shape[1:])[i][s]
             for i, s in enumerate(sel)],
            [[float(c) for c in centers[i][s]] for i, s in enumerate(sel)])
        sr = sr.permute(0, 2, 3, 1)
        m["l_sr_pix"] = (sr - batch["gt"]).abs().mean() * 10
        sr_chars = crop(sr, batch["crop_idx"], batch["crop_w0"])
        gt_rgb = crop(batch["gt"], batch["crop_idx"], batch["crop_w0"])
        m["l_sr_d_pr"] = -masked_mean(self._judge(
            "net_srd", torch.cat([sr_chars, prior128.detach()], -1)),
            cmask3) * 0.02
        m["l_sr_d_r"] = -masked_mean(self._judge("net_d", sr_chars),
                                     cmask3) * 0.02

        def patches(t):
            p = t.reshape(b, 128, n, 128, 3).permute(0, 2, 4, 1, 3)
            return p.reshape(b * n, 3, 128, 128)

        lp = nets.lpips_forward(self.ctx("lpips"), patches(sr),
                                patches(batch["gt"]), self.width)
        m["l_sr_percep"] = masked_mean(lp.reshape(b, n),
                                       batch["patch_valid"])
        total = sum(m.values())
        return total, m, (sr_chars.detach(), gt_rgb.detach(),
                          prior128.detach())

    def _d(self, name, fake, real, mask):
        f = self._judge(name, fake, train=True)
        r = self._judge(name, real, train=True)
        loss = masked_mean(F.relu(1.0 - r), mask) + \
            masked_mean(F.relu(1.0 + f), mask)
        grads = torch.autograd.grad(loss, self.params[name],
                                    allow_unused=True)
        self._step(name, grads)
        return loss.detach()

    def _step(self, name, grads):
        for p, g in zip(self.params[name], grads):
            p.grad = g
        self.opt[name].step()
        for p in self.params[name]:
            p.grad = None

    def step(self, batch) -> Dict[str, float]:
        """One G / D / SRD step on a batch of device tensors; returns its
        three losses."""
        total, _, (sr_chars, gt_rgb, prior128) = self.g_loss(batch)
        flat = [p for n in G_NETS for p in self.params[n]]
        grads = iter(torch.autograd.grad(total, flat, allow_unused=True))
        for n in G_NETS:
            self._step(n, [next(grads) for _ in self.params[n]])
        cmask3 = batch["char_valid"][:, :, None]
        l_d = self._d("net_d", sr_chars, gt_rgb, cmask3)
        l_srd = self._d("net_srd", torch.cat([sr_chars, prior128], -1),
                        torch.cat([gt_rgb, batch["gt_chars"]], -1), cmask3)
        return {"l_g_total": float(total.detach()), "l_d": float(l_d),
                "l_srd": float(l_srd)}

    def first_moments(self, name: str) -> List[torch.Tensor]:
        """Adam's first moment of each parameter of ``name`` (the gradient
        itself after one step, since beta1 is 0); None where the parameter
        got no gradient."""
        st = self.opt[name].state
        return [st[p]["exp_avg"] if p in st else None
                for p in self.params[name]]
