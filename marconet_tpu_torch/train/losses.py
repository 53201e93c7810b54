"""Training losses (counterpart of ``marconet_tpu/train/losses.py``).

The reference's loss suite (``Train/tspgan/losses/text_loss.py`` and the
basicsr losses wired in ``tspgan_model.py:106-113``): CTC, weighted text
CE, L1, SmoothL1 (Huber, beta 1), hinge GAN, soft IoU on glyph images and
the 1-D box IoU location loss, as masked batched tensor ops. Every loss is
computed in f32 and returns a 0-d f32 tensor. Masks broadcast against the
values they weight.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from marconet_tpu_torch.alphabet import BLANK_INDEX, NUM_CLASSES


def masked_mean(x, mask, eps: float = 1e-8):
    """Mean of ``x`` over the elements where ``mask > 0``."""
    m = torch.broadcast_to(mask.float(), x.shape)
    return (x.float() * m).sum() / m.sum().clamp(min=eps)


def l1_loss(pred, target, mask=None, weight: float = 1.0):
    d = (pred.float() - target.float()).abs()
    return weight * (d.mean() if mask is None else masked_mean(d, mask))


def smooth_l1_loss(pred, target, mask=None, beta: float = 1.0):
    """torch ``SmoothL1Loss`` (Huber with beta=1)."""
    d = (pred.float() - target.float()).abs()
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return loss.mean() if mask is None else masked_mean(loss, mask)


# ---------------------------------------------------------------------------
# recognition losses
# ---------------------------------------------------------------------------


def ctc_loss(logits, labels, blank: int = BLANK_INDEX):
    """CTC with torch ``reduction='mean'`` semantics.

    Args:
      logits: (B, T, C) raw class logits.
      labels: (B, S) labels padded at the end with ``blank``.
    Returns the batch mean of (per-sequence nll / max(target length, 1)).
    """
    b, t, _ = logits.shape
    lengths = (labels != blank).sum(dim=1)
    logp = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T,B,C)
    per_seq = F.ctc_loss(
        logp, labels.long(),
        torch.full((b,), t, dtype=torch.long, device=logits.device),
        lengths.long(), blank=blank, reduction="none")
    return (per_seq / lengths.clamp(min=1).float()).mean()


def text_ce_loss(logits, labels, num_classes: int = NUM_CLASSES,
                 empty_weight: float = 0.1):
    """Class-weighted CE with the blank (last) class weighted 0.1
    (reference ``TextCELoss``, ``text_loss.py:33-52``).

    logits: (B, T, C); labels: (B, T) int.
    """
    w = torch.ones(num_classes, device=logits.device)
    w[-1] = empty_weight
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    wts = w[labels.long()]
    return (nll * wts).sum() / wts.sum().clamp(min=1e-8)


# ---------------------------------------------------------------------------
# localization losses
# ---------------------------------------------------------------------------


def lr_to_center_width(locs_lr):
    """(B, 2N) (left, right) pairs -> (B, 2N) (center, half-width) pairs
    (reference ``tspgan_model.py:333-337``)."""
    left, right = locs_lr[:, 0::2], locs_lr[:, 1::2]
    out = torch.stack([(left + right) / 2.0, (right - left) / 2.0], dim=-1)
    return out.reshape(locs_lr.shape)


def box_iou_loss(pred_cw, gt_cw, valid, scale: float = 2048.0):
    """Mean (1 - IoU) over valid 1-D boxes (reference
    ``tspgan_model.py:382-413``).

    pred_cw, gt_cw: (B, 2N) (center, half-width) pairs in [0, 1];
    valid: (B, N).
    """
    pc, pw = pred_cw[:, 0::2] * scale, pred_cw[:, 1::2] * scale
    gc, gw = gt_cw[:, 0::2] * scale, gt_cw[:, 1::2] * scale
    x1, x2 = pc - pw, pc + pw
    g1, g2 = gc - gw, gc + gw
    inter = (torch.minimum(x2, g2) - torch.maximum(x1, g1)).clamp(min=0.0)
    union = (x2 - x1) + (g2 - g1) - inter
    iou = inter / union.clamp(min=1e-6)
    return masked_mean(1.0 - iou, valid)


# ---------------------------------------------------------------------------
# GAN and structure losses
# ---------------------------------------------------------------------------


def hinge_g_loss(fake_pred, mask=None):
    """Generator hinge loss: -E[D(fake)] (basicsr ``GANLoss(hinge)``)."""
    if mask is None:
        return -fake_pred.float().mean()
    return -masked_mean(fake_pred, mask)


def hinge_d_loss(real_pred, fake_pred, real_mask=None, fake_mask=None):
    """Discriminator hinge loss: E[relu(1-D(real))] + E[relu(1+D(fake))]."""
    lr = F.relu(1.0 - real_pred.float())
    lf = F.relu(1.0 + fake_pred.float())
    lr = lr.mean() if real_mask is None else masked_mean(lr, real_mask)
    lf = lf.mean() if fake_mask is None else masked_mean(lf, fake_mask)
    return lr + lf


def soft_iou_loss(pred, target, mask=None):
    """Soft IoU on [-1, 1] glyph images (reference
    ``tspgan_model.py:461-463``)."""
    p = (pred.float() + 1.0) / 2.0
    t = (target.float() + 1.0) / 2.0
    inter = p * t
    union = p + t - inter
    loss = 1.0 - inter / union.clamp(min=1e-6)
    return loss.mean() if mask is None else masked_mean(loss, mask)
