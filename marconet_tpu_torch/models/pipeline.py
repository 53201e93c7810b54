"""End-to-end restoration pipeline: encoder -> prior generator -> SR net.

Counterpart of ``marconet_tpu/models/pipeline.py``: steps 2-4 of the
reference's ``test_sr.py`` over a padded slot layout, so any number of
characters per line (<= 16) runs as one batch. The pipeline takes labels
and locs; the detection / recognition front-end is a separate component.

Public tensors are NHWC like the JAX package's: ``restore`` takes
``lq`` (B, 32, 512, 3) and returns ``sr`` (B, 128, 2048, 3) and
``priors`` (B, N, 128, 128, 3). Inside, tensors are NCHW channels_last.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from marconet_tpu_torch.alphabet import BLANK_INDEX
from marconet_tpu_torch.models.encoder import MAX_CHARS, TextContextEncoder
from marconet_tpu_torch.models.prior import (
    PriorOutput,
    StructurePriorGenerator,
)
from marconet_tpu_torch.models.srnet import StructurePriorSRNet


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the one named, CUDA by default.

    Raises when CUDA is asked for (or defaulted to) and there is none: the
    port never falls back to the CPU on its own; a CPU run names
    ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU by "
                           "default; pass device='cpu' to run on the CPU")
    return dev


class RestoreOutput(NamedTuple):
    sr: torch.Tensor          # (B, 128, 2048, 3) in [-1, 1]
    priors: torch.Tensor      # (B, N, 128, 128, 3) per-slot glyph priors
    logits: torch.Tensor      # (B, 64, num_classes) encoder class logits
    pred_locs: torch.Tensor   # (B, 32) encoder-predicted locs
    w: torch.Tensor           # (B, w_dim) font-style vectors


class MARCONet(nn.Module):
    """The three core networks and the restore pipeline over them.

    Typical use::

        net = MARCONet(dtype=torch.bfloat16, device="cuda", seed=0)
        out = net.restore(lq, labels, locs, char_mask)

    Args:
      width: channel multiplier (1.0 = the exact reference architecture;
        reduced widths share the code path).
      num_classes: codebook / classifier size (6736 with blank).
      dtype: parameter and compute dtype, float32 or bfloat16.
      device: where parameters are created and the pipeline runs; CUDA
        unless named (see :func:`resolve_device`).
      seed: seed of the ``torch.Generator`` that draws the random init.
    """

    def __init__(self, width: float = 1.0, num_classes: int = 6736, *,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported dtype {dtype}")
        device = resolve_device(device)
        g = torch.Generator(device=device).manual_seed(seed)
        kw = dict(device=device, generator=g)
        self.encoder = TextContextEncoder(num_classes, width, **kw)
        self.prior = StructurePriorGenerator(
            num_classes, style_dim=self.encoder.w_dim, width=width, **kw)
        ch = self.prior.channels
        self.srnet = StructurePriorSRNet(ch[64], ch[32], **kw)
        self.to(dtype)
        self.eval()
        self.dtype, self.device = dtype, device

    def generate_priors(self, w: torch.Tensor, labels: torch.Tensor
                        ) -> PriorOutput:
        """w (B, w_dim), labels (B, N) -> priors of the B*N slots, flat
        (slot b*N + n is row n of line b), NCHW channels_last."""
        n = labels.shape[1]
        styles = w.repeat_interleave(n, dim=0)
        return self.prior(styles, labels.reshape(-1))

    def super_resolve(self, lq, prior64, prior32, locs, char_mask):
        """lq (B, 3, 32, 512) NCHW -> sr (B, 3, 128, 2048) NCHW."""
        return self.srnet(lq, prior64, prior32, locs, char_mask)

    @torch.inference_mode()
    def restore(self, lq, labels, locs, char_mask) -> RestoreOutput:
        """Restore a batch of LQ text lines.

        Args:
          lq: (B, 32, 512, 3) NHWC in [-1, 1].
          labels: (B, N) int char labels, N <= 16 (pad with blank 6735).
          locs: (B, 2N) normalized (center, half-width) pairs (pad 0).
          char_mask: (B, N) slot validity (> 0 = valid).
        """
        b, n = labels.shape
        if n > MAX_CHARS:
            raise ValueError(f"{n} slots; at most {MAX_CHARS}")
        if tuple(lq.shape) != (b, 32, 512, 3):
            raise ValueError(f"lq must be ({b}, 32, 512, 3), got "
                             f"{tuple(lq.shape)}")
        if locs.shape != (b, 2 * n) or char_mask.shape != (b, n):
            raise ValueError("locs must be (B, 2N) and char_mask (B, N)")
        dev, dt = self.device, self.dtype
        x = lq.to(device=dev, dtype=dt).permute(0, 3, 1, 2) \
            .contiguous(memory_format=torch.channels_last)
        labels = labels.to(device=dev, dtype=torch.long)
        locs = locs.to(device=dev, dtype=torch.float32)
        char_mask = char_mask.to(device=dev, dtype=torch.float32)

        logits, pred_locs, w = self.encoder(x)
        safe_labels = torch.where(char_mask > 0, labels, BLANK_INDEX)
        pri = self.generate_priors(w, safe_labels)
        sr = self.super_resolve(x, pri.feat64, pri.feat32, locs, char_mask)
        priors = pri.image.permute(0, 2, 3, 1).reshape(
            b, n, *pri.image.shape[2:], 3)
        return RestoreOutput(sr.permute(0, 2, 3, 1), priors, logits,
                             pred_locs, w)
