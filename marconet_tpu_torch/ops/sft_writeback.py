"""SFT write-back with last-writer-wins overlap: kernel K2 and its twin.

Counterpart of ``marconet_tpu/ops/pallas_sft.py``. The TPU kernel it
replaces is ``_writeback_kernel`` (``marconet_tpu/ops/pallas_sft.py:70``,
launched by ``sft_writeback``).

``out = canvas``; then each valid slot ``s``, in slot order, writes
``canvas + res[s]`` over columns ``[x1_s, x1_s + L_s)``. A covered column
therefore holds the residual of the highest valid slot that covers it, and
an uncovered column keeps the canvas (reference ``networks.py:448,481``).
Window column ``j`` of slot ``s`` is canvas column ``x1_s + j``, which is
the padded-gather layout of ``models/srnet.sft_fusion``.

On CUDA tensors :func:`sft_writeback` launches ``csrc/sft_writeback.cu``;
on CPU tensors it runs :func:`sft_writeback_plain`. The kernel is bound by
device-memory bytes; its source says what the design does about that.
"""

from __future__ import annotations

import torch

from marconet_tpu_torch import native


def _check(canvas, res, x1, lengths, valid):
    if canvas.dim() != 4 or res.dim() != 5:
        raise ValueError("sft_writeback: canvas must be (B, H, W, C) and "
                         "res (B, S, H, win, C)")
    b, h, _, c = canvas.shape
    if res.shape[0] != b or res.shape[2] != h or res.shape[4] != c:
        raise ValueError(f"sft_writeback: res {tuple(res.shape)} does not "
                         f"match canvas {tuple(canvas.shape)}")
    if res.dtype != canvas.dtype:
        raise ValueError("sft_writeback: canvas and res dtypes differ")
    s = res.shape[1]
    for name, t in (("x1", x1), ("lengths", lengths), ("valid", valid)):
        if t.shape != (b, s) or t.dtype != torch.int32:
            raise ValueError(f"sft_writeback: {name} must be ({b}, {s}) "
                             f"int32, got {tuple(t.shape)} {t.dtype}")
        if t.device != canvas.device:
            raise ValueError(f"sft_writeback: {name} is on another device")
    if res.device != canvas.device:
        raise ValueError("sft_writeback: res is on another device")
    if not (canvas.is_contiguous() and res.is_contiguous()):
        raise ValueError("sft_writeback: canvas and res must be contiguous "
                         "(NHWC canvas, (B, S, H, win, C) windows)")


def sft_writeback_plain(canvas, res, x1, lengths, valid):
    """Plain PyTorch version: per-column winner slot, then one gather.

    Same argument contract as :func:`sft_writeback`. The sum is taken in
    f32 and rounded once, like the kernel.
    """
    b, _, width, _ = canvas.shape
    s, win = res.shape[1], res.shape[3]
    xcols = torch.arange(width, device=canvas.device)
    lengths = lengths.clamp(0, win)
    covers = ((xcols >= x1[:, :, None]) &
              (xcols < (x1 + lengths)[:, :, None]) &
              (valid[:, :, None] > 0))                           # (B, S, W)
    rank = torch.where(covers, torch.arange(s, device=canvas.device)
                       [None, :, None], -1)
    winner = rank.max(dim=1).values                              # (B, W)
    slot = winner.clamp(min=0)
    col = (xcols - torch.gather(x1, 1, slot)).clamp(0, win - 1)  # (B, W)
    bidx = torch.arange(b, device=canvas.device)[:, None]
    picked = res[bidx, slot, :, col].permute(0, 2, 1, 3)         # (B,H,W,C)
    summed = (canvas.float() + picked.float()).to(canvas.dtype)
    return torch.where((winner >= 0)[:, None, :, None], summed, canvas)


def sft_writeback(canvas, res, x1, lengths, valid):
    """Canvas plus per-slot residual windows, last valid writer wins.

    Args:
      canvas: (B, H, W, C) contiguous (NHWC), f32 or bf16.
      res: (B, S, H, win, C) contiguous residual windows, canvas's dtype.
      x1, lengths, valid: (B, S) int32 window starts, valid widths
        (clamped to [0, win]) and slot validity (> 0 = valid).
    Returns:
      a new (B, H, W, C) tensor. CUDA tensors launch kernel K2 (counted in
      ``sft_writeback.launches``); CPU tensors take the plain version.
    """
    _check(canvas, res, x1, lengths, valid)
    if canvas.device.type == "cpu":
        return sft_writeback_plain(canvas, res, x1, lengths, valid)
    if canvas.device.type != "cuda":
        raise ValueError(f"sft_writeback: unsupported device "
                         f"{canvas.device}")
    code = native.DTYPE_CODES.get(canvas.dtype)
    if code is None:
        raise ValueError(f"sft_writeback: unsupported dtype {canvas.dtype}")
    for t in (x1, lengths, valid):
        if not t.is_contiguous():
            raise ValueError("sft_writeback: slot tables must be contiguous")
    native.require_hopper(canvas.device)
    lib = native.library()
    b, h, w, c = canvas.shape
    s, win = res.shape[1], res.shape[3]
    out = torch.empty_like(canvas)
    stream = torch.cuda.current_stream(canvas.device).cuda_stream
    native.check(lib.marconet_sft_writeback(
        canvas.data_ptr(), res.data_ptr(), x1.data_ptr(),
        lengths.data_ptr(), valid.data_ptr(), out.data_ptr(),
        b, h, w, c, s, win, code, stream), "sft_writeback")
    sft_writeback.launches += 1
    return out


sft_writeback.launches = 0
