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

:func:`sft_writeback` is a ``torch.autograd.Function``: ``d canvas = g``
and ``d res`` routes ``g`` at each column to the winning slot's window
column (0 elsewhere). On CUDA tensors the forward launches K2 and the
backward ``marconet_sft_writeback_bwd`` (both ``csrc/sft_writeback.cu``);
on CPU tensors they run :func:`sft_writeback_plain` and
:func:`sft_writeback_bwd_plain`. The JAX package has no kernel for the
backward (its training path differentiates the XLA write-back,
``marconet_tpu/models/srnet.py:389-438``). Both kernels are bound by
device-memory bytes; the source says what the design does about that.
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


def sft_writeback_bwd_plain(grad, x1, lengths, valid, win: int):
    """Plain ``d res``: the autograd of :func:`sft_writeback_plain`.

    ``grad`` (B, H, W, C) is the gradient of the write-back's output;
    returns (B, S, H, win, C) in ``grad``'s dtype, ``grad`` at each slot's
    winning columns and 0 elsewhere (exact: every element receives at most
    one value).
    """
    b, h, _, c = grad.shape
    with torch.enable_grad():
        res = torch.zeros(b, x1.shape[1], h, win, c, dtype=grad.dtype,
                          device=grad.device, requires_grad=True)
        out = sft_writeback_plain(torch.zeros_like(grad), res, x1, lengths,
                                  valid)
        (d_res,) = torch.autograd.grad(out, res, grad)
    return d_res


def _cuda_code(t: torch.Tensor, tables, what: str) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    code = native.DTYPE_CODES.get(t.dtype)
    if code is None:
        raise ValueError(f"{what}: unsupported dtype {t.dtype}")
    for tab in tables:
        if not tab.is_contiguous():
            raise ValueError(f"{what}: slot tables must be contiguous")
    native.require_hopper(t.device)
    return code


def _k2(canvas, res, x1, lengths, valid):
    code = _cuda_code(canvas, (x1, lengths, valid), "sft_writeback")
    b, h, w, c = canvas.shape
    s, win = res.shape[1], res.shape[3]
    out = torch.empty_like(canvas)
    stream = torch.cuda.current_stream(canvas.device).cuda_stream
    native.check(native.library().marconet_sft_writeback(
        canvas.data_ptr(), res.data_ptr(), x1.data_ptr(),
        lengths.data_ptr(), valid.data_ptr(), out.data_ptr(),
        b, h, w, c, s, win, code, stream), "sft_writeback")
    sft_writeback.launches += 1
    return out


def sft_writeback_bwd(grad, x1, lengths, valid, win: int):
    """``d res`` of :func:`sft_writeback` for the output cotangent ``grad``
    (B, H, W, C), contiguous: (B, S, H, win, C) in ``grad``'s dtype.

    CPU tensors take :func:`sft_writeback_bwd_plain`; CUDA tensors launch
    ``marconet_sft_writeback_bwd`` (counted in
    ``sft_writeback_bwd.launches``): a block decides the winners of a
    chunk of window columns once, into shared memory, then its threads
    copy 16-byte packs of g (or store zero packs) over a 2-D layout of
    channel packs x rows, with no per-element division. Its earlier
    design, a 64-bit ``e / C`` and 2-byte stores per element, ran bf16 at
    its f32 time, 35% of its bound.
    """
    if grad.dim() != 4 or not grad.is_contiguous():
        raise ValueError("sft_writeback_bwd: grad must be a contiguous "
                         "(B, H, W, C) tensor")
    b, s = x1.shape
    for name, t in (("x1", x1), ("lengths", lengths), ("valid", valid)):
        if t.shape != (grad.shape[0], s) or t.dtype != torch.int32:
            raise ValueError(f"sft_writeback_bwd: {name} must be "
                             f"({grad.shape[0]}, {s}) int32")
        if t.device != grad.device:
            raise ValueError(f"sft_writeback_bwd: {name} is on another "
                             "device")
    if grad.device.type == "cpu":
        return sft_writeback_bwd_plain(grad, x1, lengths, valid, win)
    code = _cuda_code(grad, (x1, lengths, valid), "sft_writeback_bwd")
    b, h, w, c = grad.shape
    s = x1.shape[1]
    d_res = torch.empty(b, s, h, win, c, dtype=grad.dtype,
                        device=grad.device)
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    native.check(native.library().marconet_sft_writeback_bwd(
        grad.data_ptr(), x1.data_ptr(), lengths.data_ptr(),
        valid.data_ptr(), d_res.data_ptr(), b, h, w, c, s, win, code,
        stream), "sft_writeback_bwd")
    sft_writeback_bwd.launches += 1
    return d_res


sft_writeback_bwd.launches = 0


class _SftWriteback(torch.autograd.Function):
    @staticmethod
    def forward(ctx, canvas, res, x1, lengths, valid):
        ctx.save_for_backward(x1, lengths, valid)
        ctx.win = res.shape[3]
        if canvas.device.type == "cpu":
            return sft_writeback_plain(canvas, res, x1, lengths, valid)
        return _k2(canvas, res, x1, lengths, valid)

    @staticmethod
    def backward(ctx, grad):
        x1, lengths, valid = ctx.saved_tensors
        grad = grad.contiguous()
        d_res = None
        if ctx.needs_input_grad[1]:
            d_res = sft_writeback_bwd(grad, x1, lengths, valid, ctx.win)
        # out = canvas (+ a residual) everywhere: d canvas = g
        return grad, d_res, None, None, None


def sft_writeback(canvas, res, x1, lengths, valid):
    """Canvas plus per-slot residual windows, last valid writer wins.

    Args:
      canvas: (B, H, W, C) contiguous (NHWC), f32 or bf16.
      res: (B, S, H, win, C) contiguous residual windows, canvas's dtype.
      x1, lengths, valid: (B, S) int32 window starts, valid widths
        (clamped to [0, win]) and slot validity (> 0 = valid).
    Returns:
      a new (B, H, W, C) tensor, differentiable in ``canvas`` and ``res``
      (the backward is :func:`sft_writeback_bwd`). CUDA tensors launch
      kernel K2 (counted in ``sft_writeback.launches``); CPU tensors take
      the plain version.
    """
    _check(canvas, res, x1, lengths, valid)
    return _SftWriteback.apply(canvas, res, x1, lengths, valid)


sft_writeback.launches = 0
