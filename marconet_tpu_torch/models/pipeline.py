"""End-to-end restoration pipeline: encoder -> prior generator -> SR net.

Counterpart of ``marconet_tpu/models/pipeline.py``: steps 2-4 of the
reference's ``test_sr.py`` over a padded slot layout, so any number of
characters per line (<= 16) runs as one batch. The pipeline takes labels
and locs; the detection / recognition front-end is a separate component.

Public tensors are NHWC like the JAX package's: ``restore`` takes
``lq`` (B, 32, 512, 3) and returns ``sr`` (B, 128, 2048, 3) and
``priors`` (B, N, 128, 128, 3). Inside, tensors are NCHW channels_last.

Under ``torch.profiler`` a restore is the span ``pipeline/restore`` around
``pipeline/encoder``, ``pipeline/prior`` and ``pipeline/srnet``; on a CUDA
device each also times its stretch of the stream
(``utils/tracing.settle``).

On a CUDA net a restore of at most ``GRAPH_MAX_ROWS`` rows runs from CUDA
graphs, one per stage, captured on the first call of its (rows, slots) and
replayed inside the same spans: at such batches the host's ~1,540 kernel
launches, not the card, set a call's time.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from marconet_tpu_torch.alphabet import BLANK_INDEX
from marconet_tpu_torch.models.encoder import MAX_CHARS, TextContextEncoder
from marconet_tpu_torch.models.prior import (
    PriorOutput,
    StructurePriorGenerator,
)
from marconet_tpu_torch.models.srnet import StructurePriorSRNet
from marconet_tpu_torch.ops.conv3x3 import conv3x3_same
from marconet_tpu_torch.ops.fused_act import (
    fused_leaky_relu,
    fused_leaky_relu_bwd,
)
from marconet_tpu_torch.ops.layers import Precision, set_compute_dtype
from marconet_tpu_torch.ops.sft_writeback import (
    sft_writeback,
    sft_writeback_bwd,
)
from marconet_tpu_torch.utils.tracing import span

# Restores of at most this many rows run from CUDA graphs on a CUDA net.
# Measured on an NVIDIA H100 80GB HBM3 (700 W), bf16, 16 slots, ms a call
# eager -> graphed: 1 row 42.6 -> 18.1, 2 rows 49.2 -> 30.4, 4 rows 74.5 ->
# 56.0, 8 rows 124.2 -> 106.0. Graphs save a near-constant ~18 ms a call
# (the gaps the eager launches leave), 59% of a call at 1 row, 25% at 4,
# 15% at 8. The cap bounds what the graphs keep reserved (the process held
# 6.6 GB after captures of 1-4 rows, 17 GB with 5-8 rows too) and the
# captures a net makes (3 slot buckets x GRAPH_MAX_ROWS).
GRAPH_MAX_ROWS = 4

# the kernel wrappers whose launch counts a restore moves
_WRAPPERS = (fused_leaky_relu, fused_leaky_relu_bwd, sft_writeback,
             sft_writeback_bwd, conv3x3_same)


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


def graphed(device: torch.device, rows: int) -> bool:
    """Whether a restore of ``rows`` rows on ``device`` runs from CUDA
    graphs: on CUDA, up to ``GRAPH_MAX_ROWS`` rows."""
    return device.type == "cuda" and rows <= GRAPH_MAX_ROWS


def _launch_counts() -> Dict[tuple, int]:
    """Every launch count of the kernel wrappers, by (wrapper, attribute,
    key or None): ``fused_leaky_relu.launches``,
    ``conv3x3_same.launches_by_path[path]`` and the like."""
    out = {}
    for fn in _WRAPPERS:
        for name, v in vars(fn).items():
            if isinstance(v, dict):
                out.update(((fn, name, k), x) for k, x in v.items())
            elif isinstance(v, int):
                out[(fn, name, None)] = v
    return out


def _add_launches(counts: Dict[tuple, int], sign: int = 1) -> None:
    """Add ``counts`` (as :func:`_launch_counts` keys them) to the
    wrappers' launch counts, times ``sign``."""
    for (fn, name, key), n in counts.items():
        if key is None:
            setattr(fn, name, getattr(fn, name) + sign * n)
        else:
            getattr(fn, name)[key] += sign * n


class _Graphs(NamedTuple):
    """A restore of one (rows, slots), captured: its static inputs (``lq``
    in the compute dtype, labels, locs, char_mask), its stages (span name,
    graph, the kernel launches a replay makes) and its static outputs (as
    :meth:`MARCONet._run` returns them)."""
    inputs: Tuple[torch.Tensor, ...]
    stages: list
    outputs: Tuple[torch.Tensor, ...]


class RestoreOutput(NamedTuple):
    sr: torch.Tensor          # (B, 128, 2048, 3) in [-1, 1]
    priors: torch.Tensor      # (B, N, 128, 128, 3) per-slot glyph priors
    logits: torch.Tensor      # (B, 64, num_classes) encoder class logits
    pred_locs: torch.Tensor   # (B, 32) encoder-predicted locs
    w: torch.Tensor           # (B, w_dim) font-style vectors


class MARCONet(Precision, nn.Module):
    """The three core networks and the restore pipeline over them.

    Typical use::

        net = MARCONet(dtype=torch.bfloat16, device="cuda", seed=0)
        out = net.restore(lq, labels, locs, char_mask)

    ``dtype`` is the compute precision, as in the JAX package: the
    parameters stay float32, so a bf16 net over an f32 checkpoint computes
    as the JAX tools and every CLI of the port do.

    Counts kept on every :meth:`restore`, from shapes alone: ``restores``,
    ``rows`` (the batch's lines, as given) and ``slots`` (rows times the
    character slots); ``graph_captures`` (restores that captured their
    shape's graphs) and ``graph_replays`` (restores served by replaying
    them).

    On a CUDA device a restore of at most ``GRAPH_MAX_ROWS`` rows runs from
    CUDA graphs (:func:`graphed`), kept per (rows, slots) in one memory
    pool. The first call of a shape runs eagerly on a side stream, returns
    that result, then captures three graphs: the encoder; the slot labels
    and the prior generator; the SR net. Later calls copy their inputs into
    the graphs' static buffers, replay them and return clones of their
    outputs. The same kernels run in the same dtype; parameters are read
    from their storage at each replay, so an in-place ``load_state_dict``
    acts on the next call. Moving the net (``.to()``, ``.cuda()``), a new
    compute dtype and ``train()`` / ``eval()`` drop the graphs.

    Args:
      width: channel multiplier (1.0 = the exact reference architecture;
        reduced widths share the code path).
      num_classes: codebook / classifier size (6736 with blank).
      dtype: compute dtype, float32 or bfloat16.
      device: where parameters are created and the pipeline runs; CUDA
        unless named (see :func:`resolve_device`).
      seed: seed of the ``torch.Generator`` that draws the random init.
    """

    def __init__(self, width: float = 1.0, num_classes: int = 6736, *,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0):
        super().__init__()
        self._graphs: Dict[Tuple[int, int], _Graphs] = {}
        self._pool = None
        device = resolve_device(device)
        g = torch.Generator(device=device).manual_seed(seed)
        kw = dict(device=device, generator=g)
        self.encoder = TextContextEncoder(num_classes, width, **kw)
        self.prior = StructurePriorGenerator(
            num_classes, style_dim=self.encoder.w_dim, width=width, **kw)
        ch = self.prior.channels
        self.srnet = StructurePriorSRNet(ch[64], ch[32], **kw)
        set_compute_dtype(self, dtype)
        self.eval()
        self.device = device
        self.restores = self.rows = self.slots = 0
        self.graph_captures = self.graph_replays = 0

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @dtype.setter
    def dtype(self, dtype: torch.dtype) -> None:
        self._drop_graphs()
        self._dtype = dtype

    def train(self, mode: bool = True):
        self._drop_graphs()
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self._drop_graphs()
        return super()._apply(fn, *args, **kwargs)

    def _drop_graphs(self) -> None:
        self._graphs.clear()
        self._pool = None

    def _nchw_input(self, lq: torch.Tensor) -> torch.Tensor:
        """lq (B, 32, 512, 3) NHWC -> the nets' input: NCHW channels_last
        in the compute dtype, on its device."""
        if lq.dim() != 4 or tuple(lq.shape[1:]) != (32, 512, 3):
            raise ValueError(f"lq must be (B, 32, 512, 3), got "
                             f"{tuple(lq.shape)}")
        return lq.to(device=self.device, dtype=self.dtype).permute(
            0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    @torch.inference_mode()
    def encode(self, lq: torch.Tensor):
        """lq (B, 32, 512, 3) NHWC in [-1, 1] -> (logits (B, 64,
        num_classes), pred_locs (B, 32), w (B, w_dim)): the text-context
        encoder alone."""
        return self.encoder(self._nchw_input(lq))

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
        self.restores += 1
        self.rows += b
        self.slots += b * n
        inputs = (lq, labels, locs, char_mask)
        cuda = self.device.type == "cuda"
        with span("pipeline/restore", cuda):
            if not graphed(self.device, b):
                out = self._run(*self._device_inputs(*inputs),
                                lambda name: span(name, cuda))
            elif (b, n) in self._graphs:
                out = self._replay(self._graphs[(b, n)], inputs)
            else:
                out = self._capture(inputs)
            sr, image, logits, pred_locs, w = out
            priors = image.permute(0, 2, 3, 1).reshape(
                b, n, *image.shape[2:], 3)
        return RestoreOutput(sr.permute(0, 2, 3, 1), priors, logits,
                             pred_locs, w)

    def _device_inputs(self, lq, labels, locs, char_mask):
        """The restore's inputs as the nets take them, on the device."""
        dev = self.device
        return (self._nchw_input(lq),
                labels.to(device=dev, dtype=torch.long),
                locs.to(device=dev, dtype=torch.float32),
                char_mask.to(device=dev, dtype=torch.float32))

    def _run(self, x, labels, locs, char_mask, stage):
        """The restore's three stages over device inputs, each inside
        ``stage(span name)``: (sr NCHW, prior images of the B*N slots NCHW,
        logits, pred_locs, w)."""
        with stage("pipeline/encoder"):
            logits, pred_locs, w = self.encoder(x)
        with stage("pipeline/prior"):
            safe_labels = torch.where(char_mask > 0, labels, BLANK_INDEX)
            pri = self.generate_priors(w, safe_labels)
        with stage("pipeline/srnet"):
            sr = self.super_resolve(x, pri.feat64, pri.feat32, locs,
                                    char_mask)
        return sr, pri.image, logits, pred_locs, w

    def _capture(self, inputs) -> tuple:
        """The first restore of a graphed shape: run it eagerly on a side
        stream (the warm-up the capture needs), then capture its stages
        into graphs over static buffers. Returns the eager result."""
        b, n = inputs[1].shape
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._run(*self._device_inputs(*inputs),
                            lambda name: span(name, True))
        main.wait_stream(side)
        for t in out:       # the caller uses them on its own stream
            t.record_stream(main)

        dev = self.device
        static = (torch.empty(b, 32, 512, 3, dtype=self.dtype, device=dev),
                  torch.empty(b, n, dtype=torch.long, device=dev),
                  torch.empty(b, 2 * n, dtype=torch.float32, device=dev),
                  torch.empty(b, n, dtype=torch.float32, device=dev))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        stages = []
        # the static lq is NHWC: its NCHW view is channels_last already
        outputs = self._run(static[0].permute(0, 3, 1, 2), *static[1:],
                            lambda name: self._capturing(stages, name))
        self._graphs[(b, n)] = _Graphs(static, stages, outputs)
        self.graph_captures += 1
        return out

    @contextlib.contextmanager
    def _capturing(self, stages: list, name: str):
        """Capture the work inside into a new graph of the net's pool and
        append (``name``, graph, its kernel launches) to ``stages``."""
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                yield
        finally:
            # a capture runs nothing: its launches are the graph's
            now = _launch_counts()
            launches = {k: v - before.get(k, 0) for k, v in now.items()
                        if v != before.get(k, 0)}
            _add_launches(launches, -1)
        stages.append((name, graph, launches))

    def _replay(self, graphs: _Graphs, inputs) -> tuple:
        """A restore from its shape's graphs: inputs copied into the static
        buffers, each stage replayed inside its span, outputs cloned."""
        for buf, t in zip(graphs.inputs, inputs):
            buf.copy_(t)
        for name, graph, launches in graphs.stages:
            with span(name, True):
                graph.replay()
            _add_launches(launches)
        self.graph_replays += 1
        return tuple(t.clone() for t in graphs.outputs)

    @torch.inference_mode()
    def interpolate_styles(self, w1: torch.Tensor, w2: torch.Tensor,
                           labels: torch.Tensor, weights: torch.Tensor
                           ) -> torch.Tensor:
        """Glyph priors of ``labels`` under blends of two styles (reference
        ``test_w.py:102-115``).

        Blend ``s`` is ``w1 * s + w2 * (1 - s)`` in f32, which the style
        MLP's PixelNorm takes in f32, as the JAX package's f32 blend
        weights promote it. The S blends of
        the N labels run as one prior batch of S * N slots (blend-major),
        where the JAX package vmaps over the blends.

        Args:
          w1, w2: (w_dim,) style vectors.
          labels: (N,) int char labels.
          weights: (S,) blend weights in [0, 1].
        Returns:
          (S, N, 128, 128, 3) glyph prior images, NHWC.
        """
        dev = self.device
        w1, w2 = (t.to(device=dev, dtype=torch.float32) for t in (w1, w2))
        s = weights.to(device=dev, dtype=torch.float32)[:, None]
        styles = w1[None] * s + w2[None] * (1.0 - s)
        n = labels.shape[0]
        labels = labels.to(device=dev, dtype=torch.long)
        img = self.prior(styles.repeat_interleave(n, dim=0),
                         labels.repeat(s.shape[0])).image
        return img.permute(0, 2, 3, 1).reshape(s.shape[0], n,
                                               *img.shape[2:], 3)
