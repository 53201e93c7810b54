"""Service-mode batched restoration of text lines and pages.

Counterpart of ``marconet_tpu/serve.py``. The reference restores one line
per Python iteration (``test_sr.py:77``) and tells users to crop long
lines themselves (``test_sr.py:104-110``). :class:`TextPageRestorer`
cuts any collection of line crops into chunks by batch-size buckets,
restores each chunk at the rows it holds with the fewest character-slot
buckets that fit, splits over-wide lines into <= 512 px segments and
stitches them back, so a page is a handful of ``MARCONet.restore`` calls
whatever its layout. Unlike the JAX package, which pads a chunk to its
bucket for XLA's static shapes, the port runs eagerly and pads no chunk.

On the GPU the chunk loop keeps the card busy: chunk k's restore and
uint8 packing are queued, its device -> host copy goes into pinned memory
without blocking, and only then does the host wait for chunk k - 1 and
prepare chunk k + 1 (the resizes to height 32, stacking, a non-blocking
upload) while the card runs chunk k. A line's display width, where its
x4 output is cropped, is computed from its shape (``show_width``),
without a resize.

Under ``torch.profiler`` the server marks its work as spans
(``utils/tracing.py``): ``serve/page`` around a page, ``serve/lines``
around a :meth:`TextPageRestorer.restore_lines` call and, inside it,
``serve/prep`` (checks, host prep, the upload), ``serve/launch`` (a
chunk's restore, packing and copies enqueued), ``serve/wait`` (the host
blocked on the card) and ``serve/drain`` (the results built on the host).
Counts kept on every call, profiler or not: ``calls``, ``chunks``,
``rows`` (rows restored) and ``rows_real`` (requests), equal since no
chunk is padded, ``slots`` (rows times the chunk's slot bucket) and
``slots_real`` (characters restored).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from marconet_tpu_torch.alphabet import (
    BLANK_INDEX,
    labels_from_text,
    text_from_labels,
)
from marconet_tpu_torch.models.encoder import MAX_CHARS
from marconet_tpu_torch.utils.image import (
    LQ_HEIGHT,
    LQ_WIDTH,
    lq_input,
    lq_width,
    normalized_locs_from_boxes,
    show_width,
)
from marconet_tpu_torch.utils.tracing import settle, span

DEFAULT_BUCKETS = (1, 4, 16, 64)
SLOT_BUCKETS = (4, 8, MAX_CHARS)


def _pack_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float / bf16 image tensor -> uint8, on its device:
    ``clip(x * 0.5 + 0.5, 0, 1) * 255 + 0.5`` in f32, truncated (the JAX
    package's rounding to nearest)."""
    v = x.float() * 0.5 + 0.5
    return (v.clamp_(0.0, 1.0).mul_(255.0).add_(0.5)).to(torch.uint8)


@dataclass
class LineRequest:
    """One text-line crop with (optionally) known text and boxes."""

    image: np.ndarray                     # (H, W, 3) RGB uint8
    text: Optional[str] = None            # known characters (manual mode)
    boxes: Optional[Sequence[Sequence[float]]] = None  # xyxy, image coords


@dataclass
class LineResult:
    sr: np.ndarray                        # (128, W*4, 3) uint8 RGB
    text: str
    priors: np.ndarray                    # (n, 128, 128, 3) uint8


def split_wide_line(img: np.ndarray, max_w: int = LQ_WIDTH
                    ) -> List[Tuple[np.ndarray, int]]:
    """Split a line whose h=32-normalized width exceeds 512 px into
    segments; returns [(crop, x_offset_px)]."""
    h, w = img.shape[:2]
    w32 = int(w * LQ_HEIGHT / h)
    if w32 <= max_w:
        return [(img, 0)]
    n_seg = int(np.ceil(w32 / max_w))
    seg_w = int(np.ceil(w / n_seg))
    return [(img[:, i * seg_w:(i + 1) * seg_w], i * seg_w)
            for i in range(n_seg)]


@dataclass
class _Chunk:
    """One batch of prepared lines: the restore inputs (host or device
    tensors) and, per line, its display width (``show_width`` of its
    shape: the columns of its x4 output that hold the line) and character
    labels."""

    inputs: Tuple[torch.Tensor, ...]      # lq, labels, locs, char_mask
    show_widths: List[int]
    labels: List[np.ndarray]


class TextPageRestorer:
    """Bucketed batch restoration over a ``MARCONet``.

    Args:
      net: a ``marconet_tpu_torch.models.pipeline.MARCONet`` (or any
        object with its ``restore`` and ``device``).
      frontend: optional callable ``image -> detection`` whose result has
        ``text`` (str) and ``locs`` ((2N,) normalized), used for requests
        without text.
      buckets: batch sizes that cut a request list into chunks: the
        list runs in chunks of the smallest bucket that holds it (the
        largest when none does), so the largest bucket is the most rows a
        chunk holds. A chunk is not padded to its bucket: it restores at
        the rows it holds.
    """

    def __init__(self, net, frontend=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.net = net
        self.frontend = frontend
        self.buckets = tuple(sorted(buckets))
        self.calls = self.chunks = 0
        self.rows = self.rows_real = 0
        self.slots = self.slots_real = 0

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _check(self, req: LineRequest) -> None:
        """Raise for a request that cannot be restored, with the JAX
        package's messages: run for every request before the first chunk
        runs (the JAX server raises only when it reaches the request)."""
        h, w = req.image.shape[:2]
        if lq_width(h, w) > LQ_WIDTH:
            raise ValueError("line wider than 512 after h=32 resize; "
                             "use restore_page for auto-splitting")
        if req.text is None and self.frontend is None:
            raise ValueError("request has no text and no front-end is "
                             "configured")

    def _prepare(self, req: LineRequest):
        """Model inputs of one request that passed :meth:`_check`."""
        lq = lq_input(req.image)
        if req.text is not None:
            labels_list = [l for l in labels_from_text(req.text)
                           if l >= 0][:MAX_CHARS]
            locs_vec = None
            if req.boxes is not None:
                locs_vec = normalized_locs_from_boxes(
                    req.boxes, req.image.shape[0])
        else:
            det = self.frontend(req.image)
            labels_list = [l for l in labels_from_text(det.text)
                           if l >= 0][:MAX_CHARS]
            locs_vec = det.locs
        n = len(labels_list)
        labels = np.full(MAX_CHARS, BLANK_INDEX, np.int64)
        labels[:n] = labels_list
        locs = np.zeros(2 * MAX_CHARS, np.float32)
        if locs_vec is not None:
            locs[:min(len(locs_vec), 2 * MAX_CHARS)] = \
                locs_vec[:2 * MAX_CHARS]
        mask = np.zeros(MAX_CHARS, np.float32)
        mask[:n] = 1.0
        return (lq[0], labels, locs, mask,
                show_width(*req.image.shape[:2]), n)

    def _chunk(self, reqs: Sequence[LineRequest]) -> _Chunk:
        """Prepare ``reqs`` as one batch of ``len(reqs)`` rows, with the
        fewest character slots (4, 8 or 16) that hold its longest line.
        Masked slots are inert, so short lines skip their compute. The
        inputs are host tensors; on a CUDA net they are pinned and
        uploaded without blocking."""
        prepared = [self._prepare(r) for r in reqs]
        max_chars = max(p[5] for p in prepared)
        n_slots = next(s for s in SLOT_BUCKETS if s >= max_chars)
        lq = np.stack([p[0] for p in prepared])
        labels = np.stack([p[1][:n_slots] for p in prepared])
        locs = np.stack([p[2][:2 * n_slots] for p in prepared])
        mask = np.stack([p[3][:n_slots] for p in prepared])
        inputs = tuple(torch.from_numpy(a) for a in (lq, labels, locs, mask))
        dev = self.net.device
        if dev.type == "cuda":
            inputs = tuple(t.pin_memory().to(dev, non_blocking=True)
                           for t in inputs)
        return _Chunk(inputs, [p[4] for p in prepared],
                      [p[1][:p[5]] for p in prepared])

    def restore_lines(self, requests: Sequence[LineRequest]
                      ) -> List[LineResult]:
        """Restore a list of lines, in order, in chunks of one bucket size
        (the last chunk holds what is left, unpadded).

        Every request is checked before the first chunk runs. The
        character-slot count is bucketed too (4 / 8 / 16): masked extra
        slots are inert (equal to a narrower run up to float reassociation,
        ``tests/test_models.py``).

        On a CUDA net the loop is double-buffered: chunk k's restore and
        uint8 packing are queued on the card and copied into pinned host
        memory without blocking; then the host waits for chunk k - 1,
        builds its results and prepares chunk k + 1 while the card runs
        chunk k.
        """
        self.calls += 1
        n = len(requests)
        if n == 0:
            return []
        cuda = self.net.device.type == "cuda"
        results: List[LineResult] = []

        def drain(done, sr, priors, chunk, reqs):
            with span("serve/wait"):
                if done is not None:
                    done.synchronize()
            with span("serve/drain"):
                sr, priors = sr.numpy(), priors.numpy()
                for i, req in enumerate(reqs):
                    labels = chunk.labels[i]
                    results.append(LineResult(
                        sr=sr[i, :, :chunk.show_widths[i]].copy(),
                        text=req.text if req.text is not None else
                        text_from_labels(labels),
                        priors=priors[i, :len(labels)].copy()))

        with span("serve/lines"):
            with span("serve/prep"):
                for req in requests:
                    self._check(req)
                b = self._bucket(n)
                chunk = self._chunk(requests[0:b])
            starts = range(0, n, b)
            pending = None
            with torch.inference_mode():
                for k, start in enumerate(starts):
                    with span("serve/launch"):
                        out = self.net.restore(*chunk.inputs)
                        sr = _pack_uint8(out.sr)
                        priors = _pack_uint8(out.priors)
                        done = None
                        if cuda:
                            sr = _to_pinned(sr)
                            priors = _to_pinned(priors)
                            done = torch.cuda.Event()
                            done.record()
                    self._count(chunk)
                    if pending is not None:
                        drain(*pending)
                    pending = (done, sr, priors, chunk,
                               requests[start:start + b])
                    if k + 1 < len(starts):
                        nxt = starts[k + 1]
                        with span("serve/prep"):
                            chunk = self._chunk(requests[nxt:nxt + b])
            drain(*pending)
        # the last wait covered every device span this call recorded
        settle()
        return results

    def _count(self, chunk: _Chunk) -> None:
        """Add a restored chunk to the counts, from host-side shapes."""
        rows, slots = chunk.inputs[1].shape
        self.chunks += 1
        self.rows += rows
        self.rows_real += len(chunk.labels)
        self.slots += rows * slots
        self.slots_real += sum(len(l) for l in chunk.labels)

    def _page_requests(self, page_rgb: np.ndarray,
                       line_boxes: Sequence[Sequence[int]],
                       texts: Optional[Sequence[str]],
                       char_boxes) -> Tuple[List[LineRequest],
                                            List[List[int]]]:
        """Per-segment requests for a page.

        Over-wide lines are split into <= 512 px segments
        (:func:`split_wide_line`); a known text is divided among the
        segments by the x-range each character's box center falls in
        (boxes shifted into segment coordinates), so every segment restores
        only its own characters. Returns the flat request list and, per
        input line box, the indices of its segments' requests (in x order).
        """
        requests: List[LineRequest] = []
        groups: List[List[int]] = []
        for i, (x1, y1, x2, y2) in enumerate(line_boxes):
            crop = page_rgb[y1:y2, x1:x2]
            segs = split_wide_line(crop)
            text_i = None if texts is None else texts[i]
            cb = None if char_boxes is None else char_boxes[i]
            idxs: List[int] = []
            for k, (seg, xoff) in enumerate(segs):
                seg_w = seg.shape[1]
                if text_i is None:
                    # front-end mode: detection runs per segment
                    req = LineRequest(image=seg)
                elif len(segs) == 1:
                    req = LineRequest(image=seg, text=text_i, boxes=cb)
                elif cb is not None:
                    # each character goes to the segment holding its box
                    # center; the first / last segments take centers left
                    # / right of the line, so no character is dropped
                    chars: List[str] = []
                    boxes: List[Tuple[float, float, float, float]] = []
                    for ch, (bx1, by1, bx2, by2) in zip(text_i, cb):
                        c = (bx1 + bx2) / 2.0
                        in_seg = xoff <= c < xoff + seg_w
                        in_seg |= (k == 0 and c < xoff)
                        in_seg |= (k == len(segs) - 1 and c >= xoff + seg_w)
                        if in_seg:
                            boxes.append((max(bx1 - xoff, 0.0), by1,
                                          min(bx2 - xoff, float(seg_w)),
                                          by2))
                            chars.append(ch)
                    req = LineRequest(image=seg, text="".join(chars),
                                      boxes=boxes)
                elif self.frontend is not None:
                    # no character geometry: detect per segment rather than
                    # force the whole line's text into each segment
                    req = LineRequest(image=seg)
                else:
                    raise ValueError(
                        f"line {i} needs splitting into {len(segs)} "
                        "segments, but its text cannot be divided: pass "
                        "char_boxes (xyxy in line-crop coordinates, "
                        "reading order) or configure a front-end")
                idxs.append(len(requests))
                requests.append(req)
            groups.append(idxs)
        return requests, groups

    def restore_page(self, page_rgb: np.ndarray,
                     line_boxes: Sequence[Sequence[int]],
                     texts: Optional[Sequence[str]] = None,
                     char_boxes: Optional[Sequence[Optional[
                         Sequence[Sequence[float]]]]] = None
                     ) -> List[LineResult]:
        """Restore all text lines of a page.

        Crops each line box, splits over-wide lines into <= 512 px
        segments, restores everything through :meth:`restore_lines` and
        reassembles split lines: exactly ONE ``LineResult`` per line box,
        its ``sr`` the stitched whole line.

        Args:
          texts: optional known text per line (manual mode).
          char_boxes: optional per-line character boxes (xyxy, line-crop
            coordinates, reading order matching ``texts[i]``) that divide a
            known text among segments. Without them, split lines fall back
            to the front-end.
        """
        with span("serve/page"):
            requests, groups = self._page_requests(page_rgb, line_boxes,
                                                   texts, char_boxes)
            seg_results = self.restore_lines(requests)
            out: List[LineResult] = []
            for idxs in groups:
                parts = [seg_results[j] for j in idxs]
                if len(parts) == 1:
                    out.append(parts[0])
                    continue
                out.append(LineResult(
                    sr=np.concatenate([p.sr for p in parts], axis=1),
                    text="".join(p.text for p in parts),
                    priors=np.concatenate([p.priors for p in parts],
                                          axis=0)))
        return out


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """A non-blocking device -> host copy of ``t`` into pinned memory."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host
