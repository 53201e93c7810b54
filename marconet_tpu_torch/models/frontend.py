"""Character detection + recognition front-end (counterpart of
``marconet_tpu/models/frontend.py``).

The reference's YOLO + OCR step (``utils/yolo_ocr_xloc.py:7-103``): detect
character boxes with YOLO11 (letterboxed to 640, conf 0.07, iou 0.1),
sort them left to right, and for each character crop a window of 5 boxes,
soft-mask everything outside the window's boxes to the blurred mean
background colour, recognize the masked segment with the ConvNeXt CTC
recognizer and take the character at the box's position in it.

The masking and cropping stay on the host in numpy, byte-exact with the
JAX package's cv2 calls (``utils/image.resize_linear_u8``,
``gaussian_blur_u8``); the two networks run in f32 on the front-end's
device. Only the kept boxes and the recognizer's per-frame argmax ids
come back to the host.

Under ``torch.profiler`` a call marks its work as spans
(``utils/tracing.py``): ``frontend/detect`` (letterbox, upload, YOLO,
NMS, the kept boxes back on the host), ``frontend/mask`` (the masked
windows and their recognizer inputs, on the host) and
``frontend/recognize`` (upload, recognizer, argmax, ids back, decode);
on CUDA the first and the last record their device ms too. Counts kept
on every call, profiler or not: ``images``, ``boxes`` (kept),
``segments`` (windows recognized) and ``ocr_rows``
(recognizer rows run, the power-of-two padding included).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from marconet_tpu_torch.models.convnext_ocr import (
    ConvNextViT,
    decode_ctc_ids,
)
from marconet_tpu_torch.models.pipeline import resolve_device
from marconet_tpu_torch.models.yolo import YOLO11, nms_static
from marconet_tpu_torch.utils.image import (
    gaussian_blur_u8,
    normalized_locs_from_boxes,
    resize_linear_u8,
)
from marconet_tpu_torch.utils.tracing import settle, span

# checkpoint file names searched by ``from_checkpoints`` (the JAX
# package's; its export tools write the first of each)
YOLO_FILES = ("yolo11m_character_sd.pth", "yolo11m_character.pt")
OCR_SD_FILES = ("ocr_convnext_sd.pth", "ocr_recognition_sd.pth",
                "pytorch_model.pt")
OCR_VOCAB_FILES = ("ocr_vocab.txt", "vocab.txt")


@dataclass
class FrontendResult:
    boxes: np.ndarray          # (N, 4) xyxy int, sorted left to right
    chars: List[str]           # one per box ('' when unrecognized)
    text: str
    locs: np.ndarray           # (2N,) normalized (center, half-width)
    x_centers: List[int]


def letterbox(img: np.ndarray, size: int = 640, auto: bool = True,
              stride: int = 32
              ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Ultralytics ``LetterBox``: aspect-preserving linear resize, then a
    gray-114 border; with ``auto`` each side is padded only up to the next
    ``stride`` multiple, split by ``round(d -/+ 0.1)``. Returns (padded
    image, scale r, (top, left) pad offsets)."""
    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nw, nh = int(round(w * r)), int(round(h * r))
    dw, dh = size - nw, size - nh
    if auto:
        dw, dh = dw % stride, dh % stride
    dw /= 2
    dh /= 2
    resized = img if (w, h) == (nw, nh) else resize_linear_u8(img, nw, nh)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.pad(resized, ((top, bottom), (left, right), (0, 0)),
                 constant_values=114)
    return out, r, (top, left)


def mask_segment(img: np.ndarray, boxes: Sequence[Sequence[int]],
                 j: int, num_cropped_boxes: int = 5, expand_px: int = 1,
                 expand_edge: int = 12) -> Tuple[np.ndarray, int]:
    """Crop and soft-mask the window of ``num_cropped_boxes`` boxes around
    box ``j`` (reference ``yolo_ocr_xloc.py:45-89``). Returns (masked
    segment, index of the window's first box).

    Outside the window's boxes the segment fades to the mean colour of
    its non-text pixels (truncated to uint8, as ``cv2.mean`` into
    ``np.uint8``) through a 15 x 15 Gaussian of the box mask.
    """
    n = len(boxes)
    if n <= num_cropped_boxes:
        idxs = list(range(n))
    else:
        half = num_cropped_boxes // 2
        start = max(0, min(j - half, n - num_cropped_boxes))
        idxs = list(range(start, start + num_cropped_boxes))
    window = [boxes[i] for i in idxs]
    contains_last = (n - 1) in idxs

    x1 = min(b[0] for b in window)
    x2 = max(b[2] for b in window)
    if j == 0:
        x1 = max(x1 - expand_edge, 0)
    if contains_last:
        x2 = min(x2 + expand_edge, img.shape[1])
    seg = img[:, x1:x2].copy()

    mask = np.zeros(seg.shape[:2], np.uint8)
    for b in window:
        bx1 = max(b[0] - x1 - expand_px, 0)
        bx2 = min(b[2] - x1 + expand_px, x2 - x1)
        mask[:, bx1:bx2] = 255
    background = mask == 0
    if background.any():
        mean = seg[background].astype(np.float64).sum(axis=0) \
            / np.count_nonzero(background)
        mean_color = mean[:3].astype(np.uint8)
    else:
        mean_color = np.array([255, 255, 255], np.uint8)
    mean_img = np.full(seg.shape, mean_color, np.uint8)
    # every row of the mask is the same, and so is every row of its blur
    # (the kernel sums to 1 down each column): blur one row
    alpha = (gaussian_blur_u8(mask[:1], 15).astype(np.float32)
             / 255.0)[..., None]
    return (seg * alpha + mean_img * (1 - alpha)).astype(np.uint8), idxs[0]


def prepare_segment(segment_rgb: np.ndarray,
                    canonical_width: Optional[int] = None) -> np.ndarray:
    """Resize a masked segment to the recognizer's input: height 32,
    aspect kept; with ``canonical_width`` exactly that wide (narrower
    segments edge-padded, wider ones squeezed), else padded to a multiple
    of 64."""
    seg = segment_rgb
    h = seg.shape[0]
    w = max(int(seg.shape[1] * 32 / h), 8)
    if canonical_width is not None and w > canonical_width:
        w = canonical_width
    seg = resize_linear_u8(seg, w, 32)
    target = canonical_width if canonical_width is not None \
        else w + ((-w) % 64)
    if target > seg.shape[1]:
        seg = np.pad(seg, ((0, 0), (0, target - seg.shape[1]), (0, 0)),
                     mode="edge")
    return seg


class CharacterFrontend:
    """YOLO11 detector + ConvNextViT recognizer on one device, in f32.

    Args:
      yolo: a :class:`~marconet_tpu_torch.models.yolo.YOLO11` (one class).
      ocr: a :class:`~marconet_tpu_torch.models.convnext_ocr.ConvNextViT`,
        or None: then recognition returns '' per box and callers fall back
        to the encoder's own CTC head (reference ``test_w.py:34-40``).
      ocr_charset: the recognizer's vocabulary (class ``offset + i`` is
        ``ocr_charset[i]``, ``offset = num_classes - len(ocr_charset)``);
        None: the alphabet, offset 0.
      device: where both networks run; CUDA unless named
        (:func:`~marconet_tpu_torch.models.pipeline.resolve_device`).
    """

    def __init__(self, yolo: YOLO11, ocr: Optional[ConvNextViT] = None,
                 ocr_charset: Optional[str] = None, conf: float = 0.07,
                 iou: float = 0.1, imgsz: int = 640, max_det: int = 100,
                 *, device="cuda"):
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.conf, self.iou, self.imgsz = conf, iou, imgsz
        self.max_det = max_det
        self.yolo = None if yolo is None else \
            yolo.to(self.device, torch.float32).eval()
        self.ocr = None if ocr is None else \
            ocr.to(self.device, torch.float32).eval()
        self.ocr_charset = ocr_charset
        self.images = self.boxes = self.segments = self.ocr_rows = 0
        self.ocr_offset = 0
        if ocr is not None and ocr_charset:
            self.ocr_offset = max(0, ocr.config.num_classes - len(ocr_charset))

    @classmethod
    def from_checkpoints(cls, ckpt_dir: str, *, device="cuda",
                         **kw) -> "CharacterFrontend":
        """Load the detector from ``yolo11m_character_sd.pth`` (or
        ``yolo11m_character.pt``) and, when present, the recognizer from
        ``ocr_convnext_sd.pth`` / ``ocr_recognition_sd.pth`` /
        ``pytorch_model.pt`` with ``ocr_vocab.txt`` / ``vocab.txt``, all
        under ``ckpt_dir``; every load is strict."""
        from marconet_tpu_torch.convert import (
            load_ocr_checkpoint,
            load_vocab,
            load_yolo_checkpoint,
        )

        def find(names):
            for name in names:
                cand = os.path.join(ckpt_dir, name)
                if os.path.exists(cand):
                    return cand
            return None

        yolo_path = find(YOLO_FILES)
        if yolo_path is None:
            raise FileNotFoundError(f"no YOLO checkpoint under {ckpt_dir} "
                                    f"(expected one of {YOLO_FILES})")
        meta = dict(device="meta", generator=torch.Generator())
        yolo = YOLO11(nc=1, **meta)
        yolo.load_state_dict(load_yolo_checkpoint(yolo_path), strict=True,
                             assign=True)

        ocr, charset = None, None
        ocr_path, vocab_path = find(OCR_SD_FILES), find(OCR_VOCAB_FILES)
        if ocr_path is not None:
            sd, cfg = load_ocr_checkpoint(ocr_path)
            ocr = ConvNextViT(cfg, **meta)
            ocr.load_state_dict(sd, strict=True, assign=True)
            charset = load_vocab(vocab_path) if vocab_path else None
            print(f"frontend: loaded OCR recognizer "
                  f"{os.path.basename(ocr_path)} ({cfg.num_classes} "
                  f"classes, vocab={'yes' if charset else 'MISSING'})")
        else:
            print(f"frontend: no OCR recognizer weights under {ckpt_dir} "
                  f"(expected one of {OCR_SD_FILES}) — falling back to the "
                  "encoder's CTC head for recognition")
        return cls(yolo, ocr, ocr_charset=charset, device=device, **kw)

    # -- detection ---------------------------------------------------------

    @torch.inference_mode()
    def detect_boxes(self, img_rgb: np.ndarray) -> np.ndarray:
        """(N, 4) int xyxy boxes in image coordinates, sorted by x1."""
        with span("frontend/detect", self.cuda):
            padded, r, (top, left) = letterbox(img_rgb, self.imgsz)
            x = torch.from_numpy(padded[None].astype(np.float32) / 255.0)
            boxes, scores = self.yolo(x.to(self.device))
            boxes, _, valid = nms_static(boxes[0], scores[0, :, 0],
                                         max_det=self.max_det,
                                         iou_thresh=self.iou,
                                         conf_thresh=self.conf)
            boxes = boxes[valid > 0].cpu().numpy()
        boxes[:, [0, 2]] = (boxes[:, [0, 2]] - left) / r
        boxes[:, [1, 3]] = (boxes[:, [1, 3]] - top) / r
        h, w = img_rgb.shape[:2]
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
        boxes = boxes.astype(int)
        return boxes[np.argsort(boxes[:, 0])]

    # -- recognition -------------------------------------------------------

    def recognize_segment(self, segment_rgb: np.ndarray) -> str:
        return self.recognize_segments([segment_rgb])[0]

    def prepare_segments(self, segments: Sequence[np.ndarray]
                         ) -> List[np.ndarray]:
        """Masked segments at the recognizer's input geometry
        (:func:`prepare_segment` at its canonical width)."""
        if self.ocr is None:
            return list(segments)
        width = self.ocr.config.canonical_width
        return [prepare_segment(s, width) for s in segments]

    def recognize_segments(self,
                           segments: Sequence[np.ndarray]) -> List[str]:
        """Recognize masked segments (see :meth:`recognize_prepared`)."""
        return self.recognize_prepared(self.prepare_segments(segments))

    @torch.inference_mode()
    def recognize_prepared(self,
                           prepared: Sequence[np.ndarray]) -> List[str]:
        """Recognize prepared segments in batched recognizer calls: grouped
        by width (one group under a checkpoint's canonical width), each
        batch padded with zero rows to the next power of two (rows are
        independent). The per-frame argmax runs on the device; only the
        (B, T) ids come to the host."""
        if self.ocr is None or len(prepared) == 0:
            return ["" for _ in prepared]
        cfg = self.ocr.config
        out: List[Optional[str]] = [None] * len(prepared)
        by_width: dict = {}
        for i, seg in enumerate(prepared):
            by_width.setdefault(seg.shape[1], []).append(i)
        with span("frontend/recognize", self.cuda):
            for idxs in by_width.values():
                x = np.stack([prepared[i] for i in idxs]).astype(np.float32)
                x = (x / 255.0 - 0.5) / 0.5
                n = len(idxs)
                nb = 1 << (n - 1).bit_length()            # 1, 2, 4, 8, ...
                if nb > n:
                    x = np.concatenate(
                        [x, np.zeros((nb - n,) + x.shape[1:], x.dtype)])
                logits = self.ocr(torch.from_numpy(x).to(self.device))
                ids = logits.argmax(-1).to(torch.int32)[:n].cpu().numpy()
                texts = decode_ctc_ids(ids, charset=self.ocr_charset,
                                       blank=cfg.blank_index,
                                       offset=self.ocr_offset)
                for i, t in zip(idxs, texts):
                    out[i] = t.replace(" ", "")
                self.segments += n
                self.ocr_rows += nb
        return out  # type: ignore[return-value]

    # -- full pipeline -----------------------------------------------------

    def __call__(self, img_rgb: np.ndarray) -> FrontendResult:
        self.images += 1
        boxes = self.detect_boxes(img_rgb)
        self.boxes += len(boxes)
        with span("frontend/mask"):
            segs, starts = [], []
            for j in range(len(boxes)):
                seg, start = mask_segment(img_rgb, boxes, j)
                segs.append(seg)
                starts.append(start)
            prepared = self.prepare_segments(segs)
        texts = self.recognize_prepared(prepared)
        chars: List[str] = []
        centers: List[int] = []
        for j, (box, start, text) in enumerate(zip(boxes, starts, texts)):
            chars.append(text[min(j - start, len(text) - 1)] if text else "")
            centers.append(int((box[0] + box[2]) // 2))
        locs = normalized_locs_from_boxes(boxes, img_rgb.shape[0])
        # the ids' copy to the host covered every device span of the call
        settle()
        return FrontendResult(boxes=boxes, chars=chars,
                              text="".join(chars), locs=locs,
                              x_centers=centers)
