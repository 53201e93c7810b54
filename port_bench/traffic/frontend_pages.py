"""Unlabelled line traffic: one client restoring lines through the front
end, one line a call, as ``test_sr.py`` runs without ``-m``.

The pool is :mod:`port_bench.traffic.pages`' own (its generators, the same
parameters: sizes from ``size_seed``, pixels from the run seed), sent
without text or character boxes, so ``TextPageRestorer`` asks its front
end (``CharacterFrontend``: YOLO11-m, the masked windows, the ConvNeXt-ViT
recognizer, in f32) for each line's characters and boxes before the bf16
restore. The restore's weights come from the run seed; the front end's
from the configuration's ``frontend.weights_seed``, one checkpoint for
every run, so every seed asks the front end for the same work.

Set-up restores one line of each letterboxed shape of the pool, one line
at each character-slot bucket (4, 8, 16) and runs the recognizer at each
padded batch of 1-16 rows, so the window meets no new shape.

The check (after the window, on a seeded sample of the lines restored in
it, the longest among them) compares the program with
:mod:`port_bench.reference.frontend` and :mod:`port_bench.reference.nets`
at every stage, before any decision that rounding can flip:

* ``yolo_raw_gap``: YOLO's decoded boxes and scores before NMS, each
  side on its own letterbox (the worst relative gap, boxes and scores
  each against their largest reference value);
* ``box_lines_off``: lines whose kept boxes differ in count or by more
  than 1 px from the reference's NMS and mapping over the program's own
  outputs before NMS;
* ``segment_levels``: the largest uint8 difference of the program's
  recognizer inputs from the reference's masking of the program's boxes;
* ``ocr_logit_gap``: the largest difference of the recognizer's logits,
  both nets on the program's inputs;
* ``bad_lines``: lines whose output shape differs, whose text differs
  from the text its front end reads for it again after the window, or
  whose character differs from the reference's at a box whose every frame
  has a top-two logit margin above the ``ocr_logit_gap`` limit;
* ``sr_far64_pct``, ``prior_far64_pct``: the restore against the
  reference's f32 restore fed the program's labels and locs.

The control (``tf32+fp8``): the reference in the program's place with
TF32 in the front end's nets and fp8 operands in the restore.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.reference import frontend as ref_fe
from port_bench.reference import nets
from port_bench.reference import page as ref_page
from port_bench.traffic import pages

OCR_ROWS = (1, 2, 4, 8, 16)


def frontend_specs(config: Dict) -> Dict[str, list]:
    return {"yolo": ref_fe.yolo_spec(),
            "ocr": ref_fe.ocr_spec(config["frontend"]["ocr"])}


def restore_specs(config: Dict) -> Dict[str, list]:
    width, classes = config["width"], config["num_classes"]
    return {"encoder": nets.encoder_spec(width, classes),
            "prior": nets.prior_spec(width, classes),
            "srnet": nets.srnet_spec(width)}


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


class Driver(pages.Driver):
    """Set-up, window and check of the front-end line cell."""

    def __init__(self, config: Dict, params: Dict, seed: int,
                 trace: bool, device="cuda"):
        super().__init__(config, params, seed, trace, device=device)
        fe = config["frontend"]
        self.fe_seed = fe["weights_seed"]
        self.shapes = [ref_fe.letterbox_shape(*p[0].shape[:2], fe["imgsz"])
                       for p in self.pool]

    # -- set-up -----------------------------------------------------------

    def build_frontend(self):
        from marconet_tpu_torch.models.convnext_ocr import (
            ConvNextViT,
            OCRConfig,
        )
        from marconet_tpu_torch.models.frontend import CharacterFrontend
        from marconet_tpu_torch.models.yolo import YOLO11

        from port_bench.weights import make_weights

        fe = self.config["frontend"]
        sd = make_weights(frontend_specs(self.config), self.fe_seed,
                          self.device)
        meta = dict(device="meta", generator=torch.Generator())
        yolo = YOLO11(nc=1, **meta)
        yolo.load_state_dict(sd["yolo"], strict=True, assign=True)
        ocr_cfg = dict(fe["ocr"])
        ocr_cfg.pop("vit_mlp_ratio", None)
        ocr = ConvNextViT(OCRConfig(
            depths=tuple(ocr_cfg.pop("depths")),
            dims=tuple(ocr_cfg.pop("dims")),
            vit_mlp_ratio=fe["ocr"]["vit_mlp_ratio"], **ocr_cfg), **meta)
        ocr.load_state_dict(sd["ocr"], strict=True, assign=True)
        return CharacterFrontend(yolo, ocr, conf=fe["conf"], iou=fe["iou"],
                                 imgsz=fe["imgsz"], max_det=fe["max_det"],
                                 device=self.device)

    def setup(self) -> None:
        from marconet_tpu_torch.models.pipeline import MARCONet
        from marconet_tpu_torch.serve import SLOT_BUCKETS, TextPageRestorer

        from port_bench.weights import make_weights

        cfg = self.config
        weights = make_weights(restore_specs(cfg), self.seed, self.device)
        net = MARCONet(cfg["width"], cfg["num_classes"],
                       dtype=getattr(torch, cfg["compute_dtype"]),
                       device=self.device, seed=0)
        for name, sd in weights.items():
            getattr(net, name).load_state_dict(sd, strict=True)
        del weights
        self.net = net
        self.frontend = self.build_frontend()
        self.events: list = []
        self.hooks = []
        target = net
        if self.trace:
            target = pages._Proxy(net)
            for name in ("encoder", "prior", "srnet"):
                self.hooks += pages._hook(getattr(net, name), name,
                                          self.events)
        self.proxy = target if self.trace else None
        self.restorer = TextPageRestorer(target, frontend=self.frontend,
                                         buckets=cfg["buckets"])
        # every letterboxed shape through the whole path, once
        seen = set()
        for k, shape in enumerate(self.shapes):
            if shape not in seen:
                seen.add(shape)
                self.restorer.restore_page(*self.pool[k][:2])
        # every slot bucket of the restore, on the pool's first line
        page, boxes, texts, _ = self.pool[0]
        for n in SLOT_BUCKETS:
            self.restorer.restore_page(page, boxes,
                                       [(texts[0] * n)[:n]])
        # every padded batch of the recognizer up to 16 rows
        width = self.frontend.ocr.config.canonical_width
        blank = np.zeros((32, width, 3), np.uint8)
        for rows in OCR_ROWS:
            self.frontend.recognize_segments([blank] * rows)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if self.proxy is not None:
            self.proxy.calls.clear()
            self.events.clear()

    def program(self) -> list:
        """The program's objects, whose counts the harness reads."""
        return [self.restorer, self.net, self.frontend]

    # -- window -----------------------------------------------------------

    def _counts(self) -> Dict[str, float]:
        out = {k: getattr(self.frontend, k, None)
               for k in ("images", "boxes", "segments", "ocr_rows")}
        out.update(slots=self.restorer.slots,
                   slots_real=self.restorer.slots_real)
        return out

    def run(self, seconds: float) -> None:
        latencies, lines, failed, attempted = [], 0, 0, 0
        self.last: Dict[int, list] = {}
        self.page_log: List[int] = []
        before = self._counts()
        start = time.perf_counter()
        i = 0
        while True:
            k = i % len(self.pool)
            page, boxes = self.pool[k][:2]
            t0 = time.perf_counter()
            attempted += 1
            try:
                with torch.profiler.record_function("bench/page"):
                    res = self.restorer.restore_page(page, boxes)
                ok = _well_formed(res, page)
            except Exception as exc:          # a failed call is counted
                print(f"page {i} failed: {exc!r}", flush=True)
                res, ok = None, False
            t1 = time.perf_counter()
            if ok:
                latencies.append(t1 - t0)
                lines += 1
                self.last[k] = res
                self.page_log.append(k)
            else:
                failed += 1
            i += 1
            if t1 - start >= seconds:
                break
        self.window_s = t1 - start
        self.latencies = latencies
        self.lines, self.failed, self.attempted = lines, failed, attempted
        after = self._counts()
        self.work = {k: (after[k] - before[k]
                         if after[k] is not None else None) for k in after}

    def end_to_end(self) -> Dict[str, float]:
        out = super().end_to_end()
        print(f"work {self.work}", flush=True)
        return out

    def records(self) -> Dict:
        rec = super().records()
        # the pool's drawn character centers are not what the front end
        # found, so they are left out
        rec.update(kind="frontend_pages",
                   letterboxed=[self.shapes[k] for k in self.page_log],
                   segment_centers=[])
        return rec

    # -- correctness ------------------------------------------------------

    def free(self) -> None:
        """The program's own readings of the sampled lines, taken again
        after the window, then the program freed."""
        if getattr(self, "frontend", None) is not None:
            self.readings = self._program_side(self.sample())
        self.frontend = None
        super().free()

    def _program_side(self, sample: List[int]) -> Dict[int, Dict]:
        from marconet_tpu_torch.alphabet import text_from_labels
        from marconet_tpu_torch.models.frontend import (
            letterbox,
            mask_segment,
            prepare_segment,
        )

        fe, chars = self.frontend, ref_page.alphabet()
        width = fe.ocr.config.canonical_width
        out = {}
        for k in sample:
            img = self.pool[k][0]
            padded, gain, pad = letterbox(img, fe.imgsz)
            x = torch.from_numpy(padded[None].astype(np.float32) / 255.0)
            with torch.inference_mode():
                boxes, scores = fe.yolo(x.to(self.device))
            det = fe(img)
            segs = [mask_segment(img, det.boxes, j) for j in
                    range(len(det.boxes))]
            prepared = [prepare_segment(s, width) for s, _ in segs]
            rec = dict(raw=(boxes[0].cpu().numpy(),
                            scores[0, :, 0].cpu().numpy()),
                       gain=gain, pad=pad, kept=det.boxes,
                       starts=[s for _, s in segs],
                       segments=_stack(prepared, width), chars=det.chars)
            rec["logits"] = self._logits(rec["segments"])
            labels = [chars.find(c) for c in det.text]
            labels = [lab for lab in labels if lab >= 0][:nets.MAX_CHARS]
            res = self.last[k][0]
            rec.update(labels=labels,
                       centers=[float(v) for v in
                                det.locs[0:2 * len(labels):2]],
                       sr=res.sr, priors=res.priors,
                       text_ok=res.text == text_from_labels(labels))
            out[k] = rec
        return out

    def _logits(self, segments: np.ndarray) -> np.ndarray:
        """The program's recognizer on ``segments``, at the padded batch
        the front end runs."""
        n = len(segments)
        if not n:
            return np.zeros((0, 0, 0), np.float32)
        x = ref_fe.normalize(segments)
        x = np.concatenate([x, np.zeros((_pow2(n) - n,) + x.shape[1:],
                                        np.float32)])
        with torch.inference_mode():
            logits = self.frontend.ocr(torch.from_numpy(x).to(self.device))
        return logits[:n].float().cpu().numpy()

    def _weights(self, rounding: Optional[str]):
        from port_bench.reference.quant import ROUNDINGS
        from port_bench.weights import make_weights

        fe_q = ROUNDINGS["tf32"] if rounding else None
        re_q = ROUNDINGS["fp8"] if rounding else None
        fe = make_weights(frontend_specs(self.config), self.fe_seed,
                          self.device)
        re = make_weights(restore_specs(self.config), self.seed, self.device)
        return ({n: nets.Ctx(s, q=fe_q) for n, s in fe.items()},
                {n: nets.Ctx(s, q=re_q) for n, s in re.items()})

    def _reference_side(self, sample: List[int],
                        got: Optional[Dict[int, Dict]],
                        rounding: Optional[str] = None) -> Dict[int, Dict]:
        """The reference's readings of the sampled lines: on its own
        letterbox before NMS; on the inputs ``got`` holds after it (its
        NMS over ``got``'s outputs, its masking of ``got``'s boxes, its
        recognizer on ``got``'s segments, its restore of ``got``'s labels
        and locs). With ``got`` None (the control) it feeds itself."""
        fe_ctx, re_ctx = self._weights(rounding)
        fe = self.config["frontend"]
        ocr = fe["ocr"]
        width = ocr["seq_len"] * 4
        chars = ref_page.alphabet()
        tf32 = self.config["allow_tf32"] or rounding is not None
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        out: Dict[int, Dict] = {}
        try:
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            for k in sample:
                img = self.pool[k][0]
                padded, gain, pad = ref_fe.letterbox(img, fe["imgsz"])
                x = torch.from_numpy(padded[None].astype(np.float32) / 255.0)
                with torch.no_grad():
                    b, s = ref_fe.yolo_forward(fe_ctx["yolo"],
                                               x.to(self.device))
                rec = dict(raw=(b[0].cpu().numpy(), s[0, :, 0].cpu().numpy()),
                           gain=gain, pad=pad)
                src = got[k] if got is not None else rec
                rec["kept"] = ref_fe.line_boxes(
                    *src["raw"], src["gain"], src["pad"], img.shape[:2],
                    fe["conf"], fe["iou"], fe["max_det"])
                kept = src["kept"] if got is not None else rec["kept"]
                segs = [ref_fe.masked_window(img, kept, j)
                        for j in range(len(kept))]
                rec["starts"] = [s for _, s in segs]
                rec["segments"] = _stack([ref_fe.recognizer_input(s, width)
                                          for s, _ in segs], width)
                seg_in = src["segments"] if got is not None \
                    else rec["segments"]
                with torch.no_grad():
                    logits = ref_fe.ocr_forward(
                        fe_ctx["ocr"], torch.from_numpy(ref_fe.normalize(
                            seg_in)).to(self.device), ocr) \
                        if len(seg_in) else torch.zeros(0, 0, 0)
                rec["logits"] = logits.float().cpu().numpy()
                ids = rec["logits"].argmax(-1) if len(seg_in) else []
                starts = src["starts"] if got is not None else rec["starts"]
                rec["chars"] = ref_fe.box_chars(
                    [ref_fe.ctc_text(i, chars) for i in ids], starts)
                if got is None:
                    labels = [chars.find(c) for c in "".join(rec["chars"])]
                    labels = [lab for lab in labels if lab >= 0]
                    labels = labels[:nets.MAX_CHARS]
                    rec.update(labels=labels, text_ok=True,
                               centers=ref_fe.center_locs(
                                   kept, img.shape[0])[:len(labels)])
                out[k] = rec
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flags[0]
            torch.backends.cudnn.allow_tf32 = flags[1]
        restored = self._restore(sample, got if got is not None else out,
                                 re_ctx)
        for k in sample:
            out[k]["sr"], out[k]["priors"] = restored[k]
        return out

    def _restore(self, sample, feeds, ctxs, block: int = 8):
        """{line: (sr, priors) uint8} of the reference's restore of each
        line with ``feeds[line]``'s labels and center locs."""
        chars = ref_page.alphabet()
        prepared = [ref_page.prepare(self.pool[k][0], "", [], chars)
                    for k in sample]
        lq = torch.from_numpy(np.stack([p[0] for p in prepared])).to(
            self.device)
        with torch.no_grad():
            sr, priors = nets.restore_lines(
                ctxs, lq, [feeds[k]["labels"] for k in sample],
                [feeds[k]["centers"] for k in sample], block=block)
        return {k: (ref_page.pack_u8(sr[i, :, :prepared[i][1]]),
                    ref_page.pack_u8(priors[i]))
                for i, k in enumerate(sample)}

    def check(self, rounding=None) -> List[tuple]:
        """[(name, value, limit)] of the comparison: the program's readings
        (or, with ``rounding``, the control's) against the reference's."""
        sample = sorted(self.readings) if rounding is None else self.sample()
        got = self.readings if rounding is None else \
            self._reference_side(sample, None, rounding)
        want = self._reference_side(sample, got)
        self.detail: list = []
        return compare(got, want, self.config["limits"], self.detail)


def _stack(prepared: List[np.ndarray], width: int) -> np.ndarray:
    if prepared:
        return np.stack(prepared)
    return np.zeros((0, 32, width, 3), np.uint8)


def _well_formed(res, page) -> bool:
    h, w = page.shape[:2]
    return (len(res) == 1 and res[0].sr.dtype == np.uint8
            and res[0].sr.shape[:2] == (128, int(round(w * 128 / h))))


def _rel_gap(a: np.ndarray, b: np.ndarray) -> float:
    if not b.size:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _sure(logits: np.ndarray, margin: float) -> np.ndarray:
    """Per segment, whether every frame's top-two logit margin exceeds
    ``margin``."""
    if not len(logits):
        return np.zeros(0, bool)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return ((top2[..., 1] - top2[..., 0]) > margin).all(-1)


def _boxes_off(a: np.ndarray, b: np.ndarray) -> bool:
    if a.shape != b.shape:
        return True
    if not len(a):
        return False
    a = a[np.lexsort(a.T[::-1])]
    b = b[np.lexsort(b.T[::-1])]
    return bool(np.abs(a.astype(np.int64) - b.astype(np.int64)).max() > 1)


def compare(got: Dict[int, Dict], want: Dict[int, Dict],
            limits: Dict[str, float], detail: list = None) -> List[tuple]:
    """The numbers compared over the sampled lines (see the module)."""
    yolo = logit = 0.0
    seg_levels, off, bad = 0, 0, 0
    n_sr = n_pri = far_sr = far_pri = 0
    for k, w in want.items():
        g = got[k]
        yolo = max(yolo, _rel_gap(g["raw"][0], w["raw"][0]),
                   _rel_gap(g["raw"][1], w["raw"][1]))
        off += _boxes_off(g["kept"], w["kept"])
        if g["segments"].shape != w["segments"].shape:
            seg_levels = max(seg_levels, 255)
        elif g["segments"].size:
            seg_levels = max(seg_levels, int(np.abs(
                g["segments"].astype(np.int16)
                - w["segments"].astype(np.int16)).max()))
        if g["logits"].shape != w["logits"].shape:
            logit = float("inf")
        elif g["logits"].size:
            logit = max(logit, float(np.abs(g["logits"]
                                            - w["logits"]).max()))
        sure = _sure(w["logits"], limits["ocr_logit_gap"])
        text_off = len(g["chars"]) != len(w["chars"]) or any(
            s and a != b for s, a, b in zip(sure, g["chars"], w["chars"]))
        if (g["sr"].shape != w["sr"].shape or not g["text_ok"] or text_off
                or g["priors"].shape != w["priors"].shape):
            bad += 1
            continue
        a_sr = np.abs(g["sr"].astype(np.int16) - w["sr"].astype(np.int16))
        a_pri = np.abs(g["priors"].astype(np.int16)
                       - w["priors"].astype(np.int16))
        f_sr = int((a_sr > pages.FAR_LEVELS).sum())
        f_pri = int((a_pri > pages.FAR_LEVELS).sum())
        n_sr, n_pri = n_sr + a_sr.size, n_pri + a_pri.size
        far_sr, far_pri = far_sr + f_sr, far_pri + f_pri
        if detail is not None:
            detail.append((float(a_sr.mean()), a_sr.size,
                           float(a_pri.mean()) if a_pri.size else 0.0,
                           a_pri.size, f_sr, f_pri, len(g["kept"]),
                           int(sure.sum())))
    return [("bad_lines", bad, limits["bad_lines"]),
            ("sr_far64_pct", 100.0 * far_sr / max(n_sr, 1),
             limits["sr_far64_pct"]),
            ("prior_far64_pct", 100.0 * far_pri / max(n_pri, 1),
             limits["prior_far64_pct"]),
            ("yolo_raw_gap", yolo, limits["yolo_raw_gap"]),
            ("box_lines_off", off, limits["box_lines_off"]),
            ("segment_levels", seg_levels, limits["segment_levels"]),
            ("ocr_logit_gap", logit, limits["ocr_logit_gap"])]
