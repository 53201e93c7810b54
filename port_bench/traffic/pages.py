"""Page traffic: one client restoring seeded pages one after another.

The general generator of every page mix. A workload's parameters say
what a page is: how many pages the pool holds, how many text lines a
page has, how many characters a line has and how tall it is (character
cells are square, so a line is ``chars * height`` px wide). The sizes of
the pool (lines, characters, heights) and their order are drawn from
``size_seed``, the same for every run seed; the run seed draws the text
(uniform over the alphabet) and the pixels (uniform noise), so every seed
offers the same work.

The driver builds ``TextPageRestorer`` over ``MARCONet`` from the
configuration, restores each distinct batch shape of the pool once as
warm-up, then runs a closed loop of ``restore_page`` over the pool, in
order, until the window's seconds have passed. In a traced run the
restorer is given a proxy of the net that records every ``restore``
call's rows and slots with CUDA events around it, and forward hooks time
the encoder, prior and SR net.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench.reference import page as ref_page

def page_sizes(params: Dict) -> List[List[tuple]]:
    """Per pool page, its lines' (characters, height), from
    ``size_seed``."""
    gen = np.random.default_rng(params["size_seed"])
    out = []
    for _ in range(params["pages"]):
        n = int(gen.integers(params["lines"][0], params["lines"][1] + 1))
        chars = gen.integers(params["chars"][0], params["chars"][1] + 1, n)
        heights = gen.integers(params["height"][0], params["height"][1] + 1,
                               n)
        out.append([(int(c), int(h)) for c, h in zip(chars, heights)])
    return out


def make_page(gen: np.random.Generator, lines: List[tuple], chars: str):
    """(page RGB uint8, line boxes, texts, character boxes) of one page:
    the lines stacked down a noise page, each at x = 0."""
    height = sum(h for _, h in lines)
    width = max(c * h for c, h in lines)
    page = gen.integers(0, 256, (height, width, 3), dtype=np.uint8)
    boxes, texts, char_boxes, y = [], [], [], 0
    for n, h in lines:
        boxes.append((0, y, n * h, y + h))
        texts.append("".join(chars[i] for i in gen.integers(0, len(chars), n)))
        char_boxes.append([(i * h + 1.0, 1.0, (i + 1) * h - 1.0, h - 1.0)
                           for i in range(n)])
        y += h
    return page, boxes, texts, char_boxes


def make_pool(params: Dict, seed: int) -> List[tuple]:
    """The run's pool of pages, in the order the client sends them."""
    chars = ref_page.alphabet()
    gen = np.random.default_rng(seed)
    return [make_page(gen, lines, chars) for lines in page_sizes(params)]


class _Proxy:
    """The net as the page server sees it, recording each ``restore``
    call: (rows, slots, start event, end event)."""

    def __init__(self, net):
        self.net = net
        self.device = net.device
        self.calls = []

    def restore(self, lq, labels, locs, char_mask):
        with torch.profiler.record_function("bench/restore"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.net.restore(lq, labels, locs, char_mask)
            end.record()
        self.calls.append((int(lq.shape[0]), int(labels.shape[1]), start,
                           end))
        return out


def _hook(module, name: str, log: list):
    """CUDA events around each forward of ``module``: (name, rows of
    its first input, start, end) appended to ``log``."""
    def pre(mod, args):
        mod._bench_start = torch.cuda.Event(enable_timing=True)
        mod._bench_start.record()

    def post(mod, args, out):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        log.append((name, int(args[0].shape[0]), mod._bench_start, end))

    return [module.register_forward_pre_hook(pre),
            module.register_forward_hook(post)]


class Driver:
    """Set-up, window and check of one page cell."""

    def __init__(self, config: Dict, params: Dict, seed: int,
                 trace: bool, device="cuda"):
        self.config, self.params, self.seed = config, params, seed
        self.trace = trace
        self.device = torch.device(device)
        self.pool = make_pool(params, seed)
        # each pool page's segments' center locs, and their lengths
        self.seg_centers = [ref_page.segment_geometry(*p) for p in self.pool]
        self.seg_chars = [[len(c) for c in segs]
                          for segs in self.seg_centers]
        self.check_records: Dict = {}

    # -- set-up -----------------------------------------------------------

    def setup(self) -> None:
        from marconet_tpu_torch.models.pipeline import MARCONet
        from marconet_tpu_torch.serve import SLOT_BUCKETS, TextPageRestorer

        from port_bench.reference import nets
        from port_bench.weights import make_weights

        cfg = self.config
        width = cfg["width"]
        weights = make_weights({
            "encoder": nets.encoder_spec(width, cfg["num_classes"]),
            "prior": nets.prior_spec(width, cfg["num_classes"]),
            "srnet": nets.srnet_spec(width)}, self.seed, self.device)
        net = MARCONet(width, cfg["num_classes"],
                       dtype=getattr(torch, cfg["compute_dtype"]),
                       device=self.device, seed=0)
        for name, sd in weights.items():
            getattr(net, name).load_state_dict(sd, strict=True)
        del weights
        self.net = net
        self.events: list = []
        self.hooks = []
        target = net
        if self.trace:
            target = _Proxy(net)
            for name in ("encoder", "prior", "srnet"):
                self.hooks += _hook(getattr(net, name), name, self.events)
        self.proxy = target if self.trace else None
        self.restorer = TextPageRestorer(target, buckets=cfg["buckets"])
        # warm every (batch bucket, slot bucket) the pool uses, once
        buckets = sorted(cfg["buckets"])
        seen = set()
        for page, chars in zip(self.pool, self.seg_chars):
            b = next((x for x in buckets if x >= len(chars)), buckets[-1])
            s = next(x for x in SLOT_BUCKETS if x >= max(chars))
            if (b, s) not in seen:
                seen.add((b, s))
                self.restorer.restore_page(*page)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if self.proxy is not None:
            self.proxy.calls.clear()
            self.events.clear()

    def program(self) -> list:
        """The program's objects, whose counts the harness reads."""
        return [self.restorer, self.net]

    # -- window -----------------------------------------------------------

    def run(self, seconds: float) -> None:
        latencies, lines, failed, attempted = [], 0, 0, 0
        self.last: Dict[int, list] = {}
        self.page_log: List[int] = []
        start = time.perf_counter()
        i = 0
        while True:
            k = i % len(self.pool)
            page = self.pool[k]
            t0 = time.perf_counter()
            attempted += 1
            try:
                with torch.profiler.record_function("bench/page"):
                    res = self.restorer.restore_page(*page)
                ok = _well_formed(res, page)
            except Exception as exc:          # a failed page is counted
                print(f"page {i} failed: {exc!r}", flush=True)
                res, ok = None, False
            t1 = time.perf_counter()
            if ok:
                latencies.append(t1 - t0)
                lines += len(page[1])
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

    def end_to_end(self) -> Dict[str, float]:
        lat = np.asarray(self.latencies) * 1e3
        out = {"lines_per_s": self.lines / self.window_s}
        if len(lat):
            out["page_p95_ms"] = float(np.percentile(lat, 95))
            print(f"pages {len(lat)}, median {np.median(lat)} ms, p95 "
                  f"{out['page_p95_ms']} ms, window {self.window_s} s",
                  flush=True)
        return out

    def records(self) -> Dict:
        """What the per-layer readers read from this driver."""
        calls = [(b, n, s.elapsed_time(e)) for b, n, s, e in
                 (self.proxy.calls if self.proxy else [])]
        nets: Dict[str, list] = {}
        for name, rows, s, e in self.events:
            nets.setdefault(name, []).append((rows, s.elapsed_time(e)))
        centers = [c for k in self.page_log for c in self.seg_centers[k]]
        return {"kind": "pages", "restore_calls": calls, "nets": nets,
                "segment_centers": centers, "pages": len(self.page_log),
                "window_s": self.window_s,
                "width": self.config["width"]}

    # -- correctness ------------------------------------------------------

    def free(self) -> None:
        for h in self.hooks:
            h.remove()
        self.restorer = self.proxy = self.net = None
        self.events = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> List[int]:
        """Pool pages to check: the one with most characters and a seeded
        draw of the others that were restored."""
        done = sorted(self.last)
        if not done:
            return []
        big = max(done, key=lambda k: sum(self.seg_chars[k]))
        rest = [k for k in done if k != big]
        gen = np.random.default_rng([self.seed, 7])
        n = min(len(rest), self.params["check_pages"] - 1)
        return [big] + [int(k) for k in gen.choice(rest, n, replace=False)]

    def reference(self, pages: List[int], rounding=None):
        """The reference's results of pool pages ``pages``."""
        from port_bench.reference import nets
        from port_bench.reference.quant import ROUNDINGS
        from port_bench.weights import make_weights

        cfg = self.config
        width = cfg["width"]
        sd = make_weights({
            "encoder": nets.encoder_spec(width, cfg["num_classes"]),
            "prior": nets.prior_spec(width, cfg["num_classes"]),
            "srnet": nets.srnet_spec(width)}, self.seed, self.device)
        q = ROUNDINGS[rounding] if rounding else None
        ctxs = {name: nets.Ctx(s, q=q) for name, s in sd.items()}
        return {k: ref_page.restore_page(ctxs, *self.pool[k],
                                         device=self.device)
                for k in pages}

    def check(self, rounding=None) -> List[tuple]:
        """[(name, value, limit)] of the comparison; the program's results
        against the reference's (or, with ``rounding``, the control
        against the reference)."""
        pages = self.sample()
        want = self.reference(pages)
        got = self.reference(pages, rounding) if rounding else \
            {k: self.last[k] for k in pages}
        self.detail: list = []
        return compare(got, want, self.config["limits"], self.detail)


def _well_formed(res, page) -> bool:
    _, boxes, texts, _ = page
    if len(res) != len(boxes):
        return False
    return all(r.sr.dtype == np.uint8 and r.sr.shape[0] == 128
               and r.text == t for r, t in zip(res, texts))


FAR_LEVELS = 64


def compare(got: Dict[int, list], want: Dict[int, list],
            limits: Dict[str, float], detail: list = None) -> List[tuple]:
    """The numbers compared, over every line of the sample: lines whose
    shape or text differs from the reference's (exact), and the share of
    SR values and of glyph-prior values more than ``FAR_LEVELS`` uint8
    levels from the reference's, in %. ``detail`` collects each line's
    (mean SR difference, SR values, mean prior difference, prior values,
    far SR values, far prior values)."""
    bad, n_sr, n_pri, far_sr, far_pri = 0, 0, 0, 0, 0
    for k, lines in want.items():
        for mine, (sr, text, priors) in zip(got[k], lines):
            m_sr, m_text, m_pri = _fields(mine)
            if (m_sr.shape != sr.shape or m_text != text
                    or m_pri.shape != priors.shape):
                bad += 1
                continue
            a_sr = np.abs(m_sr.astype(np.int16) - sr.astype(np.int16))
            a_pri = np.abs(m_pri.astype(np.int16) - priors.astype(np.int16))
            f_sr = int((a_sr > FAR_LEVELS).sum())
            f_pri = int((a_pri > FAR_LEVELS).sum())
            n_sr, n_pri = n_sr + sr.size, n_pri + priors.size
            far_sr, far_pri = far_sr + f_sr, far_pri + f_pri
            if detail is not None:
                detail.append((float(a_sr.mean()), sr.size,
                               float(a_pri.mean()) if priors.size else 0.0,
                               priors.size, f_sr, f_pri))
        bad += max(0, len(lines) - len(got[k]))
    return [("bad_lines", bad, limits["bad_lines"]),
            ("sr_far64_pct", 100.0 * far_sr / max(n_sr, 1),
             limits["sr_far64_pct"]),
            ("prior_far64_pct", 100.0 * far_pri / max(n_pri, 1),
             limits["prior_far64_pct"])]


def _fields(r):
    if isinstance(r, tuple):
        return r
    return r.sr, r.text, r.priors
