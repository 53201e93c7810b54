"""Operations of the front end's two nets, from their shapes (a
multiply-add counts 2; only convolutions, linears and attention's two
products count, as in :mod:`port_bench.counts.flops`). The counts follow
:mod:`port_bench.reference.frontend`; the tests hold them to
``torch.utils.flop_counter`` over it."""

from __future__ import annotations

from typing import Dict

from port_bench.counts.flops import conv, dense, restore_line


def _c3k2(ci: int, co: int, e: float, c3k: bool, h: int, w: int) -> float:
    c = int(co * e)
    total = conv(ci, 2 * c, 1, h, w) + conv(3 * c, co, 1, h, w)
    if c3k:
        half = c // 2
        total += 2 * conv(c, half, 1, h, w) + conv(2 * half, c, 1, h, w)
        total += 2 * (2 * conv(half, half, 3, h, w))
    else:
        total += conv(c, c // 2, 3, h, w) + conv(c // 2, c, 3, h, w)
    return total


def yolo(h: int, w: int, nc: int = 1) -> float:
    """YOLO11-m over one letterboxed (h, w) image."""
    s = {k: (h // k, w // k) for k in (2, 4, 8, 16, 32)}
    total = conv(3, 64, 3, *s[2]) + conv(64, 128, 3, *s[4])
    total += _c3k2(128, 256, 0.25, False, *s[4])
    total += conv(256, 256, 3, *s[8]) + _c3k2(256, 512, 0.25, False, *s[8])
    total += conv(512, 512, 3, *s[16]) + _c3k2(512, 512, 0.5, True, *s[16])
    total += conv(512, 512, 3, *s[32]) + _c3k2(512, 512, 0.5, True, *s[32])
    total += conv(512, 256, 1, *s[32]) + conv(1024, 512, 1, *s[32])  # SPPF
    n = s[32][0] * s[32][1]                                       # C2PSA
    total += 2 * conv(512, 512, 1, *s[32])
    total += conv(256, 512, 1, *s[32]) + conv(256, 256, 1, *s[32])
    total += 2.0 * 256 * 9 * n                       # depthwise pe
    total += dense(n, 32 * 4, n) + dense(64 * 4, n, n)   # q^T k, v attn^T
    total += conv(256, 512, 1, *s[32]) + conv(512, 256, 1, *s[32])
    total += _c3k2(1024, 512, 0.5, False, *s[16])
    total += _c3k2(1024, 256, 0.5, False, *s[8])
    total += conv(256, 256, 3, *s[16]) + _c3k2(768, 512, 0.5, False, *s[16])
    total += conv(512, 512, 3, *s[32]) + _c3k2(1024, 512, 0.5, True, *s[32])
    for c, k in ((256, 8), (512, 16), (512, 32)):
        hw = s[k]
        total += conv(c, 64, 3, *hw) + conv(64, 64, 3, *hw)
        total += conv(64, 64, 1, *hw)
        total += 2.0 * c * 9 * hw[0] * hw[1] + conv(c, 256, 1, *hw)
        total += 2.0 * 256 * 9 * hw[0] * hw[1] + conv(256, 256, 1, *hw)
        total += conv(256, nc, 1, *hw)
    return total


def ocr(width: int, cfg: Dict) -> float:
    """The recognizer over one (32, ``width``) input."""
    dims, h, w = cfg["dims"], 8, width // 4
    total = conv(3, dims[0], 4, h, w)
    for s, (depth, c) in enumerate(zip(cfg["depths"], dims)):
        if s:
            h //= 2
            total += 2.0 * dims[s - 1] * c * 2 * h * w
        total += depth * (2.0 * c * 49 * h * w + 2 * conv(c, 4 * c, 1, h, w))
    d, n = cfg["vit_dim"], w
    hidden = int(d * cfg["vit_mlp_ratio"])
    block = (dense(n, d, 3 * d) + 2 * dense(n, n, d) + dense(n, d, d)
             + dense(n, d, hidden) + dense(n, hidden, d))
    return total + cfg["vit_depth"] * block + dense(n, d, cfg["num_classes"])


def restore_lines(lines: int, chars: int, width: float = 1.0) -> float:
    """The restore of ``lines`` lines holding ``chars`` characters in
    all."""
    per_char = restore_line(1, width) - restore_line(0, width)
    return lines * restore_line(0, width) + chars * per_char
