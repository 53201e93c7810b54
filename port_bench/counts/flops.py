"""Operations of the reference's work, from its shapes.

A multiply-add counts 2. Only matrix products count (convolutions,
linears, attention's two products): elementwise work, normalization and
resampling are left out, as in the usual model-FLOPs convention. The
counts follow the reference networks of :mod:`port_bench.reference.nets`
at a channel ``width``; :func:`count` measures any callable with
``torch.utils.flop_counter`` and is what the tests hold these to.

A restored line of ``n`` characters costs its encoder and SR trunk once
and its prior and SFT windows once per character (the padded slots and
rows of a batch are not useful work and are not counted).
"""

from __future__ import annotations

from port_bench.reference.nets import (
    _PYRAMID,
    _STAGES,
    _STRIDES,
    MAX_CHARS,
    NUM_CLASSES,
    prior_channels,
    scaled,
)

LQ_H, LQ_W = 32, 512


def conv(ci: int, co: int, k: int, h: int, w: int) -> float:
    """A k x k convolution producing (co, h, w) from ci channels."""
    return 2.0 * ci * co * k * k * h * w


def dense(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def encoder(width: float = 1.0, num_classes: int = NUM_CLASSES,
            max_chars: int = MAX_CHARS) -> float:
    """One (32, 512) line through ResNet-45 and the ViT head."""
    feats = [scaled(c, width) for _, c in _STAGES]
    dim = scaled(512, width, floor=32, multiple=4)
    inner = 8 * scaled(64, width)
    h, w = LQ_H, LQ_W
    total = conv(3, feats[0], 3, h, w)
    cin = feats[0]
    for (blocks, _), c, stride in zip(_STAGES, feats, _STRIDES):
        for bi in range(blocks):
            st = stride if bi == 0 else (1, 1)
            total += conv(cin, c, 1, h, w)              # conv1 at the input
            h2, w2 = h // st[0], w // st[1]
            total += conv(c, c, 3, h2, w2)
            if bi == 0 and (st != (1, 1) or cin != c):
                total += conv(cin, c, 1, h2, w2)
            h, w, cin = h2, w2, c
    n = (h // 8) * (w // 8)                             # 64 tokens

    def block(tokens, hidden):
        return (dense(tokens, dim, 3 * inner)
                + 2 * dense(tokens, tokens, inner) + dense(tokens, inner, dim)
                + dense(tokens, dim, hidden) + dense(tokens, hidden, dim))

    seq = 4 * max_chars
    total += dense(n, 64 * cin, dim)
    total += 3 * block(n, 2 * dim) + block(n, dim)      # trunk, cls, w
    total += dense(dim, seq, max_chars) + block(max_chars, dim)   # locs
    total += dense(n, dim, num_classes)
    total += dense(max_chars, dim, dim // 2) + dense(max_chars, dim // 2, 2)
    total += dense(dim, seq, 1) + dense(1, dim, dim)
    return total


def prior(width: float = 1.0) -> float:
    """One character slot through the style MLP and the generator."""
    ch = prior_channels(width)
    sdim = scaled(512, width, floor=32, multiple=4)
    total = 8 * dense(1, sdim, sdim)

    def modconv(ci, co, k, res):
        return dense(1, sdim, ci) + conv(ci, co, k, res, res)

    total += modconv(ch[4], ch[4], 3, 4) + modconv(ch[4], 3, 1, 4)
    cin = ch[4]
    for res in _PYRAMID:
        total += modconv(cin, ch[res], 3, res) + modconv(ch[res], ch[res], 3,
                                                         res)
        total += modconv(ch[res], 3, 1, res)
        cin = ch[res]
    return total


def _res_block(ci: int, co: int, h: int, w: int) -> float:
    total = conv(ci, co, 3, h, w) + conv(co, co, 3, h, w)
    if ci != co:
        total += conv(ci, co, 1, h, w)
    return total


def srnet_trunk(width: float = 1.0) -> float:
    """One line through the SR net without its SFT windows."""
    ch = prior_channels(width)
    d = ch[64]
    total = conv(3, d // 4, 3, 32, 512) + conv(d // 4, d // 2, 3, 16, 256)
    total += conv(d // 2, d, 3, 8, 128) + conv(d, d, 3, 8, 128)
    total += conv(d + d // 2, d, 3, 16, 256) + conv(d, d, 3, 16, 256)
    total += conv(d + d // 4, d, 3, 32, 512) + conv(d, d, 3, 32, 512)
    total += conv(d, d, 3, 64, 1024) + _res_block(d, d, 64, 1024)
    total += conv(d, d, 3, 64, 1024)
    total += conv(d, d // 2, 3, 64, 1024) + conv(d // 2, d // 4, 3, 128, 2048)
    total += _res_block(d // 4, d // 4, 128, 2048)
    total += conv(d // 4, 3, 3, 128, 2048)
    return total


def sft_char(width: float = 1.0) -> float:
    """One character's SFT at both scales (full windows) and its prior
    features' projection at the 32 scale."""
    ch = prior_channels(width)
    d, pc = ch[64], ch[32]
    total = conv(pc, d, 3, 32, 32) + conv(d, d, 3, 32, 32)
    for size in (32, 64):
        total += _res_block(2 * d, d, size, size)
        total += 4 * conv(d, d, 3, size, size)
    return total


def restore_line(n_chars: int, width: float = 1.0) -> float:
    """Useful operations of restoring one line of ``n_chars`` characters."""
    return (encoder(width) + srnet_trunk(width)
            + n_chars * (prior(width) + sft_char(width)))


def count(fn, *args, **kwargs) -> float:
    """Operations of the matrix products ``fn`` runs (forward and, if it
    runs one, backward), by ``torch.utils.flop_counter``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
