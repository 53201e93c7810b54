"""Seeded weights made on the device, with the reference's key names.

All leaves of all networks come from one ``torch.randn`` call of a
``torch.Generator`` on the device, split into the leaves and scaled to
their distributions (:mod:`port_bench.reference.nets` lists them); the
spectral vectors of each spectral weight are then aligned by power
iteration, so every random network starts with sigma near its largest
singular value, as a trained one has.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

POWER_ITERATIONS = 10


def make_weights(specs: Dict[str, List[tuple]], seed: int, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: spec} -> {net: state dict} drawn from ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed % 2**63)
    sizes = [math.prod(shape) for spec in specs.values()
             for _, shape, kind, _, _ in spec if kind != "sn_v"]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    chunks = iter(torch.split(flat, sizes))
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for net, spec in specs.items():
        sd: Dict[str, torch.Tensor] = {}
        for key, shape, kind, mean, std in spec:
            if kind == "sn_v":
                continue
            t = next(chunks).view(shape)
            sd[key] = t * std + mean if kind == "normal" else t
        for key, shape, kind, _, _ in spec:
            if kind != "sn_u":
                continue
            p = key[:-len(".weight_u")]
            wm = sd[f"{p}.weight_orig"].reshape(shape[0], -1)
            u = F.normalize(sd[key], dim=0, eps=1e-12)
            for _ in range(POWER_ITERATIONS):
                u = F.normalize(wm @ F.normalize(wm.T @ u, dim=0, eps=1e-12),
                                dim=0, eps=1e-12)
            sd[key] = u
            sd[f"{p}.weight_v"] = F.normalize(wm.T @ u, dim=0, eps=1e-12)
        out[net] = {key: sd[key] for key, *_ in spec}
    return out
