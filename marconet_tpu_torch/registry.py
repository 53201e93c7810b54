"""Name -> class registries for config-driven construction (counterpart of
``marconet_tpu/registry.py``).

The reference dispatches networks and datasets from YAML ``type:`` fields
through basicsr's filename-scanned registries
(``Train/tspgan/{archs,data,models,losses}/__init__.py``). These are small
explicit registries with a ``build`` helper, filled at import with the
reference's type names mapped to the port's classes, as the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._map: Dict[str, Any] = {}

    def register(self, cls=None, *, name: str = None):
        def deco(c):
            key = name or c.__name__
            if key in self._map and self._map[key] is not c:
                raise KeyError(f"{key} already registered in {self.name}")
            self._map[key] = c
            return c

        return deco(cls) if cls is not None else deco

    def get(self, key: str):
        try:
            return self._map[key]
        except KeyError:
            raise KeyError(
                f"{key!r} not in {self.name} registry; known: "
                f"{sorted(self._map)}") from None

    def build(self, spec: Dict[str, Any], **extra):
        spec = dict(spec)
        cls = self.get(spec.pop("type"))
        return cls(**spec, **extra)

    def __contains__(self, key):
        return key in self._map


ARCHS = Registry("archs")
DATASETS = Registry("datasets")
LOSSES = Registry("losses")
MODELS = Registry("models")


def _populate():
    """Register the built-in components under the reference's type names
    (``Train/options/train.yml``'s ``network_*`` and ``datasets``)."""
    from marconet_tpu_torch.data.synth import TextLineSynthesizer
    from marconet_tpu_torch.data.val_stub import ValStubDataset
    from marconet_tpu_torch.models.encoder import TextContextEncoder
    from marconet_tpu_torch.models.prior import StructurePriorGenerator
    from marconet_tpu_torch.models.srnet import StructurePriorSRNet
    from marconet_tpu_torch.train.discriminators import UNetDiscriminatorSN

    for name, cls in {
        "TextContextEncoderV2": TextContextEncoder,
        "TSPGAN": StructurePriorGenerator,
        "TSPSRNet": StructurePriorSRNet,
        "UNetDiscriminatorSN": UNetDiscriminatorSN,
    }.items():
        if name not in ARCHS:
            ARCHS.register(cls, name=name)
    if "TextDegradationDataset" not in DATASETS:
        DATASETS.register(TextLineSynthesizer,
                          name="TextDegradationDataset")
    if "ValDataset" not in DATASETS:
        DATASETS.register(ValStubDataset, name="ValDataset")


_populate()
