"""Validation dataset stub (counterpart of ``marconet_tpu/data/
val_stub.py``).

The reference's validation loop only dumps TensorBoard visuals and feeds a
stub dataset of random tensors (``Train/tspgan/data/val_degradation_dataset
.py:9-20``); this is the same placeholder, drawing the same seeded arrays
as the JAX package's.
"""

from __future__ import annotations

import numpy as np


class ValStubDataset:
    def __init__(self, length: int = 4, seed: int = 0):
        self.length = length
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        return {
            "gt": self.rng.uniform(-1, 1, (128, 2048, 3))
            .astype(np.float32),
            "lq": self.rng.uniform(-1, 1, (32, 512, 3)).astype(np.float32),
        }
