"""Shared pieces of the port's training tests (``tests/test_torch_train*.py``).

- ``WIDTH``, ``SLOTS``, ``BATCH``: the reduced size every training test
  runs at (width 0.0625, 4 character slots, batch 2, f32).
- ``cpu_convs``: a module-scoped autouse fixture (import it into a test
  module to use it) that runs the module with oneDNN convolutions off.
  On this CPU build of PyTorch, the oneDNN backward of a strided 1x1
  convolution over 8 channels_last channels (the encoder's downsample
  at width 0.0625) corrupts the heap and kills the process; PyTorch's
  native convolutions compute the same function.
- ``port_trainer``: a port trainer on the CPU at the reduced size, random
  LPIPS explicitly allowed (the pretrained weights are not in the
  repository).
"""

import pytest
import torch

from marconet_tpu_torch.train.train_step import MARCONetTrainer, TrainConfig

WIDTH = 0.0625
SLOTS = 4
BATCH = 2


@pytest.fixture(scope="module", autouse=True)
def cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def port_trainer(config: TrainConfig = TrainConfig(), seed: int = 0
                 ) -> MARCONetTrainer:
    return MARCONetTrainer(config, device="cpu", seed=seed, width=WIDTH,
                           max_chars=SLOTS, allow_random_lpips=True)
