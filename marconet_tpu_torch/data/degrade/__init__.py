from marconet_tpu_torch.data.degrade.bsrgan import bsrgan_degradation
from marconet_tpu_torch.data.degrade.realesrgan import (
    real_esrgan_degradation,
)

__all__ = ["real_esrgan_degradation", "bsrgan_degradation"]
