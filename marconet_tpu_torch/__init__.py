"""marconet_tpu_torch: the PyTorch + CUDA port of ``marconet_tpu``.

It runs the three-network restore (text-context encoder, structure-prior
generator, SR net) and the three-phase GAN training loop on NVIDIA Hopper
GPUs, one device a process (data-parallel over ``torch.distributed``), with
the JAX package's TPU kernels on those paths rewritten as hand-written CUDA
kernels (``csrc/``). The JAX package stays the reference
that the port is tested against.

Subpackages mirror the JAX package: ``ops`` (layers and kernel wrappers),
``models`` (encoder, prior generator, SR net, pipeline, and the YOLO11 +
ConvNeXt-ViT front-end), ``train`` (losses, discriminators, LPIPS,
trainer, checkpoints, config, loop, event files, visuals), ``data``
(text-line synthesis, degradations, training batch geometry), ``utils``
(image helpers, a PNG codec, a YAML reader), ``cli`` (the command-line
tools), ``parallel`` (data parallelism), ``registry`` (the reference's
type names), ``dryrun`` (a data-parallel check on CPU processes) and
``convert`` (JAX variables / reference and front-end checkpoints -> this
package's modules). The package imports torch and never jax,
nor any module of the JAX package.
"""

from marconet_tpu_torch.version import __version__

__all__ = ["__version__"]
