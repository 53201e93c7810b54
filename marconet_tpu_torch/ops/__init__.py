"""Layers and kernel wrappers of the port (counterpart of
``marconet_tpu.ops``)."""
