"""The three core networks, the restore pipeline and the YOLO11 +
ConvNeXt-ViT front-end (counterpart of ``marconet_tpu.models``)."""
