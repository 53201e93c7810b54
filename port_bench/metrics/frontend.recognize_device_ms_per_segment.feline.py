"""Device ms of the front end's ``frontend/recognize`` spans (upload,
ConvNeXt-ViT, argmax) over the masked windows recognized
(``CharacterFrontend.segments``, padding rows not counted)."""

from port_bench import span_readers


def read(rec):
    return span_readers.span_device_ms_per(rec, "frontend/recognize",
                                           "CharacterFrontend.segments")
