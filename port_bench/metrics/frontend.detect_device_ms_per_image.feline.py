"""Device ms of the front end's ``frontend/detect`` spans (letterbox
upload, YOLO11-m, NMS) over the images it read (``CharacterFrontend.images``)."""

from port_bench import span_readers


def read(rec):
    return span_readers.span_device_ms_per(rec, "frontend/detect",
                                           "CharacterFrontend.images")
