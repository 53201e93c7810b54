"""Self time of the front end's ``frontend/mask`` spans (the masked windows
and their recognizer inputs, numpy on the host), in ms, over the images it
read (``CharacterFrontend.images``)."""

from port_bench import span_readers


def read(rec):
    return span_readers.self_ms_per(rec, "frontend/mask",
                                    "CharacterFrontend.images")
