"""Character alphabet of the recognizer and the prior's codebook.

The port's own copy of ``marconet_tpu/alphabet.py`` (framework-free, so
the two agree by construction; ``tests/test_torch_imports.py`` checks it).
``assets/alphabet.txt`` holds 6735 characters; index ``i`` is the class
label of character ``i`` and class 6735 is the blank, so there are 6736
classes (reference ``utils/alphabets.py:1``, ``models/networks.py:35``).
The file is read at first use, not at import.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "alphabet.txt")

BLANK_INDEX = 6735               # = len(alphabet()); the last class
NUM_CLASSES = BLANK_INDEX + 1    # 6736


@functools.cache
def alphabet() -> str:
    """The 6735 characters, class label = index."""
    with open(_ASSET, encoding="utf-8") as f:
        text = f.read()
    if len(text) != BLANK_INDEX:
        raise ValueError(f"{_ASSET} holds {len(text)} characters, "
                         f"expected {BLANK_INDEX}")
    return text


def labels_from_text(text: str) -> list[int]:
    """String -> class labels, -1 for a character outside the alphabet
    (reference ``test_sr.py:24-29``, which uses ``str.find``)."""
    chars = alphabet()
    return [chars.find(t) for t in text]


def text_from_labels(labels) -> str:
    """Class labels -> string; the blank renders as nothing
    (reference ``test_sr.py:31-35``)."""
    chars = alphabet()
    out = []
    for label in labels:
        label = int(label)
        if 0 <= label < BLANK_INDEX:
            out.append(chars[label])
        elif label != BLANK_INDEX:
            raise ValueError(f"label {label} out of range")
    return "".join(out)


def collapse_ctc_labels(class_logits) -> list[int]:
    """CTC collapse of per-token argmax predictions: repeats of the
    previous token and the blank are dropped (reference ``test_w.py:34-40``).

    Args:
      class_logits: (T, num_classes) per-token logits (array-like).
    """
    preds = np.asarray(class_logits).argmax(axis=1)
    labels = []
    for i, p in enumerate(preds):
        if i > 0 and preds[i - 1] == p:
            continue
        if p < BLANK_INDEX:
            labels.append(int(p))
    return labels
