"""Blind text-line SR inference CLI (counterpart of ``tools/test_sr.py``).

Same flags as the JAX tool (``-i/--test_path``, ``-o/--save_path``,
``-m/--manual``, ``--ckpt_dir``, ``--dtype``) plus ``--device``, and the
same 4-row collage per line (LQ / predicted boxes / SR / glyph priors).

With ``-m`` the text comes from the file name after its last ``_`` and
the character boxes from the encoder's own locs head (two restores a
line). Without it the YOLO + OCR front-end gives boxes and text; when no
OCR recognizer is found the text comes from the encoder's CTC head, and
when no YOLO checkpoint is found the tool falls back to ``-m``.

Example::

    python -m marconet_tpu_torch.cli.test_sr -i Testsets/LQsWithText \\
        -o results/ -m --ckpt_dir checkpoints/ --device cpu
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from marconet_tpu_torch.alphabet import (
    BLANK_INDEX,
    collapse_ctc_labels,
    labels_from_text,
    text_from_labels,
)
from marconet_tpu_torch.cli.common import (
    DTYPES,
    load_frontend,
    read_image,
    text_from_name,
)
from marconet_tpu_torch.convert import load_reference_or_random
from marconet_tpu_torch.models.encoder import MAX_CHARS
from marconet_tpu_torch.models.pipeline import MARCONet
from marconet_tpu_torch.utils.image import (
    draw_boxes,
    postprocess_sr,
    preprocess_line,
    stack_collage,
)
from marconet_tpu_torch.utils.png import write_png


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-i", "--test_path", type=str, default="./Testsets/LQs")
    p.add_argument("-o", "--save_path", type=str, default=None)
    p.add_argument("-m", "--manual", action="store_true",
                   help="take GT text from the filename suffix")
    p.add_argument("--ckpt_dir", type=str, default="./checkpoints")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=list(DTYPES))
    p.add_argument("--device", type=str, default="cuda",
                   help="where the networks run (cuda or cpu)")
    return p


def _text_and_locs(net: MARCONet, frontend, img: np.ndarray, lq, name: str
                   ) -> Tuple[str, Optional[np.ndarray]]:
    """Text and locs of one line from the front-end; without OCR weights
    the text comes from the encoder's CTC head, the boxes stay YOLO's."""
    det = frontend(img)
    text = det.text
    if len(det.boxes) > 0 and not any(det.chars):
        logits, _, _ = net.encode(torch.from_numpy(lq))
        text = text_from_labels(collapse_ctc_labels(
            logits[0].float().cpu().numpy()))
        if len(text) != len(det.boxes):
            print(f"Warning!!! {name}: encoder CTC gave {len(text)} chars "
                  f"for {len(det.boxes)} boxes; using the shorter count.")
            text = text[:len(det.boxes)]
        print(f"  encoder-CTC recognition: {text!r}")
    return text, det.locs


def restore_dir(net: MARCONet, frontend, test_path: str, save_path: str
                ) -> List[Tuple[str, str, int]]:
    """Restore every line image in ``test_path`` (any file ``read_image``
    reads) and write its collage to ``save_path`` as ``<stem>_<text>.png``
    (a ``/`` of the text written as ``_``); manual mode when ``frontend``
    is None. Returns (file name, text, restores) per written collage."""
    done = []
    for img_name in sorted(os.listdir(test_path)):
        path = os.path.join(test_path, img_name)
        if os.path.isdir(path):
            continue
        base = os.path.splitext(img_name)[0]
        img = read_image(path)
        if img is None:
            continue
        pre = preprocess_line(img)
        if pre is None:
            print(f"Warning!!! {img_name}: LQ wider than 512 after resize "
                  "to h=32 — crop it into shorter segments. Skipping.")
            continue
        lq, show_lq, _ = pre

        if frontend is not None:
            text, locs_vec = _text_and_locs(net, frontend, img, lq, img_name)
        else:
            text, locs_vec = text_from_name(img_name), None
        labels_list = [l for l in labels_from_text(text) if l >= 0]
        n_chars = len(labels_list)
        if n_chars < 1:
            print(f"Warning!!! No character for {img_name}. Continue...")
            continue
        if n_chars > MAX_CHARS:
            print(f"Warning!!! {img_name} has {n_chars} chars > "
                  f"{MAX_CHARS}. Truncating.")
            labels_list, n_chars = labels_list[:MAX_CHARS], MAX_CHARS

        labels = np.full((1, MAX_CHARS), BLANK_INDEX, np.int64)
        labels[0, :n_chars] = labels_list
        mask = np.zeros((1, MAX_CHARS), np.float32)
        mask[0, :n_chars] = 1.0
        locs = np.zeros((1, 2 * MAX_CHARS), np.float32)
        if locs_vec is not None:
            locs[0, :len(locs_vec)] = locs_vec[:2 * MAX_CHARS]

        def restore():
            return net.restore(*map(torch.from_numpy,
                                    (lq, labels, locs, mask)))

        out, restores = restore(), 1
        if locs_vec is None:
            # without a front-end: the encoder's predicted locs for the
            # first n slots, then restore again
            pred = out.pred_locs[0].float().cpu().numpy()
            locs[0, :2 * n_chars] = pred[:2 * n_chars]
            out, restores = restore(), 2
        print(f"Restoring {img_name}: text={text!r} chars={n_chars}")

        sr = out.sr[0].float().cpu().numpy()
        show_sr = postprocess_sr(sr, show_lq.shape[1])
        show_locs = draw_boxes(show_lq, locs[0], n_chars)
        priors = out.priors[0].float().cpu().numpy()
        collage = stack_collage(show_lq, show_locs, show_sr, priors, n_chars)
        out_name = f"{base}_{text.replace(os.sep, '_')}.png"
        write_png(os.path.join(save_path, out_name),
                  collage.astype(np.uint8))
        done.append((img_name, text, restores))
    return done


def main(argv=None) -> List[Tuple[str, str, int]]:
    args = parser().parse_args(argv)
    save_path = args.save_path
    if save_path is None:
        stamp = time.strftime("%m-%d_%H-%M", time.localtime())
        save_path = args.test_path.rstrip("/") + f"_{stamp}_MARCONetTorch"
    os.makedirs(save_path, exist_ok=True)

    # f32 parameters under the compute dtype, as tools/test_sr.py:77-79
    # builds its net over ``build_params``' f32 weights
    net = MARCONet(dtype=DTYPES[args.dtype], device=args.device)
    load_reference_or_random(net, args.ckpt_dir)
    frontend = None if args.manual else load_frontend(args.ckpt_dir,
                                                      args.device)
    done = restore_dir(net, frontend, args.test_path, save_path)
    print(f"Done. Results in {save_path}")
    return done


if __name__ == "__main__":
    main()
