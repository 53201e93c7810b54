"""One-command numerical parity verdict against the released checkpoints
(counterpart of ``tools/parity_report.py``).

Run where the released ``.pth`` files are::

    python -m marconet_tpu_torch.cli.parity_report --ckpt_dir checkpoints \\
        [--testset Testsets/LQsWithText] \\
        [--ref_outputs <dir of reference test_sr.py outputs>] \\
        [--report parity_report.json] [--device cpu]

Steps, as in the JAX tool:

1. load the three released checkpoints strictly
   (``convert.load_reference_checkpoints``: a missing, renamed or extra
   key fails the report at once);
2. restore every ``.png`` / ``.jpg`` / ``.jpeg`` / ``.bmp`` line of the
   testset in manual-label mode (the text after the file name's last
   ``_``, the encoder's own locs: two restores a line), f32;
3. record each SR band as ``<golden_dir>/<stem>.png`` (by default
   ``tests/goldens_torch/`` of this repository, beside the JAX package's
   ``tests/goldens/``);
4. with ``--ref_outputs``, compare each SR band against the reference's
   output whose name starts with the line's stem (a raw SR image, or the
   third 128-row band of the reference's 4-row collage) and give the
   verdict ``PARITY`` when the mean PSNR reaches ``--psnr_gate``, else
   ``DIVERGED``; without it the verdict is ``NO_REFERENCE_OUTPUTS``.

Prints a line a step and writes the JSON report (``ckpt_dir``, ``images``
with each line's ``psnr_vs_reference``, ``mean_psnr_vs_reference``,
``verdict``) in the JAX tool's schema.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from marconet_tpu_torch.alphabet import labels_from_text
from marconet_tpu_torch.cli.common import IMAGE_EXTENSIONS, read_image
from marconet_tpu_torch.convert import (
    REFERENCE_FILES,
    load_reference_checkpoints,
)
from marconet_tpu_torch.models.encoder import MAX_CHARS
from marconet_tpu_torch.models.pipeline import BLANK_INDEX, MARCONet
from marconet_tpu_torch.utils.image import calculate_psnr, preprocess_line
from marconet_tpu_torch.utils.png import write_png

BAND = 128                # rows of one band of the reference's collage
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def restore_testset(net: MARCONet, testset: str) -> Dict[str, dict]:
    """Manual-label double restore of every line image in ``testset``:
    {stem: {"sr": (128, 2048, 3) float64 on 0..255, "ori_w", "n_chars"}}."""
    results = {}
    for name in sorted(os.listdir(testset)):
        base, ext = os.path.splitext(name)
        if ext.lower() not in IMAGE_EXTENSIONS:
            continue
        img = read_image(os.path.join(testset, name))
        if img is None:
            continue
        pre = preprocess_line(img)
        if pre is None:
            print(f"  skip {name}: wider than 512 after resize")
            continue
        lq, _, ori_w = pre
        labels_list = [l for l in labels_from_text(base.split("_")[-1])
                       if l >= 0][:MAX_CHARS]
        n = len(labels_list)
        if n == 0:
            continue
        labels = np.full((1, MAX_CHARS), BLANK_INDEX, np.int64)
        labels[0, :n] = labels_list
        mask = np.zeros((1, MAX_CHARS), np.float32)
        mask[0, :n] = 1.0
        locs = np.zeros((1, 2 * MAX_CHARS), np.float32)

        def restore():
            return net.restore(*map(torch.from_numpy,
                                    (lq, labels, locs, mask)))

        pred = restore().pred_locs[0].float().cpu().numpy()
        locs[0, :2 * n] = pred[:2 * n]
        sr = restore().sr[0].float().cpu().numpy()
        results[base] = {"sr": np.clip(sr * 0.5 + 0.5, 0, 1) * 255.0,
                         "ori_w": ori_w, "n_chars": n}
    return results


def reference_sr_band(path: str) -> Optional[np.ndarray]:
    """A reference output's SR pixels (float64): a raw SR image as it is,
    the third band of a 4-row collage (4 x 128 rows)."""
    img = read_image(path)
    if img is None:
        return None
    if img.shape[0] == 4 * BAND:
        img = img[2 * BAND:3 * BAND]
    return img.astype(np.float64)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt_dir", default="checkpoints")
    p.add_argument("--testset", default="Testsets/LQsWithText")
    p.add_argument("--ref_outputs", default=None,
                   help="directory of reference test_sr.py outputs (raw SR "
                        "images or 4-row collages)")
    p.add_argument("--report", default="parity_report.json")
    p.add_argument("--psnr_gate", type=float, default=40.0)
    p.add_argument("--golden_dir", default=None,
                   help="where to record goldens (default: "
                        "tests/goldens_torch of this repository)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the networks run (cuda or cpu)")
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    missing = [n for n in REFERENCE_FILES
               if not os.path.exists(os.path.join(args.ckpt_dir, n))]
    if missing:
        raise SystemExit(f"checkpoints missing under {args.ckpt_dir}: "
                         f"{missing}; fetch them with "
                         "tools/download_checkpoints.py")

    print("1/3 strict-loading checkpoints + restoring testset ...")
    net = MARCONet(device=args.device)
    load_reference_checkpoints(args.ckpt_dir, net)
    results = restore_testset(net, args.testset)
    print(f"    restored {len(results)} images")

    report = {"ckpt_dir": args.ckpt_dir, "images": {}, "verdict": None}
    golden_dir = args.golden_dir or os.path.join(REPO, "tests",
                                                 "goldens_torch")
    os.makedirs(golden_dir, exist_ok=True)
    for base, r in results.items():
        write_png(os.path.join(golden_dir, f"{base}.png"),
                  r["sr"].astype(np.uint8))
    print(f"2/3 goldens recorded under {golden_dir}")

    if args.ref_outputs and os.path.isdir(args.ref_outputs):
        psnrs = []
        ref_names = sorted(os.listdir(args.ref_outputs))
        for base, r in results.items():
            match = [n for n in ref_names if n.startswith(base)]
            ref = None if not match else reference_sr_band(
                os.path.join(args.ref_outputs, match[0]))
            if ref is None:
                print(f"    no reference output for {base}")
                continue
            ours = r["sr"][:, :ref.shape[1]]
            ref = ref[:, :ours.shape[1]]
            p = calculate_psnr(ours, ref)
            psnrs.append(p)
            report["images"][base] = {"psnr_vs_reference": round(p, 2)}
            print(f"    {base}: PSNR vs reference {p:.2f} dB")
        if psnrs:
            mean_psnr = float(np.mean(psnrs))
            report["mean_psnr_vs_reference"] = round(mean_psnr, 2)
            report["verdict"] = ("PARITY" if mean_psnr >= args.psnr_gate
                                 else "DIVERGED")
            print(f"3/3 verdict: {report['verdict']} "
                  f"(mean {mean_psnr:.2f} dB, gate {args.psnr_gate})")
    else:
        report["verdict"] = "NO_REFERENCE_OUTPUTS"
        print("3/3 no --ref_outputs given: goldens recorded; rerun the "
              "reference's test_sr.py and pass its output dir for the "
              "cross-implementation verdict")

    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    print(f"report written to {args.report}")
    return report


if __name__ == "__main__":
    main()
