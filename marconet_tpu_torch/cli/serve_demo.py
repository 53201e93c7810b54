"""Service-mode demo (counterpart of ``tools/serve_demo.py``): the page
server (``TextPageRestorer``: segment splitting, a row cap and slot
buckets) over a directory of line crops, end to end, with lines/s.

With ``-m`` the text comes from the file name after its last ``_``;
otherwise the YOLO + OCR front-end reads it when its weights are under
``--ckpt_dir`` (without them the tool falls back to ``-m``).

Example::

    python -m marconet_tpu_torch.cli.serve_demo -i Testsets/LQsWithText \\
        -o /tmp/serve_out -m --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

from marconet_tpu_torch.cli.common import (
    DTYPES,
    IMAGE_EXTENSIONS,
    load_frontend,
    read_image,
    text_from_name,
)
from marconet_tpu_torch.convert import load_reference_or_random
from marconet_tpu_torch.models.pipeline import MARCONet
from marconet_tpu_torch.serve import LineRequest, TextPageRestorer
from marconet_tpu_torch.utils.png import write_png


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-i", "--test_path", required=True)
    p.add_argument("-o", "--save_path", required=True)
    p.add_argument("-m", "--manual", action="store_true",
                   help="take GT text from the filename suffix")
    p.add_argument("--ckpt_dir", type=str, default="./checkpoints")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=list(DTYPES))
    p.add_argument("--repeat", type=int, default=1,
                   help="duplicate the request list N times "
                        "(throughput demo)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the networks run (cuda or cpu)")
    return p


def serve_dir(net: MARCONet, frontend, test_path: str, save_path: str,
              repeat: int = 1) -> dict:
    """Restore every PNG, JPEG or BMP line in ``test_path`` twice through
    the page server (the first pass includes warm-up) and write the second
    pass's lines as ``<index>_<stem>.png``; texts from the file names when
    ``frontend`` is None. Returns the results and both passes' times."""
    requests, names = [], []
    for fname in sorted(os.listdir(test_path)):
        if not fname.lower().endswith(IMAGE_EXTENSIONS):
            continue
        img = read_image(os.path.join(test_path, fname))
        if img is None:
            continue
        text = text_from_name(fname) if frontend is None else None
        requests.append(LineRequest(image=img, text=text))
        names.append(fname)
    if not requests:
        print(f"no images in {test_path}")
        return {"results": [], "names": [], "chunks": 0}
    requests, names = requests * repeat, names * repeat

    server = TextPageRestorer(net, frontend=frontend)
    t0 = time.perf_counter()
    server.restore_lines(requests)           # warm-up included
    first = time.perf_counter() - t0
    chunks = server.chunks
    t0 = time.perf_counter()
    results = server.restore_lines(requests)
    warm = time.perf_counter() - t0

    for i, (name, res) in enumerate(zip(names, results)):
        stem = os.path.splitext(name)[0]
        write_png(os.path.join(save_path, f"{i:03d}_{stem}.png"), res.sr)
        print(f"{name}: text='{res.text}' sr={res.sr.shape}")
    n = len(requests)
    print(f"{n} lines: first pass {first:.2f}s = {n / first:.1f} lines/s "
          f"(incl. warm-up), warm {warm:.2f}s = {n / warm:.1f} lines/s")
    return {"results": results, "names": names, "first_s": first,
            "warm_s": warm, "lines_per_s": n / warm,
            "chunks": server.chunks - chunks}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    os.makedirs(args.save_path, exist_ok=True)
    # f32 parameters under the compute dtype, as tools/serve_demo.py:48-49
    # builds its net over ``build_params``' f32 weights
    net = MARCONet(dtype=DTYPES[args.dtype], device=args.device)
    load_reference_or_random(net, args.ckpt_dir)
    frontend = None if args.manual else load_frontend(args.ckpt_dir,
                                                      args.device)
    return serve_dir(net, frontend, args.test_path, args.save_path,
                     args.repeat)


if __name__ == "__main__":
    main()
