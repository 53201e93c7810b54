"""The port's parity kit (``marconet_tpu_torch.cli.parity_report``) against
the JAX package's (``tools/parity_report.py``).

As ``tests/test_parity_kit.py`` rehearses the JAX kit: checkpoints with
the released key layout, fabricated from a seed
(``tests/torch_functional_oracle.py::build_*_state``), and a testset of
two lines, a PNG and a JPEG, run twice: without ``--ref_outputs`` (strict
load, the double restore, goldens recorded; verdict
``NO_REFERENCE_OUTPUTS``) and against the first run's goldens (verdict
``PARITY``). Then the port's SR bands are held to the JAX kit's
``restore_testset`` on the same files and checkpoints, f32 on the CPU:
PSNR at least 45 dB, the drift gate of ``tests/test_golden.py``
(measured: 88.49 dB for the PNG line and 89.68 dB for the JPEG line,
largest differences 0.137 and 0.066 of a level on 0..255).
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from marconet_tpu_torch.cli import parity_report
from marconet_tpu_torch.utils.image import calculate_psnr
from marconet_tpu_torch.utils.png import read_png
from tests.torch_functional_oracle import (
    build_encoder_state,
    build_prior_state,
    build_srnet_state,
)

DRIFT_GATE_DB = 45.0
LINES = ("line_01_AB.png", "line_02_xY7.jpg")


@pytest.fixture(scope="module")
def kit(tmp_path_factory):
    root = tmp_path_factory.mktemp("kit")
    rng = np.random.default_rng(3)
    ckpt_dir = root / "ckpts"
    ckpt_dir.mkdir()
    for name, builder in (("net_transformer_encoder.pth",
                           build_encoder_state),
                          ("net_prior_generation.pth", build_prior_state),
                          ("net_sr.pth", build_srnet_state)):
        sd = {k: torch.from_numpy(np.asarray(v, np.float32))
              for k, v in builder(rng).items()}
        torch.save({"params": sd}, ckpt_dir / name)
    testset = root / "testset"
    testset.mkdir()
    for name in LINES:
        img = rng.integers(40, 220, (40, 200, 3), np.uint8)
        cv2.imwrite(str(testset / name), img)
    return {"root": root, "ckpt_dir": str(ckpt_dir),
            "testset": str(testset)}


@pytest.fixture(scope="module")
def runs(kit):
    """The port's kit run twice, on the CPU; the first run's SR bands are
    kept for the comparison with the JAX kit."""
    golden_dir = kit["root"] / "goldens"
    common = ["--ckpt_dir", kit["ckpt_dir"], "--testset", kit["testset"],
              "--golden_dir", str(golden_dir), "--device", "cpu"]
    restored = []
    restore = parity_report.restore_testset
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parity_report, "restore_testset",
                   lambda *a: restored.append(restore(*a)) or restored[-1])
        first = kit["root"] / "report1.json"
        parity_report.main(common + ["--report", str(first)])
        second = kit["root"] / "report2.json"
        parity_report.main(common + ["--report", str(second),
                                     "--ref_outputs", str(golden_dir)])
    return {"golden_dir": golden_dir, "bands": restored[0],
            "reports": [json.loads(p.read_text()) for p in (first, second)]}


def test_verdicts_as_the_jax_kit_gives_them(runs):
    rep1, rep2 = runs["reports"]
    stems = sorted(os.path.splitext(n)[0] for n in LINES)
    assert rep1["verdict"] == "NO_REFERENCE_OUTPUTS" and rep1["images"] == {}
    assert sorted(os.listdir(runs["golden_dir"])) == \
        [s + ".png" for s in stems]
    for s in stems:
        band = read_png(str(runs["golden_dir"] / f"{s}.png"))
        assert band.shape == (128, 2048, 3)
    assert rep2["verdict"] == "PARITY"
    assert sorted(rep2["images"]) == stems
    assert rep2["mean_psnr_vs_reference"] >= 40.0
    assert set(rep2) == {"ckpt_dir", "images", "verdict",
                         "mean_psnr_vs_reference"}


def test_sr_bands_match_the_jax_kit(kit, runs):
    import tools.parity_report as jax_kit

    want = jax_kit.restore_testset(kit["ckpt_dir"], kit["testset"])
    got = runs["bands"]
    assert sorted(got) == sorted(want) == sorted(
        os.path.splitext(n)[0] for n in LINES)
    for stem in got:
        assert got[stem]["n_chars"] == want[stem]["n_chars"]
        assert got[stem]["ori_w"] == want[stem]["ori_w"]
        psnr = calculate_psnr(got[stem]["sr"], want[stem]["sr"])
        diff = np.abs(got[stem]["sr"] - want[stem]["sr"]).max()
        print(f"{stem}: PSNR {psnr:.2f} dB, max diff {diff:.4f} levels")
        assert psnr >= DRIFT_GATE_DB, (stem, psnr, diff)


def test_missing_checkpoints_stop_the_report(tmp_path):
    with pytest.raises(SystemExit, match="net_sr.pth"):
        parity_report.main(["--ckpt_dir", str(tmp_path), "--device", "cpu"])


def test_parser_keeps_the_jax_flags():
    """The JAX kit's flags and defaults (its testset default is a path of
    the machine it was written on), plus ``--device cuda``."""
    args = parity_report.parser().parse_args([])
    assert (args.ckpt_dir, args.ref_outputs, args.report, args.psnr_gate,
            args.golden_dir, args.device) == (
        "checkpoints", None, "parity_report.json", 40.0, None, "cuda")
