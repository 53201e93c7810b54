"""The port's ``cli/eval_metrics.py`` beside the JAX package's
``tools/eval_metrics.py`` on seeded PNGs written by the port's codec:
the same PSNR / SSIM lines and means, with and without ``--y_channel``
and ``--border``, including a pair of different sizes (the second image
resized by OpenCV's uint8 ``INTER_CUBIC``, IPP off, in the JAX tool; by
``utils/image.resize_cubic_u8`` in the port). A file that is no image is
skipped by both."""

import importlib
import os
import sys

import cv2
import numpy as np
import pytest

from marconet_tpu_torch.cli import eval_metrics
from marconet_tpu_torch.utils import image as timage
from marconet_tpu_torch.utils.png import write_png
from tests.test_torch_degrade import no_ipp  # noqa: F401  (fixture)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
# (name, shape of a, shape of b)
PAIRS = [("line_0.png", (40, 96, 3), (40, 96, 3)),
         ("line_1.png", (32, 128, 3), (32, 128, 3)),
         ("line_2.png", (48, 80, 3), (31, 57, 3)),
         ("wide.png", (64, 200, 3), (64, 200, 3))]


@pytest.fixture
def dirs(tmp_path):
    rng = np.random.default_rng(4)
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    a_dir.mkdir()
    b_dir.mkdir()
    for name, sa, sb in PAIRS:
        a = rng.integers(0, 256, sa, dtype=np.uint8)
        b = np.clip(cv2.resize(a, (sb[1], sb[0])).astype(np.int16)
                    + rng.integers(-20, 21, sb), 0, 255).astype(np.uint8)
        write_png(str(a_dir / name), a)
        write_png(str(b_dir / name), b)
    (a_dir / "notes.txt").write_text("not an image")
    (b_dir / "notes.txt").write_text("not an image")
    (a_dir / "only_a.png").write_bytes((a_dir / "line_0.png").read_bytes())
    return str(a_dir), str(b_dir)


@pytest.mark.parametrize("flags", [[], ["--y_channel"],
                                   ["--border", "4"],
                                   ["--y_channel", "--border", "2"]])
def test_same_lines_as_the_jax_tool(no_ipp, dirs, monkeypatch, capsys,
                                    flags):
    a_dir, b_dir = dirs
    argv = ["-a", a_dir, "-b", b_dir] + flags
    monkeypatch.syspath_prepend(TOOLS)
    tool = importlib.import_module("eval_metrics")
    monkeypatch.setattr(sys, "argv", ["eval_metrics.py"] + argv)
    tool.main()
    want = capsys.readouterr().out.splitlines()
    psnrs, ssims = eval_metrics.main(argv)
    got = capsys.readouterr().out.splitlines()
    warnings = [line for line in got if line.startswith("WARNING")]
    assert len(warnings) == 2 and all("notes.txt" in w for w in warnings)
    assert [line for line in got if not line.startswith("WARNING")] == want
    assert len(psnrs) == len(ssims) == len(PAIRS)
    assert want[-1].startswith(f"mean over {len(PAIRS)} images")


def test_resize_to_a_size_is_opencvs(no_ipp):
    """``resize_cubic_u8(img, size=...)`` is ``cv2.resize(img, size,
    INTER_CUBIC)`` for uint8, to the byte, enlarging, shrinking and
    mixed."""
    rng = np.random.default_rng(6)
    for (h, w), size in [((31, 57), (80, 48)), ((48, 80), (57, 31)),
                         ((40, 96), (150, 20)), ((7, 5), (5, 9))]:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)
        np.testing.assert_array_equal(timage.resize_cubic_u8(img, size=size),
                                      want)


def test_refuses_directories_without_common_files(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    with pytest.raises(SystemExit, match="no common files"):
        eval_metrics.main(["-a", str(tmp_path / "a"), "-b",
                           str(tmp_path / "b")])
