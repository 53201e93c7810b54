"""The port's background-patch miner (``marconet_tpu_torch.cli.
crop_bg_patches``) against the JAX package's ``tools/crop_bg_patches.py``.

Both mine the same seeded images with the same seeds: the port's patches
must be the JAX tool's, byte for byte and in the same order (the JAX tool
works on cv2's BGR image, the port on RGB: the channels are reversed).
Its pieces are held to cv2 alone: the gray image to ``cv2.cvtColor``, the
Sobel score to the JAX tool's ``sobel_score``, the uint8 ``INTER_AREA``
resize at 0.75 and 0.5 to ``cv2.resize`` (exact sizes and sizes that do
not divide). The JAX tool runs with cv2 as it is (IPP on), as it would
for a user.
"""

import os
import sys

import cv2
import numpy as np
import pytest

from marconet_tpu_torch.cli import crop_bg_patches as port
from marconet_tpu_torch.utils.image import resize_area_u8
from marconet_tpu_torch.utils.png import read_png

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


@pytest.fixture(scope="module")
def jax_tool():
    sys.path.insert(0, TOOLS)
    try:
        import crop_bg_patches
    finally:
        sys.path.remove(TOOLS)
    return crop_bg_patches


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    """Blurred noise with sharper patches: scores differ between crops."""
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                           (0, 0), 3)
    for _ in range(6):
        y, x = rng.integers(0, h - 60), rng.integers(0, w - 60)
        img[y:y + 60, x:x + 60] = rng.integers(0, 256, (60, 60, 3))
    return img


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", [(270, 301), (217, 350)])
def test_patches_match_jax(jax_tool, shape, seed):
    rgb = _photo(*shape, seed=shape[0])
    want = jax_tool.mine_patches(rgb[..., ::-1].copy(), 100, 2,
                                 np.random.default_rng(seed))
    got = port.mine_patches(rgb, 100, 2, np.random.default_rng(seed))
    assert len(got) == len(want) == 6          # 2 a scale, 3 scales
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[..., ::-1])


def test_gray_and_score_match_cv2(jax_tool):
    rgb = _photo(64, 77, 5)
    gray = port.gray_u8(rgb)
    np.testing.assert_array_equal(
        gray, cv2.cvtColor(rgb[..., ::-1].copy(), cv2.COLOR_BGR2GRAY))
    assert port.sobel_score(gray) == jax_tool.sobel_score(gray)


@pytest.mark.parametrize("factor", [1.0, 0.75, 0.5])
@pytest.mark.parametrize("shape", [(900, 1200), (37, 51), (601, 803),
                                   (100, 7)])
def test_area_resize_matches_cv2(shape, factor):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,),
                                                     dtype=np.uint8)
    want = cv2.resize(img, (0, 0), fx=factor, fy=factor,
                      interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(resize_area_u8(img, factor), want)


def test_cli_writes_the_jax_tools_files(jax_tool, tmp_path, monkeypatch):
    src = tmp_path / "hr"
    src.mkdir()
    cv2.imwrite(str(src / "a.png"), _photo(230, 260, 7))
    cv2.imwrite(str(src / "b.jpg"), _photo(240, 250, 8))
    (src / "notes.txt").write_text("not an image\n")
    flags = ["--patch", "96", "--per_scale", "1", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["crop_bg_patches.py", "-i", str(src),
                                      "-o", str(tmp_path / "jax")] + flags)
    jax_tool.main()
    paths = port.main(["-i", str(src), "-o", str(tmp_path / "port")]
                      + flags)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert [os.path.basename(p) for p in paths] == names
    assert len(names) == 6
    for name in names:
        want = cv2.imread(str(tmp_path / "jax" / name))[..., ::-1]
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "port" / name)), want)


def test_parser_keeps_the_jax_flags():
    args = port.parser().parse_args(["-i", "a", "-o", "b"])
    assert (args.input_dir, args.output_dir, args.patch, args.per_scale,
            args.seed) == ("a", "b", 400, 2, 0)
    with pytest.raises(SystemExit):
        port.parser().parse_args([])
