"""The port's CLIs (``marconet_tpu_torch.cli.{test_sr, test_w,
serve_demo}``) against the JAX package's tools, run side by side.

Both run their ``main`` on the same directory of seeded PNG lines named
``<stem>_<text>.png``, with the same weights: one JAX init at
``width=0.0625`` (the JAX tools' ``MARCONet`` and ``build_params`` are
patched to return it; the port's CLIs get the same weights through
``convert.*_from_jax``) and, for the front-end, state dicts written to a
checkpoint directory that both packages load (``tests/yolo_oracle`` and
``tests/ocr_spec``). Everything runs on the CPU in f32 (the JAX package's
bf16 restore does not run on XLA:CPU; ``tests/test_torch_bf16.py``),
cv2's IPP layer off while the JAX tools run (``no_ipp``).

Outputs are compared as decoded pixels: f32 restores agree within atol
5e-3 on [-1, 1] (``tests/test_torch_pipeline.py``), which the tools
truncate to uint8, so a pixel may move by one level; the share that
does is bounded per tool below.
"""

import importlib
import os
import sys

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import marconet_tpu.models.pipeline as jpipeline
from marconet_tpu import serve as jserve
from marconet_tpu.models import frontend as jfrontend
from marconet_tpu_torch import convert, serve
from marconet_tpu_torch.alphabet import alphabet
from marconet_tpu_torch.cli import (
    common,
    eval_metrics,
    serve_demo,
    test_sr,
    test_w,
)
from marconet_tpu_torch.convert import (
    encoder_from_jax,
    prior_from_jax,
    srnet_from_jax,
)
from marconet_tpu_torch.models import frontend
from marconet_tpu_torch.models.pipeline import MARCONet
from marconet_tpu_torch.utils.png import read_png, write_png
from tests.ocr_spec import modelscope_ocr_state_spec
from tests.yolo_oracle import fabricate_yolo_sd

torch.set_num_threads(2)

WIDTH = 0.0625
TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
JaxMARCONet = jpipeline.MARCONet
# a tool's uint8 outputs may differ by one level on this share of pixels
# (the page server's bound, tests/test_torch_serve.py); measured over the
# tests below: one level on 7.3e-5 to 2.9e-4 of the pixels
MAX_LEVELS, MAX_SHARE = 1, 2e-3


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxMARCONet(width=WIDTH)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(5))
    as_np = jax.tree.map(np.asarray, params)
    net = MARCONet(width=WIDTH, device="cpu")
    net.encoder.load_state_dict(encoder_from_jax(as_np.encoder), strict=True)
    net.prior.load_state_dict(prior_from_jax(as_np.prior), strict=True)
    net.srnet.load_state_dict(srnet_from_jax(as_np.srnet), strict=True)
    return params, net


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    """Three seeded line PNGs of one size, texts from the alphabet's
    letters and digits (no path separators)."""
    d = tmp_path_factory.mktemp("lines")
    chars = [c for c in alphabet() if c.isalnum()]
    rng = np.random.default_rng(0)
    for i, n in enumerate((2, 4, 6)):
        text = "".join(chars[j] for j in rng.integers(0, 3000, n))
        img = rng.integers(0, 256, (48, 300, 3), dtype=np.uint8)
        write_png(str(d / f"line{i}_{text}.png"), img)
    return str(d)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Front-end checkpoints both packages load: YOLO only, and YOLO with
    the OCR recognizer."""
    yolo_sd = {k: torch.from_numpy(v) for k, v in
               fabricate_yolo_sd(np.random.default_rng(11)).items()}
    ocr_sd = {k: torch.from_numpy(v) for k, v in modelscope_ocr_state_spec(
        np.random.default_rng(7)).items()}
    dirs = {}
    for name, files in (("yolo", {"yolo11m_character_sd.pth": yolo_sd}),
                        ("yolo_ocr", {"yolo11m_character_sd.pth": yolo_sd,
                                      "ocr_convnext_sd.pth": ocr_sd})):
        d = tmp_path_factory.mktemp(name)
        for fname, sd in files.items():
            torch.save(sd, d / fname)
        dirs[name] = str(d)
    return dirs


@pytest.fixture
def jax_tools(monkeypatch, nets):
    """The JAX tools as modules, building the reduced-width nets with the
    fixture's weights instead of full-width random ones."""
    params, _ = nets
    monkeypatch.syspath_prepend(TOOLS)
    tools = {name: importlib.import_module(name)
             for name in ("test_sr", "test_w", "serve_demo")}
    monkeypatch.setattr(jpipeline, "MARCONet",
                        lambda dtype=jnp.float32, **kw:
                        JaxMARCONet(dtype=dtype, width=WIDTH))
    monkeypatch.setattr(tools["test_sr"], "build_params",
                        lambda net, ckpt_dir, rng_seed=0: params)
    return tools


def _run_jax(monkeypatch, tool, argv):
    monkeypatch.setattr(sys, "argv", [f"{tool.__name__}.py"] + argv)
    tool.main()


@pytest.fixture
def port_net(monkeypatch, nets):
    """The port's CLIs build the fixture's reduced-width net."""
    _, net = nets

    def factory(dtype=torch.float32, device="cuda"):
        assert dtype == torch.float32 and device == "cpu"
        return net

    for mod in (test_sr, test_w, serve_demo):
        monkeypatch.setattr(mod, "MARCONet", factory)
    return net


def _compare_dirs(got_dir, want_dir):
    """Equal PNG file names and shapes; returns the largest level
    difference and the share of pixels that differ."""
    got_names = sorted(n for n in os.listdir(got_dir) if n.endswith(".png"))
    want_names = sorted(n for n in os.listdir(want_dir)
                        if n.endswith(".png"))
    assert got_names == want_names
    diffs, total = [], 0
    for name in got_names:
        got = read_png(os.path.join(got_dir, name))
        want = cv2.cvtColor(cv2.imread(os.path.join(want_dir, name)),
                            cv2.COLOR_BGR2RGB)
        assert got.shape == want.shape, name
        d = np.abs(got.astype(int) - want.astype(int))
        diffs.append(d)
        total += d.size
    levels = max(int(d.max()) for d in diffs)
    share = sum(int((d > 0).sum()) for d in diffs) / total
    return levels, share


@pytest.mark.parametrize("mode", ["manual", "frontend", "encoder_ctc"])
def test_test_sr_matches_jax(monkeypatch, no_ipp, jax_tools, port_net,
                             lines, ckpts, tmp_path, mode):
    """The 4-row collages of ``-m`` (two restores a line, locs from the
    encoder), of the front-end with OCR, and of the front-end without OCR
    (text from the encoder's CTC head): same files, texts and pixels
    within one level on at most ``MAX_SHARE`` (measured: 9.7e-5, 1.4e-4
    and 1.3e-4 of the pixels)."""
    ckpt = {"manual": ckpts["yolo"], "frontend": ckpts["yolo_ocr"],
            "encoder_ctc": ckpts["yolo"]}[mode]
    flag = ["-m"] if mode == "manual" else []
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    _run_jax(monkeypatch, jax_tools["test_sr"],
             ["-i", lines, "-o", str(want_dir), "--ckpt_dir", ckpt] + flag)
    done = test_sr.main(["-i", lines, "-o", str(got_dir), "--ckpt_dir", ckpt,
                         "--device", "cpu"] + flag)
    assert len(done) == 3
    assert [r for _, _, r in done] == [2 if mode == "manual" else 1] * 3
    levels, share = _compare_dirs(str(got_dir), str(want_dir))
    assert levels <= MAX_LEVELS and share <= MAX_SHARE, (levels, share)
    for name in os.listdir(got_dir):
        assert read_png(str(got_dir / name)).shape[0] == 4 * 128


def test_test_w_matches_jax(monkeypatch, no_ipp, jax_tools, port_net,
                            lines, tmp_path):
    """The 11 blends: same names, pixels within one level on at most
    ``MAX_SHARE`` (measured: 2.8e-4); both write ``w.gif``, the port's
    with 11 frames of 100 ms, looping (``tests/test_torch_gif.py`` holds
    its palette error to imageio's)."""
    names = sorted(os.listdir(lines))
    w1, w2 = (os.path.join(lines, n) for n in names[:2])
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    _run_jax(monkeypatch, jax_tools["test_w"],
             ["-w1", w1, "-w2", w2, "-o", str(want_dir)])
    paths = test_w.main(["-w1", w1, "-w2", w2, "-o", str(got_dir),
                         "--device", "cpu"])
    assert len(paths) == test_w.STEPS == 11
    assert os.path.exists(want_dir / "w.gif")
    gif = Image.open(got_dir / "w.gif")
    assert gif.n_frames == 11 and gif.info["duration"] == 100 \
        and gif.info["loop"] == 0
    levels, share = _compare_dirs(str(got_dir), str(want_dir))
    assert levels <= MAX_LEVELS and share <= MAX_SHARE, (levels, share)


@pytest.mark.parametrize("manual", [True, False])
def test_serve_demo_matches_jax(monkeypatch, no_ipp, jax_tools, port_net,
                                lines, ckpts, tmp_path, manual):
    """Two passes over the lines repeated twice, f32: one SR line per
    request, texts equal (from the file names, or from the front-end),
    pixels within one level on at most ``MAX_SHARE`` (measured: 1.6e-4
    with ``-m``, 2.9e-4 with the front-end)."""
    flag = ["-m"] if manual else []
    argv = ["-i", lines, "--ckpt_dir", ckpts["yolo_ocr"], "--dtype",
            "float32", "--repeat", "2"] + flag
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    _run_jax(monkeypatch, jax_tools["serve_demo"],
             argv + ["-o", str(want_dir)])
    out = serve_demo.main(argv + ["-o", str(got_dir), "--device", "cpu"])
    assert len(out["results"]) == 6 and out["chunks"] == 1
    if manual:
        assert [r.text for r in out["results"]] == \
            [common.text_from_name(n) for n in out["names"]]
    levels, share = _compare_dirs(str(got_dir), str(want_dir))
    assert levels <= MAX_LEVELS and share <= MAX_SHARE, (levels, share)


def test_non_png_inputs_are_named_and_skipped(port_net, lines, tmp_path,
                                              capsys):
    """A JPEG and a BMP are read as cv2 reads them (they used to be
    skipped); a broken PNG and a GIF (a format cv2 reads and the port
    leaves out) are named in a warning and skipped by ``test_sr``;
    ``serve_demo`` takes .png / .jpg / .jpeg / .bmp names only, as the
    JAX tool does, and names the broken PNG."""
    d = tmp_path / "in"
    d.mkdir()
    for name in sorted(os.listdir(lines))[:1]:
        (d / name).write_bytes(open(os.path.join(lines, name), "rb").read())
    img = np.zeros((32, 64, 3), np.uint8)
    (d / "photo_AB.jpg").write_bytes(cv2.imencode(".jpg", img)[1].tobytes())
    (d / "scan_AB.bmp").write_bytes(cv2.imencode(".bmp", img)[1].tobytes())
    (d / "broken_AB.png").write_bytes(b"\x89PNG\r\n\x1a\nrest")
    Image.fromarray(img).save(d / "anim_AB.gif")
    done = test_sr.restore_dir(port_net, None, str(d), str(tmp_path))
    assert sorted(n for n, _, _ in done) == sorted(
        os.listdir(lines))[:1] + ["photo_AB.jpg", "scan_AB.bmp"]
    out = capsys.readouterr().out
    for name in ("anim_AB.gif", "broken_AB.png"):
        assert f"skipping {d / name}" in out, out
    assert "GIF" in out
    served = serve_demo.serve_dir(port_net, None, str(d), str(tmp_path))
    assert len(served["results"]) == 3
    out = capsys.readouterr().out
    assert f"skipping {d / 'broken_AB.png'}" in out and "anim_AB" not in out


@pytest.fixture(scope="module")
def other_formats(lines, tmp_path_factory):
    """The three lines as a JPEG, a BMP and a ``.jpeg`` (``mixed``), and
    all three as BMPs of the same pixels (``bmp``)."""
    mixed = tmp_path_factory.mktemp("mixed")
    bmp = tmp_path_factory.mktemp("bmp")
    for name, ext in zip(sorted(os.listdir(lines)), (".jpg", ".bmp",
                                                      ".jpeg")):
        stem = os.path.splitext(name)[0]
        bgr = cv2.imread(os.path.join(lines, name))
        cv2.imwrite(str(mixed / (stem + ext)), bgr,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        cv2.imwrite(str(bmp / (stem + ".bmp")), bgr)
    return {"mixed": str(mixed), "bmp": str(bmp)}


@pytest.mark.parametrize("tool", ["test_sr", "serve_demo"])
def test_jpeg_and_bmp_inputs_match_jax(monkeypatch, no_ipp, jax_tools,
                                       port_net, other_formats, tmp_path,
                                       tool):
    """JPEG, BMP and ``.jpeg`` lines through ``test_sr -m`` and
    ``serve_demo -m`` (f32): the JAX tools read them with cv2, the port
    with ``utils/imread.py``; same files, pixels within one level on at
    most ``MAX_SHARE``."""
    src = other_formats["mixed"]
    argv = ["-i", src, "-m"] + (["--dtype", "float32"]
                                if tool == "serve_demo" else [])
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    _run_jax(monkeypatch, jax_tools[tool], argv + ["-o", str(want_dir)])
    module = {"test_sr": test_sr, "serve_demo": serve_demo}[tool]
    out = module.main(argv + ["-o", str(got_dir), "--device", "cpu"])
    assert len(out if tool == "test_sr" else out["results"]) == 3
    levels, share = _compare_dirs(str(got_dir), str(want_dir))
    assert levels <= MAX_LEVELS and share <= MAX_SHARE, (levels, share)


@pytest.mark.parametrize("tool", ["test_sr", "serve_demo"])
def test_bmp_outputs_equal_png_outputs(port_net, lines, other_formats,
                                       tmp_path, tool):
    """The same pixels as BMP and as PNG give the same output files, byte
    for byte."""
    module = {"test_sr": test_sr, "serve_demo": serve_demo}[tool]
    extra = ["--dtype", "float32"] if tool == "serve_demo" else []
    for fmt, src in (("png", lines), ("bmp", other_formats["bmp"])):
        module.main(["-i", src, "-o", str(tmp_path / fmt), "-m",
                     "--device", "cpu"] + extra)
    names = sorted(os.listdir(tmp_path / "png"))
    assert names == sorted(os.listdir(tmp_path / "bmp")) and len(names) == 3
    for name in names:
        assert (tmp_path / "png" / name).read_bytes() == \
            (tmp_path / "bmp" / name).read_bytes(), name


def test_eval_metrics_reads_jpeg_and_bmp(no_ipp, other_formats, monkeypatch,
                                         capsys, tmp_path):
    """``eval_metrics`` over JPEG and BMP files gives the JAX tool's lines
    (its pairs resized by cv2's uint8 ``INTER_CUBIC`` where the sizes
    differ)."""
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    a_dir.mkdir()
    b_dir.mkdir()
    rng = np.random.default_rng(12)
    for i, ext in enumerate((".jpg", ".bmp", ".jpeg")):
        a = rng.integers(0, 256, (40, 90 + 7 * i, 3), np.uint8)
        b = np.clip(a.astype(int) + rng.integers(-25, 26, a.shape), 0, 255)
        b = cv2.resize(b.astype(np.uint8), (80, 36)) if i == 2 else b
        cv2.imwrite(str(a_dir / f"l{i}{ext}"), a)
        cv2.imwrite(str(b_dir / f"l{i}{ext}"), b.astype(np.uint8))
    argv = ["-a", str(a_dir), "-b", str(b_dir), "--y_channel"]
    monkeypatch.syspath_prepend(TOOLS)
    tool = importlib.import_module("eval_metrics")
    monkeypatch.setattr(sys, "argv", ["eval_metrics.py"] + argv)
    tool.main()
    want = capsys.readouterr().out.splitlines()
    psnrs, _ = eval_metrics.main(argv)
    assert capsys.readouterr().out.splitlines() == want
    assert len(psnrs) == 3


def test_page_server_with_frontend_matches_jax(no_ipp, nets, ckpts):
    """``TextPageRestorer`` with the port's ``CharacterFrontend``, on lines
    without text and on a page whose over-wide line, given no text, is
    detected per segment: texts and pixels as the JAX server with the JAX
    front-end (pixels: one level on 2.3e-4 and 7.3e-5)."""
    params, net = nets
    jfe = jfrontend.CharacterFrontend.from_checkpoints(ckpts["yolo_ocr"])
    pfe = frontend.CharacterFrontend.from_checkpoints(ckpts["yolo_ocr"],
                                                      device="cpu")
    jnet = JaxMARCONet(width=WIDTH)
    rng = np.random.default_rng(4)
    page = rng.integers(0, 256, (200, 1400, 3), dtype=np.uint8)
    boxes = [(0, 0, 300, 48), (0, 100, 1400, 148)]   # the second: 2 parts
    want = jserve.TextPageRestorer(jnet, params, frontend=jfe,
                                   buckets=(4,)).restore_page(page, boxes)
    got = serve.TextPageRestorer(net, frontend=pfe,
                                 buckets=(4,)).restore_page(page, boxes)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.text == w.text and g.sr.shape == w.sr.shape
        d = np.abs(g.sr.astype(int) - w.sr.astype(int))
        assert d.max() <= MAX_LEVELS and (d > 0).mean() <= MAX_SHARE
    # 2 segments of 700 px at h=48, each shown at h=128
    assert got[1].sr.shape[1] == 2 * round(700 * 128 / 48)


def test_reference_checkpoints_match_jax_loader(tmp_path):
    """``load_reference_checkpoints`` over ``torch.save``d reference state
    dicts (full width, ``tests/torch_functional_oracle``) gives the
    weights the JAX loader converts; ``load_reference_or_random`` loads
    them, and with a file missing keeps the random weights and warns
    without naming a download tool."""
    from marconet_tpu.convert import load_reference_checkpoints
    from tests import torch_functional_oracle as oracle

    rng = np.random.default_rng(0)
    states = {"net_transformer_encoder.pth": oracle.build_encoder_state(rng),
              "net_prior_generation.pth": oracle.build_prior_state(rng),
              "net_sr.pth": oracle.build_srnet_state(rng)}
    for name, sd in states.items():
        torch.save({"params": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, tmp_path / name)
    want = load_reference_checkpoints(str(tmp_path))
    net = MARCONet(device="cpu")
    assert convert.load_reference_or_random(net, str(tmp_path))
    for module, from_jax, jvars in (
            (net.encoder, encoder_from_jax, want.encoder),
            (net.prior, prior_from_jax, want.prior),
            (net.srnet, srnet_from_jax, want.srnet)):
        ref = from_jax(jax.tree.map(np.asarray, jvars))
        for k, v in module.state_dict().items():
            torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
    os.remove(tmp_path / "net_sr.pth")
    fresh = MARCONet(device="cpu", seed=3)
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    assert not convert.load_reference_or_random(fresh, str(tmp_path))
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_parsers_keep_the_jax_flags():
    """Flags and defaults of the JAX tools, plus ``--device cuda``."""
    sr = test_sr.parser().parse_args([])
    assert (sr.test_path, sr.save_path, sr.manual, sr.ckpt_dir, sr.dtype,
            sr.device) == ("./Testsets/LQs", None, False, "./checkpoints",
                           "float32", "cuda")
    w = test_w.parser().parse_args([])
    assert (w.w1_path, w.w2_path, w.save_path, w.ckpt_dir, w.device) == (
        "./Testsets/TestW/w1.png", "./Testsets/TestW/w2.png",
        "./Testsets/TestW", "./checkpoints", "cuda")
    sd = serve_demo.parser().parse_args(["-i", "a", "-o", "b"])
    assert (sd.manual, sd.ckpt_dir, sd.dtype, sd.repeat, sd.device) == (
        False, "./checkpoints", "bfloat16", 1, "cuda")
    with pytest.raises(SystemExit):
        serve_demo.parser().parse_args([])
