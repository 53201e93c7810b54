"""Import hygiene of the port: ``marconet_tpu_torch`` runs on machines
without JAX, cv2, PIL, PyYAML, TensorBoard or a font library, so no module
of it (nor ``chip_smoke.py`` or the ``cuda``-marked tests) may import
``jax``, ``flax``, ``optax``, ``cv2``, ``PIL``, ``imageio``, ``yaml``,
``tensorboard``, ``tensorboardX``, ``fontTools``, ``matplotlib`` or
``freetype``, or any ``marconet_tpu`` module (the port keeps its own
copies of the framework-free ``alphabet`` and ``version``). Checked on
the source (AST), for every module, and in a fresh interpreter."""

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "marconet_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "cv2", "PIL",
                   "imageio", "yaml", "tensorboard", "tensorboardX",
                   "fontTools", "matplotlib", "freetype"}
ALLOWED_JAX_PKG: set = set()
MODULES = sorted(PKG.rglob("*.py"))


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            # ``from marconet_tpu import x`` imports submodule x too
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


def test_package_has_modules():
    names = {p.relative_to(PKG).as_posix() for p in MODULES}
    assert {"ops/fused_act.py", "ops/sft_writeback.py", "convert.py",
            "models/pipeline.py", "alphabet.py", "version.py",
            "train/train_step.py", "train/losses.py", "train/lpips.py",
            "train/discriminators.py", "train/checkpoint.py",
            "data/batch_prep.py", "ops/conv3x3.py", "serve.py",
            "utils/image.py", "utils/png.py", "models/yolo.py",
            "models/convnext_ocr.py", "models/frontend.py",
            "cli/__init__.py", "cli/common.py", "cli/test_sr.py",
            "cli/test_w.py", "cli/serve_demo.py", "utils/yaml_lite.py",
            "data/imutils.py", "data/synth.py", "data/degrade/__init__.py",
            "data/degrade/kernels.py", "data/degrade/noise.py",
            "data/degrade/camera_isp.py", "data/degrade/diffjpeg.py",
            "data/degrade/realesrgan.py", "data/degrade/bsrgan.py",
            "train/config.py", "train/events.py", "train/visuals.py",
            "train/loop.py", "cli/train.py", "parallel/__init__.py",
            "parallel/distributed.py", "dryrun.py", "registry.py",
            "data/val_stub.py", "data/degrade/paired.py",
            "models/legacy_ocr.py", "cli/eval_metrics.py", "utils/jpeg.py",
            "utils/bmp.py", "utils/imread.py", "utils/gif.py",
            "cli/parity_report.py", "cli/crop_bg_patches.py",
            "cli/profile_sr.py"} <= names


@pytest.mark.parametrize("name", ["common", "test_sr", "test_w",
                                  "serve_demo", "train", "eval_metrics",
                                  "parity_report", "crop_bg_patches",
                                  "profile_sr"])
def test_cli_reads_and_writes_without_cv2(name):
    """The CLIs replace the JAX tools' cv2 reads and writes and imageio's
    GIF with the port's PNG codec (and ``train`` the YAML and TensorBoard
    packages with the port's reader and writer): neither they nor the
    modules they load in a fresh interpreter import cv2, PIL, imageio,
    yaml or tensorboard."""
    import subprocess
    import sys

    code = ("import sys\n"
            f"import marconet_tpu_torch.cli.{name}\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('cv2', 'PIL', 'imageio',\n"
            "                                    'yaml', 'tensorboard',\n"
            "                                    'tensorboardX'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", MODULES,
                         ids=[p.relative_to(PKG).as_posix() for p in MODULES])
def test_module_imports_no_jax(path):
    bad = []
    for name in _imports(path):
        root = name.split(".")[0]
        if root in FORBIDDEN_ROOTS:
            bad.append(name)
        elif root == "marconet_tpu" and name not in ALLOWED_JAX_PKG:
            bad.append(name)
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("name", ["chip_smoke.py",
                                  "tests/test_torch_cuda.py",
                                  "tests/test_torch_cuda_nets.py"])
def test_chip_smoke_imports_no_jax_package(name):
    """What runs on the card's machine (the kernel smoke and the
    ``cuda``-marked tests, run there with ``--noconftest``) takes
    everything from the port: it may not name any ``marconet_tpu``
    module, not even the framework-free ones, nor cv2 or PIL, nor a
    ``tests`` helper, which may import them."""
    bad = [mod for mod in _imports(PKG.parent / name)
           if mod.split(".")[0] in FORBIDDEN_ROOTS | {"marconet_tpu",
                                                      "tests"}]
    assert not bad, f"{name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    """The same property at run time, in a fresh interpreter: no JAX, cv2
    or PIL and no module of the JAX package gets loaded, by the port or
    by ``chip_smoke.py``."""
    import subprocess
    import sys

    mods = [".".join(("marconet_tpu_torch",) + p.relative_to(PKG)
                     .with_suffix("").parts).removesuffix(".__init__")
            for p in MODULES]
    roots = tuple(sorted(FORBIDDEN_ROOTS | {"marconet_tpu"}))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {roots!r})\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_alphabet_matches_the_jax_package():
    """The port's own copy of the alphabet is the JAX package's."""
    from marconet_tpu import alphabet as jax_alphabet
    from marconet_tpu_torch import alphabet

    assert alphabet.alphabet() == jax_alphabet.ALPHABET
    assert alphabet.BLANK_INDEX == jax_alphabet.BLANK_INDEX
    assert alphabet.NUM_CLASSES == jax_alphabet.NUM_CLASSES
    labels = [0, 17, 6734, jax_alphabet.BLANK_INDEX, 3]
    assert alphabet.text_from_labels(labels) == \
        jax_alphabet.text_from_labels(labels)
    with pytest.raises(ValueError):
        alphabet.text_from_labels([6736])


def test_version_matches_the_jax_package():
    import marconet_tpu
    import marconet_tpu_torch

    assert marconet_tpu_torch.__version__ == marconet_tpu.__version__
