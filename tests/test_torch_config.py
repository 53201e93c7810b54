"""The port's YAML subset reader (``marconet_tpu_torch/utils/yaml_lite.py``)
against ``yaml.safe_load``, its refusals, and ``train/config.py::
load_config`` field for field against the JAX package's."""

import dataclasses
import pathlib

import pytest
import yaml

from marconet_tpu.train import config as jconfig
from marconet_tpu_torch.train import config as tconfig
from marconet_tpu_torch.utils import yaml_lite

TRAIN_YML = "options/train.yml"

DOCS = [
    "a: 1\nb: text\nc: ~\nd:\ne: null\nf: Null",
    "flags: [true, false, yes, No, on, OFF, True, FALSE]",
    "ints: [0, 7, -3, +4, 1_000, 600000]",
    "floats: [1.5, -0.5, .5, 3., 1.0e-5, 2.5E+3, 1.5_0, .inf, -.inf]",
    "strings: [1e-5, 1.0e5, abc def, 'it''s', \"tab\\there\", '#x', a#b]",
    "tagged: {lr: !!float 1e-5, n: !!float 20, z: !!float .5}",
    "nested: {a: [1, [2, 3], {b: c}], d: {}}",
    "empty: {x: , y: []}",
    "seq:\n- x\n- y\nafter: 2",
    "seq:\n  - k: 1\n    j: [2]\n  - 3\n  -\n    deep: true",
    "- 1\n- - 2\n  - 3\n- {a: b}",
    "outer:\n  inner:\n    leaf: 1  # comment\n  other: 2\n# full line\n",
    "url: http://example.org/a:b\nkey with spaces: x:y b#c #d",
    "'quoted key': 1\n\"dq\": 2",
]

REFUSED = [
    ("a: &anchor 1", 1), ("a: *alias", 1), ("a: |\n  text", 1),
    ("a: >\n  text", 1), ("a: !!str 1", 1), ("a: !custom x", 1),
    ("a: 0x10", 1), ("a: 012", 1), ("a: 0b101", 1), ("a: 1:30", 1),
    ("a: plain\n  continued", 2), ("---\na: 1", 1), ("a: 1\n...", 2),
    ("a: [1,\n  2]", 1), ("a: {b: 1", 1), ("a: 'open", 1),
    ("a: \"esc \\q\"", 1), ("a:\n\tb: 1", 2), ("a: b: c", 1),
    ("a: 1\n   b: 2", 2), ("a:\n  - 1\n   - 2", 3),
]


def test_reads_train_yml_as_safe_load():
    with open(TRAIN_YML) as f:
        want = yaml.safe_load(f)
    assert yaml_lite.load(TRAIN_YML) == want


@pytest.mark.parametrize("doc", DOCS)
def test_reads_documents_as_safe_load(doc):
    got, want = yaml_lite.loads(doc), yaml.safe_load(doc)
    assert repr(got) == repr(want)         # types too (1 vs 1.0 vs '1')


@pytest.mark.parametrize("doc,line", REFUSED)
def test_refuses_outside_the_subset(doc, line):
    with pytest.raises(yaml_lite.YamlError, match=f"<string>:{line}:"):
        yaml_lite.loads(doc)


def test_load_config_matches_jax_field_for_field():
    got, want = tconfig.load_config(TRAIN_YML), \
        jconfig.load_config(TRAIN_YML)
    assert got.train._fields == type(want.train)._fields
    for name in got.train._fields:
        g, w = getattr(got.train, name), getattr(want.train, name)
        assert g == w and type(g) is type(w), name
    assert [f.name for f in dataclasses.fields(got.loop)] == \
        [f.name for f in dataclasses.fields(want.loop)]
    for f in dataclasses.fields(got.loop):
        g, w = getattr(got.loop, f.name), getattr(want.loop, f.name)
        assert g == w and type(g) is type(w), f.name
    assert got.raw == want.raw


def test_load_config_reads_overrides_as_jax(tmp_path):
    text = pathlib.Path(TRAIN_YML).read_text().replace(
        "  net_g_reg_every: 4",
        "  net_g_reg_every: 4\n  model_width: 0.0625\n"
        "  model_max_chars: 4\n  freeze: [encoder.resnet, prior]\n"
        "  allow_random_lpips: true")
    text = text.replace("resume_state: ~", "resume_state: ./ckpts") \
        .replace("num_worker_per_gpu: 2", "num_worker_per_gpu: 3") \
        .replace("name: train_marconet_tpu", "name: tiny\nnum_gpu: 1")
    path = tmp_path / "tiny.yml"
    path.write_text(text)
    got, want = tconfig.load_config(str(path)), \
        jconfig.load_config(str(path))
    assert tuple(got.train) == tuple(want.train)
    assert dataclasses.asdict(got.loop) == dataclasses.asdict(want.loop)
    assert (got.train.width, got.train.freeze, got.loop.num_devices,
            got.loop.num_workers) == (0.0625, ("encoder.resnet", "prior"),
                                      1, 3)


def test_refuses_more_than_one_device(tmp_path):
    """``num_gpu: 4`` loads as the JAX package loads it (the world size is
    not known at load time); ``train()`` on one rank refuses it, naming
    both numbers, before it builds anything."""
    from marconet_tpu_torch.train.loop import train

    path = tmp_path / "multi.yml"
    path.write_text(pathlib.Path(TRAIN_YML).read_text() + "\nnum_gpu: 4\n")
    got, want = tconfig.load_config(str(path)), \
        jconfig.load_config(str(path))
    assert dataclasses.asdict(got.loop) == dataclasses.asdict(want.loop)
    assert tuple(got.train) == tuple(want.train)
    assert got.loop.num_devices == 4
    got.loop.experiments_root = str(tmp_path)
    with pytest.raises(ValueError, match="num_gpu 4 but the world size "
                                         "is 1"):
        train(got, max_steps=1, device="cpu")
    assert not (tmp_path / got.loop.name).exists()
