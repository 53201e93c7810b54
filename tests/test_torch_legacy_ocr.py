"""The port's legacy transformer OCR (``marconet_tpu_torch/models/
legacy_ocr.py``) against the JAX package's ``LegacyTransformerOCR``.

The JAX module is initialized at a reduced size (vocabulary 60, the box
head on, 32 x 64 lines; its channel widths are fixed), with random
BatchNorm statistics and affine terms so that the BN layers do work. Its
variables go to the port through ``convert.legacy_ocr_from_jax``, whose
keys the JAX package's strict ``convert_legacy_ocr`` reads back into the
same variables (so they are the reference ``TransformerOCR``'s names), and
``convert.load_legacy_ocr`` loads them strictly. Logits and box outputs
agree within 1e-4; the greedy decode gives the same ids.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from marconet_tpu.convert.ocr_import import convert_legacy_ocr
from marconet_tpu.models.legacy_ocr import LegacyTransformerOCR as JaxOCR
from marconet_tpu_torch.convert import legacy_ocr_from_jax, load_legacy_ocr
from marconet_tpu_torch.models.legacy_ocr import LegacyTransformerOCR

VOCAB = 60
TOKENS = np.array([[1, 5, 9, 2, 0, 7], [3, 3, 58, 11, 4, 0]], np.int32)


def _randomize_bn(tree, rng):
    """Random running statistics (var in [0.5, 1.5]) and affine terms."""
    def walk(p, s):
        for k in p:
            if k in s and isinstance(s[k], dict) and "mean" in s[k]:
                shape = s[k]["mean"].shape
                s[k] = {"mean": rng.normal(0, 0.2, shape).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, shape)
                        .astype(np.float32)}
                p[k] = {"scale": rng.uniform(0.5, 1.5, shape)
                        .astype(np.float32),
                        "bias": rng.normal(0, 0.1, shape).astype(np.float32)}
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    walk(tree["params"]["encoder"], tree["batch_stats"]["encoder"])
    return tree


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    jnet = JaxOCR(vocab=VOCAB, use_loc_head=True)
    img = jnp.zeros((1, 32, 64, 3))
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), img,
                                   jnp.asarray(TOKENS[:1]))
    variables = jax.tree.map(lambda a: np.array(a, np.float32), variables)
    variables = _randomize_bn(jax.tree.map(lambda a: a, variables), rng)
    sd = legacy_ocr_from_jax(variables)
    port = LegacyTransformerOCR(VOCAB, use_loc_head=True,
                                generator=torch.Generator().manual_seed(1))
    load_legacy_ocr(port, sd)
    port.eval()
    images = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    return jnet, variables, sd, port, images


def test_keys_are_the_reference_names(nets):
    """The JAX package's strict converter reads the port's state dict
    back into the JAX variables, every key consumed."""
    _, variables, sd, _, _ = nets
    back = convert_legacy_ocr({k: v.numpy() for k, v in sd.items()})
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


def test_logits_and_locs_match_jax(nets):
    jnet, variables, _, port, images = nets
    want_logits, want_locs = jnet.apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(images),
        jnp.asarray(TOKENS))
    with torch.no_grad():
        logits, locs = port(torch.from_numpy(images),
                            torch.from_numpy(TOKENS))
    assert logits.shape == (2, TOKENS.shape[1], VOCAB)
    assert locs.shape == (2, TOKENS.shape[1], 1)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(locs.numpy(), np.asarray(want_locs),
                               rtol=1e-4, atol=1e-4)


def test_greedy_decode_ids_match_jax(nets):
    jnet, variables, _, port, images = nets
    want = np.asarray(jnet.greedy_decode(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(images),
        max_len=8, start_token=1))
    got = port.greedy_decode(torch.from_numpy(images), max_len=8,
                             start_token=1).numpy()
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def test_causal(nets):
    """A later token does not change earlier logits."""
    _, _, _, port, images = nets
    t2 = TOKENS.copy()
    t2[:, 3:] = 17
    with torch.no_grad():
        a, _ = port(torch.from_numpy(images), torch.from_numpy(TOKENS))
        b, _ = port(torch.from_numpy(images), torch.from_numpy(t2))
    torch.testing.assert_close(a[:, :3], b[:, :3], rtol=0, atol=1e-5)
    assert not torch.allclose(a[:, 3:], b[:, 3:])


def test_strict_loader(nets):
    """The reference's by-design extras load; a missing, an extra or a
    misshapen key raises."""
    _, _, sd, port, _ = nets
    target = copy.deepcopy(port)

    extras = dict(sd)
    extras["pe.pe"] = torch.zeros(1, 5000, 512)
    extras["encoder.bn1.num_batches_tracked"] = torch.tensor(3)
    extras["compress_attention_linear.weight"] = torch.zeros(4, 4)
    load_legacy_ocr(target, extras)

    missing = dict(sd)
    del missing["decoder.pff.w_1.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_legacy_ocr(target, missing)
    extra = dict(sd)
    extra["decoder.pff.w_3.weight"] = torch.zeros(2, 2)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_legacy_ocr(target, extra)
    without_head = {k: v for k, v in sd.items()
                    if not k.startswith("generator_loc")}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_legacy_ocr(target, without_head)
    target.generator_loc = None           # the logits-only layout
    load_legacy_ocr(target, without_head)
    bad = dict(without_head)
    bad["generator_word.proj.weight"] = torch.zeros(VOCAB + 1, 1024)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_legacy_ocr(target, bad)
