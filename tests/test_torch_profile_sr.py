"""The port's restore profiler (``marconet_tpu_torch.cli.profile_sr``) on
the CPU: a reduced-width bf16 ``MARCONet`` (width 0.0625) through
``profile_restore`` writes a Chrome trace that parses, with the
pipeline's spans of every traced restore; the CLI's net computes in bf16
over f32 parameters; the inputs are the JAX tool's
(``tools/profile_sr.py``). On the card the same function traces the
kernels (``chip_smoke.py`` phase 15)."""

import functools
import json

import numpy as np
import torch

from marconet_tpu_torch.cli import profile_sr
from marconet_tpu_torch.models.pipeline import MARCONet


def test_trace_parses(tmp_path):
    net = MARCONet(width=0.0625, dtype=torch.bfloat16, device="cpu", seed=0)
    path = profile_sr.profile_restore(net, str(tmp_path / "trace"),
                                      batch=2, slots=4, iters=2)
    with open(path) as f:
        trace = json.load(f)
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert spans and all("dur" in e for e in spans)
    names = [e["name"] for e in spans]
    for span in ("restore", "encoder", "prior", "srnet"):
        assert names.count(f"pipeline/{span}") == 2


def test_profiled_net_keeps_f32_parameters(tmp_path, monkeypatch):
    """The CLI profiles what ``serve_demo`` runs: bf16 compute over f32
    parameters (the JAX tool's ``MARCONet(dtype=jnp.bfloat16)`` over
    ``net.init``'s f32 parameters)."""
    seen = []
    monkeypatch.setattr(profile_sr, "MARCONet",
                        functools.partial(MARCONet, width=0.0625))
    monkeypatch.setattr(profile_sr, "profile_restore",
                        lambda net, *args: seen.append(net))
    profile_sr.main(["--device", "cpu", "-o", str(tmp_path)])
    (net,) = seen
    assert net.dtype == torch.bfloat16
    assert {p.dtype for p in net.parameters()} == {torch.float32}


def test_inputs_are_the_jax_tools():
    """numpy seed 0: lq, then labels, then bench.py's locs layout."""
    lq, labels, locs, mask = profile_sr.restore_inputs(3, 5)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        lq, rng.uniform(-1, 1, (3, 32, 512, 3)).astype(np.float32))
    np.testing.assert_array_equal(labels, rng.integers(0, 6735, (3, 5)))
    assert locs.shape == (3, 10) and np.allclose(locs[0, :4],
                                                 [0.06, 0.03, 0.17, 0.03])
    assert mask.shape == (3, 5) and mask.min() == 1


def test_parser_keeps_the_jax_flags():
    args = profile_sr.parser().parse_args([])
    assert (args.batch, args.slots, args.iters, args.device) == \
        (16, 8, 3, "cuda")
