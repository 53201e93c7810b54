"""The port's bf16 ``MARCONet.restore`` against the JAX package's bf16
restore, the served dtype (the page server and the bench run bf16).

Weights: one JAX init at ``width=0.0625``, cast to bf16 as ``bench.py``
casts its params; the port loads the same bf16 values (through
``convert.*_from_jax``) and stores them in bf16. Inputs: B = 2 lines, 4
slots of which 3 are valid, made with numpy from a seed.

The bound comes from the JAX package's own bf16 distance: for each output
(``sr``, ``priors``, ``logits``, ``pred_locs``, ``w``) the port's bf16
result may be at most ``FACTOR`` = 2 times as far from the JAX bf16 result
as the JAX bf16 result is from the JAX f32 result (same bf16-valued
weights, f32 compute), in max and in mean absolute difference; and the
port's bf16 result may be at most ``FACTOR`` times as far from that f32
result as the JAX bf16 one is. Random-weight nets in bf16 are far from
f32 (sr moves by up to 0.36 on [-1, 1]), so the bound is loose in
absolute terms and says only that the two bf16 pipelines are alike.
Measured (this file's inputs), port-vs-JAX-bf16 / JAX-bf16-vs-f32, max:
sr 0.431 / 0.364, priors 0.125 / 0.131, logits 0.0352 / 0.0424, pred_locs
0.0156 / 0.0204, w 0.0508 / 0.0856; mean: sr 0.00503 / 0.00437, priors
0.0138 / 0.0136, logits 0.0047 / 0.0058, pred_locs 0.0035 / 0.0043, w
0.0150 / 0.0201. The port's bf16 result is as near the f32 one as JAX's
(max: sr 0.330, priors 0.139, logits 0.0463, pred_locs 0.0182, w 0.0597).
Neither side is wrong at this bound.

XLA:CPU cannot run a dot of two bf16 operands into an f32 result
(``DotThunk``: "Unsupported element type ... BF16 x BF16 = F32"), which
the JAX model asks for in its modulated convs and window ops. The JAX
restore therefore runs through :func:`run_bf16_on_cpu`: its own jaxpr,
evaluated primitive by primitive, with each such dot fed its operands
converted to f32. A bf16 x bf16 product is exact in f32 and the dot sums
in f32 either way, so that is the same arithmetic up to the order of the
sum (``test_dot_rewrite_matches_xla`` holds it to XLA's own result where
XLA:CPU does run one).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.extend import core as jcore

from marconet_tpu.models.pipeline import MARCONet as JaxMARCONet
from marconet_tpu_torch.convert import (
    encoder_from_jax,
    prior_from_jax,
    srnet_from_jax,
)
from marconet_tpu_torch.models.pipeline import MARCONet

torch.set_num_threads(4)

WIDTH = 0.0625
FACTOR = 2.0
OUTPUTS = ("sr", "priors", "logits", "pred_locs", "w")
# primitives that hold a sub-jaxpr, and the parameter that holds it
_CALLS = {"jit": "jaxpr", "custom_jvp_call": "call_jaxpr",
          "custom_vjp_call": "call_jaxpr"}


def _eval(jaxpr, consts, *args):
    env = {}

    def read(v):
        return v.val if isinstance(v, jcore.Literal) else env[v]

    env.update(zip(jaxpr.constvars, consts))
    env.update(zip(jaxpr.invars, args))
    for eqn in jaxpr.eqns:
        ins = [read(v) for v in eqn.invars]
        name = eqn.primitive.name
        if name in _CALLS:
            sub = eqn.params[_CALLS[name]]
            outs = _eval(sub.jaxpr, sub.consts,
                         *ins[len(ins) - len(sub.jaxpr.invars):])
        else:
            if (name == "dot_general"
                    and eqn.params["preferred_element_type"] == jnp.float32
                    and any(x.dtype == jnp.bfloat16 for x in ins)):
                ins = [x.astype(jnp.float32) for x in ins]
            outs = eqn.primitive.bind(*ins, **eqn.params)
            if not eqn.primitive.multiple_results:
                outs = [outs]
        env.update(zip(eqn.outvars, outs))
    return [read(v) for v in jaxpr.outvars]


def run_bf16_on_cpu(fn, *args):
    """``fn(*args)`` with every bf16 x bf16 -> f32 dot fed f32 operands;
    returns the flat list of outputs."""
    closed = jax.make_jaxpr(fn)(*args)
    flat = jax.tree.leaves(args)
    return jax.jit(lambda *xs: _eval(closed.jaxpr, closed.consts, *xs))(
        *flat)


def test_dot_rewrite_matches_xla():
    """Where XLA:CPU runs a bf16 x bf16 -> f32 dot itself, the rewrite
    gives its result up to the order of its f32 sum (64 exact products of
    order 1: atol 1e-5, rtol 1e-6; measured 9.5e-7 at most)."""
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((16, 64)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((24, 64)), jnp.bfloat16)

    def f(a, b):
        return jnp.einsum("ij,kj->ik", a, b,
                          preferred_element_type=jnp.float32)

    want = jax.jit(f)(a, b)
    (got,) = run_bf16_on_cpu(f, a, b)
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


@pytest.fixture(scope="module")
def results():
    j32 = JaxMARCONet(width=WIDTH)
    jbf = JaxMARCONet(width=WIDTH, dtype=jnp.bfloat16)
    params = jax.jit(j32.init)(jax.random.PRNGKey(7))
    pbf = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                       if x.dtype == jnp.float32 else x, params)
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32), pbf)

    net = MARCONet(width=WIDTH, dtype=torch.bfloat16, device="cpu")
    as_np = jax.tree.map(np.asarray, p32)
    net.encoder.load_state_dict(encoder_from_jax(as_np.encoder), strict=True)
    net.prior.load_state_dict(prior_from_jax(as_np.prior), strict=True)
    net.srnet.load_state_dict(srnet_from_jax(as_np.srnet), strict=True)
    assert {p.dtype for p in net.state_dict().values()} == {torch.bfloat16}

    rng = np.random.default_rng(3)
    b, slots = 2, 4
    lq = rng.uniform(-1, 1, (b, 32, 512, 3)).astype(np.float32)
    labels = rng.integers(0, 6735, (b, slots)).astype(np.int32)
    locs = np.zeros((b, 2 * slots), np.float32)
    locs[:, 0::2] = [0.1, 0.35, 0.6, 0.85]
    locs[:, 1::2] = 0.03
    mask = np.zeros((b, slots), np.float32)
    mask[:, :3] = 1.0

    f32 = j32.restore(p32, *map(jnp.asarray, (lq, labels, locs, mask)))
    bf = run_bf16_on_cpu(lambda *a: jbf.restore(*a), pbf,
                         jnp.asarray(lq, jnp.bfloat16),
                         *map(jnp.asarray, (labels, locs, mask)))
    got = net.restore(*map(torch.from_numpy, (lq, labels, locs, mask)))
    return {name: (np.asarray(getattr(f32, name), np.float32),
                   np.asarray(bf[i], np.float32),
                   getattr(got, name).float().numpy())
            for i, name in enumerate(OUTPUTS)}


@pytest.mark.parametrize("name", OUTPUTS)
def test_bf16_restore_matches_jax_bf16(results, name):
    f32, jax_bf16, port_bf16 = results[name]
    assert port_bf16.shape == jax_bf16.shape == f32.shape
    assert np.isfinite(port_bf16).all()
    ref = np.abs(jax_bf16 - f32)
    for stat in (np.max, np.mean):
        bound = FACTOR * stat(ref)
        to_jax = stat(np.abs(port_bf16 - jax_bf16))
        to_f32 = stat(np.abs(port_bf16 - f32))
        assert to_jax <= bound, (name, stat.__name__, to_jax, bound)
        assert to_f32 <= bound, (name, stat.__name__, to_f32, bound)
