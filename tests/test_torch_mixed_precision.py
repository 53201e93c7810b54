"""The port's layers in bf16 over f32 parameters against the JAX package's
layers with ``dtype=bfloat16``: the precision rule of
``marconet_tpu/ops/layers.py`` ("all modules take ``dtype`` for the
compute precision (params stay float32)").

Each case initializes a JAX module, keeps its f32 parameters (random
normals, almost none of them bf16-representable), loads them into the
port's counterpart (``convert.*_from_jax``) and sets the port's compute
dtype to bf16 (``set_compute_dtype``). Both take the same bf16 input,
made with numpy from a seed. Checks:

- the port's parameters stay f32, and so do their ``.grad`` after a
  backward;
- the effective bf16 weights the port feeds ``F.linear`` / ``F.conv2d``
  equal, bit for bit and in program order, the operands the JAX program
  feeds its dense dots and convolutions (``(kernel * scale).astype(bf16)``,
  ``(kernel / sigma).astype(bf16)``, ``kernel.astype(bf16)``); LayerNorms
  get their f32 parameters, as flax's;
- the output has JAX's dtype, and the output and the parameter gradients
  are within ``FACTOR`` = 2 times the JAX package's own bf16 distance:
  max and mean of |port - JAX bf16| <= 2 x the same statistic of
  |JAX bf16 - JAX f32| (the f32 module on the same parameters and the same
  bf16-valued input), as ``tests/test_torch_bf16.py`` bounds the restore.

The JAX side runs through ``test_torch_bf16.run_bf16_on_cpu``: XLA:CPU
cannot run every bf16 dot the JAX modules ask for, and its ``record``
mode keeps the operands of each dot and convolution.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from marconet_tpu.models.encoder import EncoderBlock as JaxEncoderBlock
from marconet_tpu.ops import layers as jl
from marconet_tpu.ops import modconv as jm
from marconet_tpu.train.discriminators import UNetDiscriminatorSN as JaxDisc
from marconet_tpu_torch import convert
from marconet_tpu_torch.models.encoder import EncoderBlock
from marconet_tpu_torch.ops import layers as tl
from marconet_tpu_torch.ops import modconv as tm
from marconet_tpu_torch.ops.layers import set_compute_dtype
from marconet_tpu_torch.train.discriminators import UNetDiscriminatorSN
from tests.test_torch_bf16 import run_bf16_on_cpu

torch.set_num_threads(2)

BF16 = jnp.bfloat16
FACTOR = 2.0


def gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().float().numpy()


def bf16_values(rng, *shape, s=1.0) -> np.ndarray:
    """f32 numbers that bf16 represents exactly: the shared input."""
    x = (rng.standard_normal(shape) * s).astype(np.float32)
    return np.array(jnp.asarray(x, BF16).astype(jnp.float32))


class _Case:
    """A JAX module (built by ``make(dtype)``), its f32 variables, the
    port module holding them, the NHWC input and the two layouts'
    conversions."""

    def __init__(self, make, variables, port, inputs, *, image: bool,
                 from_jax, extra=()):
        self.make, self.variables, self.port = make, variables, port
        self.inputs, self.image = inputs, image
        self.from_jax, self.extra = from_jax, extra

    def port_inputs(self):
        conv = nchw if self.image else torch.from_numpy
        return [conv(x).to(torch.bfloat16) for x in self.inputs] + \
            [torch.from_numpy(e) for e in self.extra]

    def port_output(self, y: torch.Tensor) -> np.ndarray:
        return nhwc(y) if self.image else y.detach().float().numpy()


def _equal_linear(rng, lr_mul, activation):
    x = bf16_values(rng, 5, 24)

    def make(dtype):
        return jl.EqualLinear(16, lr_mul=lr_mul, activation=activation,
                              dtype=dtype)

    v = np_tree(make(jnp.float32).init(jax.random.PRNGKey(1), x))
    v["params"]["bias"] = rng.standard_normal(16).astype(np.float32) * 0.5
    mod = tl.EqualLinear(24, 16, lr_mul=lr_mul, activation=activation,
                         generator=gen())

    def from_jax(v):
        return {"weight": t(v["params"]["kernel"].T),
                "bias": t(v["params"]["bias"])}

    mod.load_state_dict(from_jax(v))
    return _Case(make, v, mod, [x], image=False, from_jax=from_jax)


def _conv(rng):
    x = bf16_values(rng, 2, 6, 7, 12)

    def make(dtype):
        return jl.Conv(8, dtype=dtype)

    v = np_tree(make(jnp.float32).init(jax.random.PRNGKey(4), x))
    v["params"]["bias"] = rng.standard_normal(8).astype(np.float32) * 0.1
    mod = tl.Conv(12, 8, 3, padding=1, generator=gen())

    def from_jax(v):
        return {"weight": t(np.transpose(v["params"]["kernel"],
                                         (3, 2, 0, 1))),
                "bias": t(v["params"]["bias"])}

    mod.load_state_dict(from_jax(v))
    return _Case(make, v, mod, [x], image=True, from_jax=from_jax)


def _snconv(rng):
    x = bf16_values(rng, 2, 8, 10, 6)

    def make(dtype):
        return jl.SNConv(12, dtype=dtype)

    v = np_tree(make(jnp.float32).init(jax.random.PRNGKey(2), x))
    v["params"]["bias"] = rng.standard_normal(12).astype(np.float32) * 0.1
    mod = tl.SNConv(6, 12, generator=gen()).eval()   # stored u, v

    def from_jax(v):
        return convert.sn_conv_from_jax(v["params"], v["spectral"])

    mod.load_state_dict(from_jax(v))
    return _Case(make, v, mod, [x], image=True, from_jax=from_jax)


def _styled_conv(rng, upsample):
    x = bf16_values(rng, 2, 4, 4, 16)
    style = bf16_values(rng, 2, 32)

    def make(dtype):
        return jm.StyledConv(24, upsample=upsample, dtype=dtype)

    v = np_tree(make(jnp.float32).init(jax.random.PRNGKey(6), x, style))
    v["params"]["bias"] = rng.standard_normal(24).astype(np.float32) * 0.1
    v["params"]["act_bias"] = rng.standard_normal(24).astype(
        np.float32) * 0.1
    mod = tm.StyledConv(16, 24, 32, upsample=upsample, generator=gen())

    def from_jax(v):
        return convert.modulated_from_jax(v["params"])

    mod.load_state_dict(from_jax(v))
    case = _Case(make, v, mod, [x], image=True, from_jax=from_jax)
    case.inputs = [x, style]
    case.port_inputs = lambda: [nchw(x).to(torch.bfloat16),
                                torch.from_numpy(style).to(torch.bfloat16)]
    return case


def _to_rgb(rng):
    x = bf16_values(rng, 2, 8, 8, 16)
    style = bf16_values(rng, 2, 32)
    skip = bf16_values(rng, 2, 4, 4, 3)

    def make(dtype):
        return jm.ToRGB(upsample=True, dtype=dtype)

    v = np_tree(make(jnp.float32).init(jax.random.PRNGKey(8), x, style,
                                       skip))
    v["params"]["bias"] = rng.standard_normal(3).astype(np.float32) * 0.1
    mod = tm.ToRGB(16, 32, upsample=True, generator=gen())

    def from_jax(v):
        return convert.modulated_from_jax(v["params"])

    mod.load_state_dict(from_jax(v))
    case = _Case(make, v, mod, [x, style, skip], image=True,
                 from_jax=from_jax)
    case.port_inputs = lambda: [nchw(x).to(torch.bfloat16),
                                torch.from_numpy(style).to(torch.bfloat16),
                                nchw(skip).to(torch.bfloat16)]
    return case


def _encoder_block(rng):
    """A shared trunk block: LayerNorm + attention, LayerNorm + MLP."""
    x = bf16_values(rng, 2, 12, 32)

    def make(dtype):
        return JaxEncoderBlock(64, dim_head=8, dtype=dtype)

    v = np_tree(make(jnp.float32).init(jax.random.PRNGKey(3), x))
    p = v["params"]
    for ln in (p["attn"]["norm"], p["ff"]["norm"]):     # non-trivial affine
        ln["scale"] = 1.0 + 0.2 * rng.standard_normal(32).astype(np.float32)
        ln["bias"] = 0.2 * rng.standard_normal(32).astype(np.float32)
    for fc in (p["ff"]["fc1"], p["ff"]["fc2"]):
        fc["bias"] = 0.1 * rng.standard_normal(fc["bias"].shape).astype(
            np.float32)
    mod = EncoderBlock(32, 64, 8, generator=gen())

    def from_jax(v):
        sd = {}
        convert._encoder_block(sd, "0", "1", v["params"])
        return sd

    mod.load_state_dict(from_jax(v))
    return _Case(make, v, mod, [x], image=False, from_jax=from_jax)


def _discriminator(rng):
    x = bf16_values(rng, 2, 32, 32, 3)

    def make(dtype):
        return JaxDisc(num_feat=8, dtype=dtype)

    v = np_tree(jax.jit(make(jnp.float32).init)(jax.random.PRNGKey(5), x))
    mod = UNetDiscriminatorSN(3, 8, generator=gen()).eval()
    mod.load_state_dict(convert.discriminator_from_jax(v), strict=True)
    return _Case(make, v, mod, [x], image=True,
                 from_jax=convert.discriminator_from_jax)


CASES = {
    "equal_linear": lambda rng: _equal_linear(rng, 1.0, None),
    "equal_linear_fused_lrelu": lambda rng: _equal_linear(rng, 0.01,
                                                          "fused_lrelu"),
    "conv": _conv,
    "snconv": _snconv,
    "styled_conv": lambda rng: _styled_conv(rng, False),
    "styled_conv_upsample": lambda rng: _styled_conv(rng, True),
    "to_rgb": _to_rgb,
    "encoder_block": _encoder_block,
    "discriminator": _discriminator,
}


class _PortRecorder(TorchFunctionMode):
    """Keeps the weight each ``F.linear`` / ``F.conv2d`` receives and the
    affine parameters of each ``F.layer_norm``."""

    def __init__(self):
        super().__init__()
        self.weights, self.norms = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (F.linear, F.conv2d):
            self.weights.append(args[1].detach())
        elif func is F.layer_norm:
            named = dict(zip(("input", "normalized_shape", "weight", "bias"),
                             args), **kwargs)
            self.norms.append((named["weight"].detach(),
                               named["bias"].detach()))
        return func(*args, **kwargs)


def _jax_weights(record) -> list:
    """The bf16 weight operands of the JAX program, in order: the kernel
    of every dense convolution and of every dense dot (a 2-D rhs on an
    activation of at most 3 dims). The bilinear upsample's depthwise
    convolutions and blend matmuls (4-D activations) are not layers."""
    out = []
    for name, ins, params in record:
        lhs, rhs = ins[0], ins[1]
        if rhs.dtype != BF16:
            continue
        if name == "conv_general_dilated":
            if params["feature_group_count"] == 1:
                out.append(np.asarray(rhs))
        elif rhs.ndim == 2 and lhs.ndim <= 3:
            out.append(np.asarray(rhs))
    return out


def _port_weight_as_jax(w: torch.Tensor) -> np.ndarray:
    """A port weight in the JAX layout: (O, I) -> (I, O), OIHW -> HWIO."""
    w = w.float()
    w = w.T if w.dim() == 2 else w.permute(2, 3, 1, 0)
    return np.ascontiguousarray(w.numpy())


def _grad_tree(case, grads):
    """JAX parameter gradients under the port's names."""
    v = dict(case.variables)
    v["params"] = grads
    return {k: g.numpy() for k, g in case.from_jax(np_tree(v)).items()}


@pytest.fixture(scope="module")
def results():
    out = {}
    for i, (name, build) in enumerate(CASES.items()):
        case = build(np.random.default_rng(10 + i))
        jbf, j32 = case.make(BF16), case.make(jnp.float32)
        v = case.variables
        params, rest = v["params"], {k: a for k, a in v.items()
                                     if k != "params"}
        xs_bf = [jnp.asarray(x, BF16) for x in case.inputs]

        record = []
        (jax_bf16,) = run_bf16_on_cpu(lambda v, *xs: jbf.apply(v, *xs), v,
                                      *xs_bf, record=record)
        jax_f32 = j32.apply(v, *map(jnp.asarray, case.inputs))

        rng = np.random.default_rng(100 + i)
        cot = rng.standard_normal(jax_f32.shape).astype(np.float32)

        def loss(p, mod, *xs):
            y = mod.apply({"params": p, **rest}, *xs)
            return (y.astype(jnp.float32) * cot).sum()

        g_bf16 = run_bf16_on_cpu(
            lambda p, *xs: jax.grad(loss)(p, jbf, *xs), params, *xs_bf)
        g_bf16 = jax.tree.unflatten(jax.tree.structure(params), g_bf16)
        g_f32 = jax.grad(loss)(params, j32,
                               *map(jnp.asarray, case.inputs))

        port = set_compute_dtype(case.port, torch.bfloat16)
        rec = _PortRecorder()
        with rec:
            y = port(*case.port_inputs())
        cot_port = nchw(cot) if case.image else torch.from_numpy(cot)
        (y.float() * cot_port).sum().backward()
        out[name] = dict(
            case=case, jax_bf16=np.asarray(jax_bf16, np.float32),
            jax_dtype=jax_bf16.dtype, jax_f32=np.asarray(jax_f32),
            jax_weights=_jax_weights(record), port_out=y,
            port_weights=rec.weights, port_norms=rec.norms,
            g_bf16=_grad_tree(case, g_bf16),
            g_f32=_grad_tree(case, np_tree(g_f32)))
    return out


def _within(got, jax_bf16, jax_f32, what):
    ref = np.abs(jax_bf16 - jax_f32)
    for stat in (np.max, np.mean):
        bound = FACTOR * stat(ref)
        err = stat(np.abs(got - jax_bf16))
        assert err <= bound, (what, stat.__name__, err, bound)


@pytest.mark.parametrize("name", CASES)
def test_parameters_and_grads_stay_f32(results, name):
    port = results[name]["case"].port
    for key, p in port.named_parameters():
        assert p.dtype == torch.float32, key
        assert p.grad is not None and p.grad.dtype == torch.float32, key
    for key, b in port.named_buffers():
        assert b.dtype == torch.float32, key


@pytest.mark.parametrize("name", CASES)
def test_effective_weights_equal_jax(results, name):
    """Bit for bit, in program order; LayerNorms get f32 parameters."""
    r = results[name]
    want, got = r["jax_weights"], r["port_weights"]
    assert want and len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16, (i, g.dtype)
        np.testing.assert_array_equal(_port_weight_as_jax(g),
                                      w.astype(np.float32), err_msg=str(i))
    if name == "encoder_block":
        p = r["case"].variables["params"]
        want_ln = [p["attn"]["norm"], p["ff"]["norm"]]
        assert len(r["port_norms"]) == len(want_ln)
        for (wt, bs), ln in zip(r["port_norms"], want_ln):
            assert wt.dtype == bs.dtype == torch.float32
            np.testing.assert_array_equal(wt.numpy(), ln["scale"])
            np.testing.assert_array_equal(bs.numpy(), ln["bias"])


@pytest.mark.parametrize("name", CASES)
def test_output_matches_jax_bf16(results, name):
    r = results[name]
    y = r["port_out"]
    assert y.dtype == torch.bfloat16 and r["jax_dtype"] == BF16
    got = r["case"].port_output(y)
    assert got.shape == r["jax_bf16"].shape
    assert np.isfinite(got).all()
    _within(got, r["jax_bf16"], r["jax_f32"], name)


@pytest.mark.parametrize("name", CASES)
def test_parameter_gradients_match_jax_bf16(results, name):
    """All of the module's parameter gradients at once (the JAX bf16
    module's gradients with respect to its f32 parameters, through the
    casts)."""
    r = results[name]
    port = r["case"].port
    keys = [k for k, _ in port.named_parameters()]
    grads = dict(port.named_parameters())

    def flat(d):
        return np.concatenate([np.asarray(d[k]).ravel() for k in keys])

    got = np.concatenate([grads[k].grad.numpy().ravel() for k in keys])
    _within(got, flat(r["g_bf16"]), flat(r["g_f32"]), name)
