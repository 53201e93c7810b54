"""The port's SFT write-back (kernel K2's plain version) and SFT fusion
against the JAX package.

K2's plain version is held against the TPU kernel itself, run as
``tests/test_pallas_sft.py`` runs it: ``pallas_sft.sft_writeback(...,
interpret=True)`` at C=128. ``sft_fusion`` is held against the JAX
``SFTFusion`` module (its plain CPU forms) on the three center sets of
``tests/test_convert.py::test_srnet_conversion_end_to_end``, at reduced
width. Everything runs on the CPU in f32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from marconet_tpu.models import srnet as jsrnet
from marconet_tpu.ops import pallas_sft
from marconet_tpu_torch.convert import res_block_from_jax, sn_stack_from_jax
from marconet_tpu_torch.models import srnet as tsrnet
from marconet_tpu_torch.ops import layers as tl
from marconet_tpu_torch.ops import sft_writeback as twb

torch.set_num_threads(1)

# the three center sets of test_srnet_conversion_end_to_end
CENTER_SETS = {
    "interior": [0.1, 0.35, 0.62, 0.9],
    "truncated_edges": [0.01, 0.5, 0.99],
    "overlap": [0.3, 0.317, 0.335, 0.36],
}


def gen(seed: int = 0) -> torch.Generator:
    """The explicit generator every port constructor takes."""
    return torch.Generator().manual_seed(seed)

def _geometry(centers, slots, hw, width):
    locs = np.zeros((1, 2 * slots), np.float32)
    locs[0, 0:2 * len(centers):2] = centers
    locs[0, 1::2] = 0.03
    x1, length, _ = jsrnet._window_geometry(jnp.asarray(locs), hw, width)
    return locs, np.asarray(x1), np.asarray(length)


@pytest.mark.parametrize("case", ["interior", "truncated_edges", "overlap",
                                  "random_with_invalid"])
def test_writeback_plain_matches_pallas_interpret(case):
    """Bit-exact: both sides add one canvas and one residual value in f32."""
    rng = np.random.default_rng(11)
    b, h, width, c, hw = 2, 8, 128, 128, 16
    win, s = 2 * hw, 8
    if case == "random_with_invalid":
        x1 = rng.integers(0, width - 4, (b, s)).astype(np.int32)
        length = np.minimum(rng.integers(1, win + 1, (b, s)),
                            width - x1).astype(np.int32)
        valid = rng.integers(0, 2, (b, s)).astype(np.int32)
        valid[:, 0] = 1
    else:
        _, x1, length = _geometry(CENTER_SETS[case], s, hw, width)
        x1, length = np.repeat(x1, b, 0), np.repeat(length, b, 0)
        valid = np.zeros((b, s), np.int32)
        valid[:, :len(CENTER_SETS[case])] = 1
        valid[1, 1] = 0                           # an invalid slot among them
    canvas = rng.standard_normal((b, h, width, c)).astype(np.float32)
    res = rng.standard_normal((b, s, h, win, c)).astype(np.float32)

    want = np.asarray(pallas_sft.sft_writeback(
        *map(jnp.asarray, (canvas, res, x1, length, valid)),
        interpret=True))
    got = twb.sft_writeback_plain(*map(torch.from_numpy,
                                       (canvas, res, x1, length, valid)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_writeback_wrapper_on_cpu_takes_plain():
    rng = np.random.default_rng(12)
    canvas = torch.from_numpy(rng.standard_normal((1, 4, 40, 8))
                              .astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((1, 3, 4, 8, 8))
                           .astype(np.float32))
    x1 = torch.tensor([[0, 5, 36]], dtype=torch.int32)
    length = torch.tensor([[8, 8, 4]], dtype=torch.int32)
    valid = torch.tensor([[1, 1, 1]], dtype=torch.int32)
    before = twb.sft_writeback.launches
    got = twb.sft_writeback(canvas, res, x1, length, valid)
    torch.testing.assert_close(
        got, twb.sft_writeback_plain(canvas, res, x1, length, valid),
        rtol=0, atol=0)
    assert twb.sft_writeback.launches == before
    # slot 1 wins over slot 0 on their overlap [5, 8)
    torch.testing.assert_close(got[0, :, 5], canvas[0, :, 5] + res[0, 1, :, 0])
    with pytest.raises(ValueError):      # int64 slot table
        twb.sft_writeback(canvas, res, x1.long(), length, valid)
    with pytest.raises(ValueError):      # non-contiguous canvas
        twb.sft_writeback(canvas.transpose(1, 2), res, x1, length, valid)
    with pytest.raises(ValueError):      # channel mismatch
        twb.sft_writeback(canvas, res[..., :4], x1, length, valid)


def test_window_geometry():
    centers = [0.0, 0.01, 0.2, 0.5, 0.97, 0.999, 1.0, 1.3, -0.2]
    locs = np.zeros((1, 2 * len(centers)), np.float32)
    locs[0, 0::2] = centers
    for hw, width in ((16, 512), (32, 1024)):
        want = jsrnet._window_geometry(jnp.asarray(locs), hw, width)
        got = tsrnet.window_geometry(torch.from_numpy(locs), hw, width)
        for w_, g_ in zip(want, got):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


@pytest.fixture(scope="module")
def sft_modules():
    """JAX SFTFusion at reduced width (C=16) and the port's modules."""
    c, hw, h, width, n = 16, 16, 16, 256, 16
    jmod = jsrnet.SFTFusion(half_width=hw, features=c)
    rng = np.random.default_rng(13)
    canvas = jnp.asarray(rng.standard_normal((1, h, width, c)) * 0.3,
                         jnp.float32)
    priors = jnp.asarray(rng.standard_normal((1, n, h, 2 * hw, c)) * 0.3,
                         jnp.float32)
    locs = jnp.zeros((1, 2 * n), jnp.float32)
    mask = jnp.ones((1, n), jnp.float32)
    v = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(3), canvas,
                                           priors, locs, mask))
    p, s = v["params"], v["spectral"]
    fuse = tl.ResTextBlockV2(2 * c, c, generator=gen())
    fuse.load_state_dict(res_block_from_jax(p["fuse"], s["fuse"]))
    scale, shift = (tsrnet.SNStack(c, c, generator=gen()),
                    tsrnet.SNStack(c, c, generator=gen()))
    scale.load_state_dict(sn_stack_from_jax(p["scale"], s["scale"]))
    shift.load_state_dict(sn_stack_from_jax(p["shift"], s["shift"]))
    # eval mode, as the JAX module (update_stats=False): stored u and v
    for m in (fuse, scale, shift):
        m.eval()
    return jmod, v, (fuse, scale, shift), (c, hw, h, width, n)


@pytest.mark.parametrize("case", sorted(CENTER_SETS))
def test_sft_fusion_matches_jax(sft_modules, case):
    """Tolerance of test_srnet_conversion_end_to_end (rtol 1e-3,
    atol 2e-3)."""
    jmod, v, (fuse, scale, shift), (c, hw, h, width, n) = sft_modules
    rng = np.random.default_rng(14)
    canvas = (rng.standard_normal((1, h, width, c)) * 0.3).astype(np.float32)
    priors = (rng.standard_normal((1, n, h, 2 * hw, c)) * 0.3
              ).astype(np.float32)
    centers = CENTER_SETS[case]
    locs, _, _ = _geometry(centers, n, hw, width)
    mask = np.zeros((1, n), np.float32)
    mask[0, :len(centers)] = 1.0

    want = np.asarray(jmod.apply(v, *map(jnp.asarray,
                                         (canvas, priors, locs, mask))))
    canvas_t = torch.from_numpy(canvas).permute(0, 3, 1, 2)
    priors_t = torch.from_numpy(priors.reshape(n, h, 2 * hw, c)
                                ).permute(0, 3, 1, 2)
    got = tsrnet.sft_fusion(canvas_t, priors_t, torch.from_numpy(locs),
                            torch.from_numpy(mask), half_width=hw,
                            fuse=fuse, scale=scale, shift=shift)
    got = got.permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)
    # only windows of valid slots moved the canvas
    changed = np.abs(got - canvas).max(axis=(0, 1, 3)) > 0
    _, x1, length = _geometry(centers, n, hw, width)
    covered = np.zeros(width, bool)
    for i in range(len(centers)):
        covered[x1[0, i]:x1[0, i] + length[0, i]] = True
    assert not changed[~covered].any()
