"""Core layers of the port (counterpart of ``marconet_tpu/ops/layers.py``).

Tensors are NCHW in ``torch.channels_last`` memory format (physically
NHWC). Parameters carry the reference checkpoints' key names and torch
layouts (OIHW convs, (out, in) linears), so a released ``.pth`` loads with
``load_state_dict(strict=True)``. Random init follows the JAX package's
distributions and draws from an explicit ``torch.Generator``.

- ``EqualLinear``: StyleGAN equalized linear; ``lr_mul`` scales weight and
  bias; with ``activation="fused_lrelu"`` the bias goes into kernel K1.
- ``PixelNorm``.
- ``group_norm`` / ``GroupNorm``: torch semantics (biased variance,
  eps 1e-6), with an optional column mask: statistics over valid columns
  only, output zeroed at invalid ones.
- ``SNConv``: spectral-norm conv; eval mode uses the stored u, v, training
  mode advances them by one power iteration per forward.
- ``Conv``, ``Linear``: plain layers with the JAX package's lecun-normal init.
- ``ResTextBlockV2``: GroupNorm/swish residual block, plain or masked.
- ``masked_mean_std`` / ``adaptive_instance_norm``: AdaIN statistics
  (unbiased variance, eps added before the sqrt).

Masks are NCHW-broadcastable ``(B, 1, 1|H, W)`` tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from marconet_tpu_torch.ops.fused_act import fused_leaky_relu

# flax lecun_normal: truncated normal on [-2, 2] std, rescaled so the
# truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW view -> NHWC view (contiguous for channels_last input)."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC view -> NCHW view (channels_last for contiguous input)."""
    return x.permute(0, 3, 1, 2)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2):
    return F.leaky_relu(x, negative_slope)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# StyleGAN-style equalized linear
# ---------------------------------------------------------------------------


class EqualLinear(nn.Module):
    """``y = x @ (W * lr_mul / sqrt(in)).T + b * lr_mul``.

    With ``activation="fused_lrelu"`` the bias is applied inside kernel K1
    (``fused_leaky_relu``) instead. The stored weight is ``randn / lr_mul``.
    """

    def __init__(self, in_dim: int, out_dim: int, *, bias_init: float = 0.0,
                 lr_mul: float = 1.0, activation: str | None = None,
                 device=None, generator: torch.Generator):
        super().__init__()
        if activation not in (None, "fused_lrelu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim,
                                               device=device))
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init),
                                            device=device))
        with torch.no_grad():
            self.weight.normal_(generator=generator).div_(lr_mul)
        self.scale = lr_mul / math.sqrt(in_dim)
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight * self.scale)
        bias = self.bias * self.lr_mul
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(y, bias)
        return y + bias


class PixelNorm(nn.Module):
    """``x * rsqrt(mean(x^2, channel) + 1e-8)`` over the last axis."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-8)


# ---------------------------------------------------------------------------
# Group normalization with optional validity mask
# ---------------------------------------------------------------------------


def group_norm(x, weight, bias, num_groups: int, eps: float = 1e-6,
               mask=None):
    """GroupNorm of an NCHW tensor (torch semantics, biased variance).

    With ``mask`` (B, 1, 1|H, W) the statistics cover valid positions only
    and the output is zeroed at invalid ones. Statistics in f32.
    """
    xh = nhwc(x)
    b, h, w, c = xh.shape
    g = num_groups
    f = xh.float().reshape(b, h, w, g, c // g)
    if mask is None:
        mean = f.mean(dim=(1, 2, 4), keepdim=True)
        ex2 = f.square().mean(dim=(1, 2, 4), keepdim=True)
    else:
        mh = nhwc(mask).float()                       # (B, 1|H, W, 1)
        cnt = mh.sum(dim=(1, 2, 3)).reshape(b, 1, 1, 1, 1)
        if mh.shape[1] == 1:
            cnt = cnt * h
        cnt = (cnt * (c // g)).clamp(min=1.0)
        fm = f * mh[..., None]
        mean = fm.sum(dim=(1, 2, 4), keepdim=True) / cnt
        ex2 = (f * fm).sum(dim=(1, 2, 4), keepdim=True) / cnt
    var = (ex2 - mean.square()).clamp(min=0.0)
    y = ((f - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = y.to(x.dtype) * weight.to(x.dtype) + bias.to(x.dtype)
    y = nchw(y)
    if mask is not None:
        y = y * mask.to(y.dtype)
    return y


class GroupNorm(nn.Module):
    """32-channels-per-group GroupNorm, eps 1e-6 (one group below 32
    channels, for reduced widths)."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        cpg = min(32, channels)
        if channels % cpg:
            raise ValueError(f"{channels} channels do not split into groups "
                             f"of {cpg}")
        self.num_groups = channels // cpg
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x, mask=None):
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          mask=mask)


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with the JAX package's init (lecun-normal, zero bias)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, stride=1,
                 padding=0, bias: bool = True, *, device=None,
                 generator: torch.Generator):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, bias=bias, device=device)
        kh, kw = self.kernel_size
        lecun_normal_(self.weight, in_ch * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def reset_parameters(self):
        """No-op: the base constructor would draw from the global RNG;
        ``__init__`` initializes from its generator instead."""


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``Dense``'s init (lecun-normal, zero bias)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *,
                 device=None, generator: torch.Generator):
        super().__init__(in_dim, out_dim, bias=bias, device=device)
        lecun_normal_(self.weight, in_dim, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def reset_parameters(self):
        """No-op, as ``Conv.reset_parameters``."""


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / v.norm().clamp(min=eps)


class SNConv(nn.Module):
    """Conv2d with spectral weight normalization (torch semantics).

    State (reference keys): ``weight_orig`` (O, I, kh, kw), ``bias`` (when
    ``bias=True``) and the power-iteration buffers ``weight_u`` (O,) and
    ``weight_v`` (I*kh*kw,). ``sigma = u . (W_mat v)`` with ``W_mat`` the
    (O, I*kh*kw) view; the conv uses ``weight_orig / sigma``. At init u and
    v are aligned with 15 power iterations, so a random-weight net starts
    with sigma near the top singular value (as the JAX package does).

    In training mode each forward first runs one power iteration under
    ``no_grad`` (``v = norm(W^T u)``, ``u = norm(W v)``) and stores the
    new u and v (JAX ``update_stats=True``, ``marconet_tpu/ops/
    layers.py:263-269``); sigma stays differentiable in ``weight_orig``.
    In eval mode the stored vectors are used as they are.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride=1, padding: int | None = None, bias: bool = True, *,
                 device=None, generator: torch.Generator):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.weight_orig = nn.Parameter(torch.empty(out_ch, in_ch, k, k,
                                                    device=device))
        lecun_normal_(self.weight_orig, in_ch * k * k, generator)
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device)) \
            if bias else None
        with torch.no_grad():
            w_mat = self.weight_orig.reshape(out_ch, -1)
            u = _l2_normalize(torch.randn(out_ch, device=device,
                                          generator=generator))
            for _ in range(15):
                u = _l2_normalize(w_mat @ _l2_normalize(w_mat.T @ u))
            v = _l2_normalize(w_mat.T @ u)
        self.register_buffer("weight_u", u)
        self.register_buffer("weight_v", v)

    def normalized_weight(self) -> torch.Tensor:
        """The normalized kernel ``weight_orig / sigma`` (f32 sigma); in
        training mode after one power iteration that updates u and v."""
        w = self.weight_orig
        w_mat = w.float().reshape(w.shape[0], -1)
        # copies: a later training-mode forward updates the buffers in
        # place while this graph may still need them
        u, v = self.weight_u.float().clone(), self.weight_v.float().clone()
        if self.training:
            with torch.no_grad():
                v = _l2_normalize(w_mat.T @ u)
                u = _l2_normalize(w_mat @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        sigma = torch.dot(u, w_mat @ v)
        return (w.float() / sigma).to(w.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.normalized_weight(), self.bias,
                        stride=self.stride, padding=self.padding)


# ---------------------------------------------------------------------------
# Residual GN/swish block
# ---------------------------------------------------------------------------


class ResTextBlockV2(nn.Module):
    """GroupNorm -> swish -> SNConv3x3 (x2) residual block.

    The skip projection ``conv_out`` is a plain 1x1 conv, present when the
    channel count changes. With ``mask`` every conv output is re-masked, so
    invalid window columns stay at the zeros the reference's exact-width
    slices would give.
    """

    def __init__(self, in_ch: int, out_ch: int, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = GroupNorm(in_ch, device=device)
        self.conv1 = SNConv(in_ch, out_ch, **kw)
        self.norm2 = GroupNorm(out_ch, device=device)
        self.conv2 = SNConv(out_ch, out_ch, **kw)
        self.conv_out = Conv(in_ch, out_ch, 1, **kw) \
            if in_ch != out_ch else None

    def forward(self, x_in: torch.Tensor, mask=None) -> torch.Tensor:
        def masked(t):
            return t if mask is None else t * mask.to(t.dtype)

        x = swish(self.norm1(x_in, mask=mask))
        x = masked(self.conv1(x))
        x = swish(self.norm2(x, mask=mask))
        x = masked(self.conv2(x))
        if self.conv_out is not None:
            x_in = masked(self.conv_out(x_in))
        return x + x_in


# ---------------------------------------------------------------------------
# AdaIN
# ---------------------------------------------------------------------------


def masked_mean_std(x: torch.Tensor, mask=None, eps: float = 1e-5):
    """Per-(batch, channel) mean and std of an NCHW tensor.

    Unbiased variance (N-1) with ``eps`` added before the sqrt, as the
    reference's ``calc_mean_std_4D``; ``mask`` (B, 1, 1|H, W) restricts the
    statistics to valid positions. Returns (B, C, 1, 1) tensors in
    ``x``'s dtype.
    """
    f = x.float()
    h, w = x.shape[2], x.shape[3]
    if mask is None:
        n = float(h * w)
        mean = f.mean(dim=(2, 3), keepdim=True)
        ex2 = f.square().mean(dim=(2, 3), keepdim=True)
        unbias = n / max(n - 1.0, 1.0)
    else:
        m = mask.float()
        n = m.sum(dim=(2, 3), keepdim=True)
        if m.shape[2] == 1:
            n = n * h
        n = n.clamp(min=1.0)
        fm = f * m
        mean = fm.sum(dim=(2, 3), keepdim=True) / n
        ex2 = (f * fm).sum(dim=(2, 3), keepdim=True) / n
        unbias = n / (n - 1.0).clamp(min=1.0)
    var = (ex2 - mean.square()).clamp(min=0.0) * unbias
    std = torch.sqrt(var + eps)
    return mean.to(x.dtype), std.to(x.dtype)


def adaptive_instance_norm(prior_feat, lq_feat, prior_mask=None,
                           lq_mask=None):
    """Renormalize prior features to the LQ features' statistics."""
    lq_mean, lq_std = masked_mean_std(lq_feat, lq_mask)
    p_mean, p_std = masked_mean_std(prior_feat, prior_mask)
    out = (prior_feat - p_mean) / p_std * lq_std + lq_mean
    if prior_mask is not None:
        out = out * prior_mask.to(out.dtype)
    return out
