"""State dicts for the port's modules.

- ``encoder_from_jax`` / ``prior_from_jax`` / ``srnet_from_jax`` /
  ``discriminator_from_jax``: the JAX package's flax variables (as numpy
  arrays: ``params`` plus the ``spectral`` u and v of spectral-norm nets)
  -> state dicts with the reference's key names and torch layouts. They
  invert ``marconet_tpu/convert/torch_import.py::convert_{encoder,prior,
  srnet,discriminator}``, so a JAX init at any width loads into the port.
- ``lpips_from_jax``: JAX LPIPS variables -> the port's LPIPS.
- ``trainer_from_jax``: a JAX ``TrainState``'s five nets -> a port trainer.
- ``load_reference_pth``: a released reference ``.pth`` -> strict
  ``load_state_dict`` into one of the port's networks.

Layouts: HWIO conv -> OIHW; (in, out) dense -> (out, in); modulated-conv
(k, k, I, O) -> (1, O, I, k, k); per-channel biases -> (1, C, 1, 1);
codebook (classes, C) -> (classes, C, 1, 1). This module imports no JAX;
it only reads nested dicts of arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]

_STAGE_BLOCKS = (3, 4, 6, 6, 3)
_PYRAMID = (8, 16, 32, 64, 128)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(k) -> torch.Tensor:
    """(kh, kw, I, O) -> (O, I, kh, kw)."""
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _linear(k) -> torch.Tensor:
    """(I, O) -> (O, I)."""
    return _t(np.asarray(k).T)


def _modconv(k) -> torch.Tensor:
    """(k, k, I, O) -> (1, O, I, k, k)."""
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1))[None])


def _norm(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _dense(sd: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _linear(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _encoder_block(sd, attn_prefix, ff_prefix, p) -> None:
    _norm(sd, f"{attn_prefix}.norm", p["attn"]["norm"])
    _dense(sd, f"{attn_prefix}.to_qkv", p["attn"]["to_qkv"])
    _dense(sd, f"{attn_prefix}.to_out", p["attn"]["to_out"])
    _norm(sd, f"{ff_prefix}.net.0", p["ff"]["norm"])
    _dense(sd, f"{ff_prefix}.net.1", p["ff"]["fc1"])
    _dense(sd, f"{ff_prefix}.net.3", p["ff"]["fc2"])


def encoder_from_jax(variables: Mapping[str, Any]) -> StateDict:
    """``TextContextEncoder`` flax variables -> encoder state dict."""
    p = variables["params"]
    sd: StateDict = {}
    res = p["resnet"]
    sd["resnet.conv1.weight"] = _conv(res["conv1"]["kernel"])
    for si, blocks in enumerate(_STAGE_BLOCKS, start=1):
        for bi in range(blocks):
            blk = res[f"layer{si}_{bi}"]
            tp = f"resnet.layer{si}.{bi}"
            sd[f"{tp}.conv1.weight"] = _conv(blk["conv1"]["kernel"])
            sd[f"{tp}.conv2.weight"] = _conv(blk["conv2"]["kernel"])
            if "downsample" in blk:
                sd[f"{tp}.downsample.0.weight"] = _conv(
                    blk["downsample"]["kernel"])
    vit = p["vit"]
    _dense(sd, "transformer.to_patch_embedding.1", vit["patch_embed"])
    t = "transformer.transformer"
    for name, prefix in (("shared_0", f"{t}.layers.0"),
                         ("shared_1", f"{t}.layers.1"),
                         ("branch_cls", f"{t}.layers_cls.0"),
                         ("branch_locs", f"{t}.layers_locs.0"),
                         ("branch_w", f"{t}.layers_w.0")):
        _encoder_block(sd, f"{prefix}.0", f"{prefix}.1", vit[name])
    _norm(sd, f"{t}.linear_seq_maxlen.0", vit["seq_to_maxlen"]["norm"])
    _dense(sd, f"{t}.linear_seq_maxlen.1", vit["seq_to_maxlen"]["proj"])
    _norm(sd, "transformer.linear_cls.0", vit["head_cls_norm"])
    _dense(sd, "transformer.linear_cls.1", vit["head_cls_proj"])
    _norm(sd, "transformer.linear_locs.0", vit["head_locs_norm"])
    _dense(sd, "transformer.linear_locs.1", vit["head_locs_fc1"])
    _dense(sd, "transformer.linear_locs.3", vit["head_locs_fc2"])
    _norm(sd, "transformer.linear_w_maxlen.0", vit["w_seq_pool"]["norm"])
    _dense(sd, "transformer.linear_w_maxlen.1", vit["w_seq_pool"]["proj"])
    _norm(sd, "transformer.linear_w.0", vit["head_w_norm"])
    _dense(sd, "transformer.linear_w.1", vit["head_w_proj"])
    return sd


# ---------------------------------------------------------------------------
# prior generator
# ---------------------------------------------------------------------------


def modulated_from_jax(p: Mapping[str, Any]) -> StateDict:
    """``StyledConv`` / ``ToRGB`` flax params -> their state dict."""
    sd: StateDict = {"conv.weight": _modconv(p["conv"]["weight"])}
    _dense(sd, "conv.modulation", p["conv"]["modulation"])
    sd["bias"] = _t(p["bias"]).reshape(1, -1, 1, 1)
    if "act_bias" in p:
        sd["activate.bias"] = _t(p["act_bias"])
    return sd


def _add(sd: StateDict, prefix: str, sub: StateDict) -> None:
    sd.update({f"{prefix}.{k}": v for k, v in sub.items()})


def prior_from_jax(variables: Mapping[str, Any]) -> StateDict:
    """``StructurePriorGenerator`` flax variables -> prior state dict."""
    p = variables["params"]
    g = "TextGenerator"
    sd: StateDict = {}
    for i in range(len(p["style_mlp"])):
        _dense(sd, f"{g}.style_mlp.{i + 1}", p["style_mlp"][f"fc{i}"])
    emb = _t(p["codebook"]["embeddings"])
    sd[f"{g}.input_text.TextEmbeddings"] = emb[:, :, None, None]
    _add(sd, f"{g}.conv1", modulated_from_jax(p["conv_4"]))
    _add(sd, f"{g}.to_rgb1", modulated_from_jax(p["to_rgb_4"]))
    for i, res in enumerate(_PYRAMID):
        for name, prefix in ((f"conv_{res}_up", f"convs.{2 * i}"),
                             (f"conv_{res}", f"convs.{2 * i + 1}"),
                             (f"to_rgb_{res}", f"to_rgbs.{i}")):
            _add(sd, f"{g}.{prefix}", modulated_from_jax(p[name]))
    return sd


# ---------------------------------------------------------------------------
# SR net
# ---------------------------------------------------------------------------


def sn_conv_from_jax(p: Mapping[str, Any], s: Mapping[str, Any]
                     ) -> StateDict:
    """``SNConv`` params ``p`` and spectral state ``s`` -> state dict."""
    return {"weight_orig": _conv(p["kernel"]), "bias": _t(p["bias"]),
            "weight_u": _t(s["u"]), "weight_v": _t(s["v"])}


def sn_stack_from_jax(p: Mapping[str, Any], s: Mapping[str, Any]
                      ) -> StateDict:
    """``SNStack`` (conv1 / conv2) -> state dict (keys ``0.*``, ``2.*``)."""
    sd: StateDict = {}
    _add(sd, "0", sn_conv_from_jax(p["conv1"], s["conv1"]))
    _add(sd, "2", sn_conv_from_jax(p["conv2"], s["conv2"]))
    return sd


def res_block_from_jax(p: Mapping[str, Any], s: Mapping[str, Any]
                       ) -> StateDict:
    """``ResTextBlockV2`` params and spectral state -> state dict."""
    sd: StateDict = {}
    _norm(sd, "norm1", p["norm1"])
    _norm(sd, "norm2", p["norm2"])
    _add(sd, "conv1", sn_conv_from_jax(p["conv1"], s["conv1"]))
    _add(sd, "conv2", sn_conv_from_jax(p["conv2"], s["conv2"]))
    if "conv_out" in p:
        sd["conv_out.weight"] = _conv(p["conv_out"]["kernel"])
        sd["conv_out.bias"] = _t(p["conv_out"]["bias"])
    return sd


def srnet_from_jax(variables: Mapping[str, Any]) -> StateDict:
    """``StructurePriorSRNet`` flax variables (``params`` + ``spectral``)
    -> SR-net state dict."""
    params, spectral = variables["params"], variables["spectral"]
    sd: StateDict = {}
    for name, prefix in (("first_32", "conv_first_32.0"),
                         ("first_16", "conv_first_16.0"),
                         ("first_8a", "conv_first_8.0"),
                         ("first_8b", "conv_first_8.2"),
                         ("body_16a", "conv_body_16.0"),
                         ("body_16b", "conv_body_16.2"),
                         ("body_32a", "conv_body_32.0"),
                         ("body_32b", "conv_body_32.2"),
                         ("up_a", "conv_up.1"),
                         ("up_b", "conv_up.4"),
                         ("final_a", "conv_final.0"),
                         ("final_b", "conv_final.3"),
                         ("final_out", "conv_final.6")):
        _add(sd, prefix, sn_conv_from_jax(params[name], spectral[name]))
    _add(sd, "conv_32_to256",
         sn_stack_from_jax(params["to256"], spectral["to256"]))
    for scale in (32, 64):
        sp, ss = params[f"sft_{scale}"], spectral[f"sft_{scale}"]
        _add(sd, f"conv_{scale}_fuse.0",
             res_block_from_jax(sp["fuse"], ss["fuse"]))
        _add(sd, f"conv_{scale}_scale",
             sn_stack_from_jax(sp["scale"], ss["scale"]))
        _add(sd, f"conv_{scale}_shift",
             sn_stack_from_jax(sp["shift"], ss["shift"]))
    _add(sd, "conv_up.3",
         res_block_from_jax(params["up_res"], spectral["up_res"]))
    _add(sd, "conv_final.5",
         res_block_from_jax(params["final_res"], spectral["final_res"]))
    return sd


# ---------------------------------------------------------------------------
# training nets
# ---------------------------------------------------------------------------


def discriminator_from_jax(variables: Mapping[str, Any]) -> StateDict:
    """``UNetDiscriminatorSN`` flax variables -> basicsr-keyed state dict
    (the inverse of ``marconet_tpu/convert/torch_import.py::
    convert_discriminator``)."""
    params, spectral = variables["params"], variables["spectral"]
    sd: StateDict = {}
    for name in ("conv0", "conv9"):
        sd[f"{name}.weight"] = _conv(params[name]["kernel"])
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    for i in range(1, 9):
        name = f"conv{i}"
        sd[f"{name}.weight_orig"] = _conv(params[name]["kernel"])
        sd[f"{name}.weight_u"] = _t(spectral[name]["u"])
        sd[f"{name}.weight_v"] = _t(spectral[name]["v"])
    return sd


def lpips_from_jax(variables: Mapping[str, Any]) -> StateDict:
    """``LPIPS`` flax variables -> the port's LPIPS state dict
    (torchvision ``features.{idx}`` and lpips ``lin{i}.model.1`` keys;
    the inverse of ``marconet_tpu/train/lpips.py::convert_lpips_weights``)."""
    p = variables["params"]
    sd: StateDict = {}
    idx = 0
    for bi, n_convs in enumerate((2, 2, 3, 3, 3)):
        for ci in range(n_convs):
            conv = p["vgg"][f"conv{bi + 1}_{ci + 1}"]
            sd[f"features.{idx}.weight"] = _conv(conv["kernel"])
            sd[f"features.{idx}.bias"] = _t(conv["bias"])
            idx += 2                        # conv + relu
        idx += 1                            # max pool
    for i in range(5):
        sd[f"lin{i}.model.1.weight"] = _conv(p[f"lin{i}"]["kernel"])
    return sd


def trainer_from_jax(trainer, state, lpips_variables=None):
    """Load a JAX ``TrainState``'s five nets (``params`` and ``spectral``
    collections, as numpy arrays) into a port ``MARCONetTrainer``, so both
    packages start a step from identical weights; with
    ``lpips_variables``, the JAX trainer's LPIPS weights too. Optimizer
    states and the step count are left as they are. Returns ``trainer``.
    """
    loads = {"encoder": encoder_from_jax, "prior": prior_from_jax,
             "srnet": srnet_from_jax, "net_d": discriminator_from_jax,
             "net_srd": discriminator_from_jax}
    for name, from_jax in loads.items():
        sd = from_jax(getattr(state, name))
        trainer.net(name).load_state_dict(sd, strict=True)
    if lpips_variables is not None:
        trainer.lpips.load_state_dict(lpips_from_jax(lpips_variables),
                                      strict=True)
    return trainer


# ---------------------------------------------------------------------------
# reference checkpoints
# ---------------------------------------------------------------------------


def load_reference_pth(module: nn.Module, path: str,
                       param_key: str = "params") -> nn.Module:
    """Strictly load a released reference ``.pth`` into ``module``.

    Takes ``param_key``, then the reference's other container keys
    (``params`` for inference releases, ``params_ema`` for training
    warm-starts), then a bare state dict. A missing, renamed or extra key
    raises.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in (param_key, "params", "params_ema", "state_dict"):
        if key in ckpt:
            ckpt = ckpt[key]
            break
    module.load_state_dict(ckpt, strict=True)
    return module
