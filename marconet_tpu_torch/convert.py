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
  ``load_state_dict`` into one of the port's networks;
  ``load_reference_checkpoints`` loads all three into a ``MARCONet``,
  ``load_reference_or_random`` falls back to random weights with a
  warning, as the CLIs do.
- The front-end: ``load_yolo_checkpoint`` (an ultralytics YOLO11 export),
  ``load_ocr_checkpoint`` / ``ocr_state_from_modelscope`` / ``load_vocab``
  (a ModelScope ConvNextViT export, topology from its shapes), and
  ``yolo_from_jax`` / ``ocr_from_jax`` (JAX variables -> these modules).

Layouts: HWIO conv -> OIHW; (in, out) dense -> (out, in); modulated-conv
(k, k, I, O) -> (1, O, I, k, k); per-channel biases -> (1, C, 1, 1);
codebook (classes, C) -> (classes, C, 1, 1). This module imports no JAX;
it only reads nested dicts of arrays.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional

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


# the released checkpoints, in the order of MARCONet's three networks
# (reference ``checkpoints/download_github.py:1-11``)
REFERENCE_FILES = ("net_transformer_encoder.pth", "net_prior_generation.pth",
                   "net_sr.pth")


def load_reference_checkpoints(ckpt_dir: str, net):
    """Load the three released checkpoints under ``ckpt_dir`` into a
    ``MARCONet`` (the counterpart of ``marconet_tpu/convert/
    torch_import.py::load_reference_checkpoints``): ``net_transformer_
    encoder.pth``, ``net_prior_generation.pth`` and ``net_sr.pth``, each
    strictly (:func:`load_reference_pth`). Returns ``net``."""
    for name, module in zip(REFERENCE_FILES,
                            (net.encoder, net.prior, net.srnet)):
        load_reference_pth(module, os.path.join(ckpt_dir, name))
    return net


def load_reference_or_random(net, ckpt_dir: str) -> bool:
    """The CLIs' weights: the released checkpoints when all three are under
    ``ckpt_dir`` (True), else a warning and ``net``'s own seeded random
    weights, which run the pipeline but restore nothing (False). The
    behaviour of the JAX CLIs' ``build_params``."""
    if ckpt_dir and all(os.path.exists(os.path.join(ckpt_dir, n))
                        for n in REFERENCE_FILES):
        print(f"Loading reference checkpoints from {ckpt_dir}")
        load_reference_checkpoints(ckpt_dir, net)
        return True
    print(f"WARNING: released checkpoints not found under {ckpt_dir!r} — "
          f"using random weights (pipeline demo only). Put "
          f"{', '.join(REFERENCE_FILES)} there to restore for real.")
    return False


# ---------------------------------------------------------------------------
# front-end: YOLO11 detector and ConvNextViT recognizer
# ---------------------------------------------------------------------------


class ConversionError(RuntimeError):
    """A state dict that does not fit the module it is loaded into."""


def _torch_load(path: str):
    """A plain tensor state dict from ``path``; a file that needs
    unpickling of objects (an ultralytics bundle, a pickled module) is
    refused."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        raise ConversionError(
            f"{path} is not a plain tensor state dict (weights_only load "
            f"failed: {e}); export its state_dict() with torch.save") from e
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return ckpt


_YOLO_LAYERS = re.compile(r"^[bh](\d+)$")


def _yolo_key(path) -> str:
    """A flax path of ``marconet_tpu.models.yolo.YOLO11`` -> the
    ultralytics module path."""
    out = []
    for i, part in enumerate(path):
        m = _YOLO_LAYERS.match(part)
        if i == 0 and m:
            out.append(f"model.{m.group(1)}")
        elif i == 0 and part == "detect":
            out.append("model.23")
        elif re.fullmatch(r"m\d+", part):
            out.append(f"m.{part[1:]}")
        elif re.fullmatch(r"ffn\d", part):
            out.append(f"ffn.{int(part[3:]) - 1}")
        elif re.fullmatch(r"cv[23](_\d)+", part):
            out.append(part.replace("_", "."))
        else:
            out.append(part)
    return ".".join(out)


def yolo_from_jax(variables: Mapping[str, Any]) -> StateDict:
    """``YOLO11`` flax variables (``params`` and ``batch_stats``) ->
    ultralytics-keyed state dict for the port's ``YOLO11`` (the inverse of
    ``marconet_tpu/convert/yolo_import.py::convert_yolo11``)."""
    sd: StateDict = {}

    def walk(tree, path, stats):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,), stats)
                continue
            prefix = _yolo_key(path)
            if stats:                              # bn/{mean,var}
                name = {"mean": "running_mean", "var": "running_var"}[k]
                sd[f"{prefix}.{name}"] = _t(v)
            elif path[-1] == "bn":
                sd[f"{prefix}.{'weight' if k == 'scale' else 'bias'}"] = \
                    _t(v)
            elif k == "kernel":
                conv = "conv." if "bn" in tree else ""
                sd[f"{prefix}.{conv}weight"] = _conv(v)
            else:
                sd[f"{prefix}.bias"] = _t(v)

    walk(variables["params"], (), False)
    walk(variables["batch_stats"], (), True)
    return sd


def load_yolo_checkpoint(path: str) -> StateDict:
    """A YOLO11 checkpoint -> the state dict the port's ``YOLO11`` loads
    strictly. Takes a bare state dict or one under ``state_dict``, as
    ``marconet_tpu/convert/yolo_import.py::load_yolo_checkpoint`` does
    (its ultralytics-bundle case needs the ultralytics package to
    unpickle, so the port refuses such a file), and drops what carries no
    weight: BatchNorm's ``num_batches_tracked`` counters and the Detect
    head's fixed DFL projection (``model.23.dfl.conv.weight``, which must
    be 0..15)."""
    sd = _torch_load(path)
    dfl = sd.get("model.23.dfl.conv.weight")
    if dfl is not None and not torch.equal(
            dfl.float().reshape(-1), torch.arange(dfl.numel()).float()):
        raise ConversionError(f"{path}: model.23.dfl.conv.weight is not the "
                              "fixed 0..15 projection")
    return {k: v.float() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")
            and k != "model.23.dfl.conv.weight"}


# keys of a ModelScope ConvNextViT export that are not mapped by design
_OCR_IGNORE = (r"num_batches_tracked", r"(^|\.)head_dist\.",
               r"(^|\.)dist_token$")


def _find_prefix(keys, marker: str) -> str:
    """The uniform prefix in front of ``marker`` (e.g. 'recognizer.')."""
    cands = {k[:k.index(marker)] for k in keys if marker in k}
    if not cands:
        raise ConversionError(f"no key contains {marker!r}; keys look "
                              f"like: {sorted(keys)[:5]}")
    if len(cands) > 1:
        raise ConversionError(f"ambiguous prefixes for {marker!r}: "
                              f"{sorted(cands)}")
    return cands.pop()


def ocr_state_from_modelscope(sd: Mapping[str, Any],
                              num_heads: Optional[int] = None):
    """A ModelScope ConvNextViT state dict -> (state dict of the port's
    ``ConvNextViT``, ``OCRConfig``): the counterpart of ``marconet_tpu/
    convert/ocr_import.py::convert_modelscope_ocr``. The topology comes
    from the shapes (stage depths and widths, ViT width and depth, class
    count, cls token, projection, final CNN norm, layer scale, the
    positional embedding's length); the head count from ``num_heads`` (the
    export manifest's) or the timm convention of 64-wide heads. Strict: a
    missing key or one that maps nowhere raises ``ConversionError``.
    """
    from marconet_tpu_torch.models.convnext_ocr import (
        ConvNextViT,
        OCRConfig,
    )

    ignore = [re.compile(p) for p in _OCR_IGNORE]
    sd = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()
          if not any(p.search(k) for p in ignore)}
    cp = _find_prefix(sd, "downsample_layers")
    vp = _find_prefix(sd, "blocks.0.norm1")
    cnn_final_norm = f"{cp}norm.weight" in sd and cp != vp

    out: StateDict = {}
    unmapped = []
    for k, v in sd.items():
        rest_c, rest_v = k[len(cp):], k[len(vp):]
        if k.startswith(cp) and rest_c.startswith(("downsample_layers.",
                                                   "stages.")):
            out[rest_c] = v
        elif cnn_final_norm and k.startswith(f"{cp}norm."):
            out[f"cnn_norm.{rest_c[len('norm.'):]}"] = v
        elif k.startswith(vp):
            out[rest_v] = v
        else:
            unmapped.append(k)

    def get(key):
        if key not in out:
            raise ConversionError(f"missing key {key!r}")
        return out[key]

    dims = [get("downsample_layers.0.0.weight").shape[0]]
    while f"downsample_layers.{len(dims)}.1.weight" in out:
        dims.append(out[f"downsample_layers.{len(dims)}.1.weight"].shape[0])
    depths = []
    for s in range(len(dims)):
        n = 0
        while f"stages.{s}.{n}.dwconv.weight" in out:
            n += 1
        if n == 0:
            raise ConversionError(f"stage {s} has no blocks")
        depths.append(n)
    pos = get("pos_embed")
    out["pos_embed"] = pos = pos.reshape(1, pos.shape[-2], pos.shape[-1])
    if "cls_token" in out:
        out["cls_token"] = out["cls_token"].reshape(1, 1, -1)
    proj = out.get("patch_embed.proj.weight")
    if proj is not None and proj.dim() == 4:
        if proj.shape[2] * proj.shape[3] != 1:
            raise ConversionError(
                f"patch_embed.proj kernel {tuple(proj.shape)} is spatial; "
                "the CNN-fed ViT expects a pointwise projection")
        out["patch_embed.proj.weight"] = proj[:, :, 0, 0]
    depth = 0
    while f"blocks.{depth}.norm1.weight" in out:
        depth += 1
    if depth == 0:
        raise ConversionError("no ViT blocks found")
    vit_dim = pos.shape[-1]
    cfg = OCRConfig(
        depths=tuple(depths), dims=tuple(dims), vit_depth=depth,
        vit_dim=vit_dim,
        # not recoverable from shapes, and attention depends on it
        vit_heads=num_heads if num_heads else max(1, vit_dim // 64),
        vit_mlp_ratio=get("blocks.0.mlp.fc1.weight").shape[0] / vit_dim,
        num_classes=get("head.weight").shape[0], blank_index=0,
        use_cls_token="cls_token" in out, use_vit_proj=proj is not None,
        cnn_final_norm=cnn_final_norm,
        layer_scale_init=1e-6 if "stages.0.0.gamma" in out else 0.0,
        seq_len=pos.shape[-2])
    want = ConvNextViT(cfg, device="meta",
                       generator=torch.Generator()).state_dict()
    missing = sorted(set(want) - set(out))
    if missing:
        raise ConversionError(f"missing key(s) {missing[:10]}")
    unmapped += [k for k in out if k not in want]
    if unmapped:
        raise ConversionError(f"{len(unmapped)} unmapped state-dict keys "
                              f"(renamed or extra layers?): "
                              f"{sorted(unmapped)[:10]}")
    return out, cfg


def load_vocab(path: str) -> str:
    """ModelScope ``vocab.txt`` -> charset string (one character a line)."""
    chars = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                chars.append(line[0])
    return "".join(chars)


def load_ocr_checkpoint(path: str):
    """An exported ModelScope recognizer (``.pth`` / ``.pt``) -> (state
    dict, ``OCRConfig``) through :func:`ocr_state_from_modelscope`. An
    ``ocr_key_manifest.json`` beside the file gives the true head count
    (its ``__meta__.num_heads``)."""
    ckpt = _torch_load(path)
    num_heads = None
    manifest = os.path.join(os.path.dirname(path), "ocr_key_manifest.json")
    if os.path.exists(manifest):
        with open(manifest, encoding="utf-8") as f:
            num_heads = json.load(f).get("__meta__", {}).get("num_heads")
    return ocr_state_from_modelscope(
        {k: v.detach().float().numpy() for k, v in ckpt.items()},
        num_heads=num_heads)


def ocr_from_jax(variables: Mapping[str, Any]) -> StateDict:
    """``ConvNextViT`` flax variables -> the port's ``ConvNextViT`` state
    dict (the inverse of ``convert_modelscope_ocr`` after its prefix)."""
    p = variables["params"]
    cnn = p["cnn"]
    sd: StateDict = {"downsample_layers.0.0.weight":
                     _conv(cnn["stem_conv"]["kernel"]),
                     "downsample_layers.0.0.bias":
                     _t(cnn["stem_conv"]["bias"])}
    _norm(sd, "downsample_layers.0.1", cnn["stem_norm"])
    si = 1
    while f"down_conv{si}" in cnn:
        _norm(sd, f"downsample_layers.{si}.0", cnn[f"down_norm{si}"])
        sd[f"downsample_layers.{si}.1.weight"] = _conv(
            cnn[f"down_conv{si}"]["kernel"])
        sd[f"downsample_layers.{si}.1.bias"] = _t(
            cnn[f"down_conv{si}"]["bias"])
        si += 1
    for name, blk in cnn.items():
        m = re.fullmatch(r"stage(\d+)_(\d+)", name)
        if not m:
            continue
        b = f"stages.{m.group(1)}.{m.group(2)}"
        sd[f"{b}.dwconv.weight"] = _conv(blk["dw_kernel"])
        sd[f"{b}.dwconv.bias"] = _t(blk["dw_bias"])
        _norm(sd, f"{b}.norm", blk["norm"])
        _dense(sd, f"{b}.pwconv1", blk["pw1"])
        _dense(sd, f"{b}.pwconv2", blk["pw2"])
        if "gamma" in blk:
            sd[f"{b}.gamma"] = _t(blk["gamma"])
    if "cnn_norm" in p:
        _norm(sd, "cnn_norm", p["cnn_norm"])
    if "vit_proj" in p:
        _dense(sd, "patch_embed.proj", p["vit_proj"])
    if "cls_token" in p:
        sd["cls_token"] = _t(p["cls_token"])
    sd["pos_embed"] = _t(p["pos_embed"])
    i = 0
    while f"block{i}" in p:
        blk, b = p[f"block{i}"], f"blocks.{i}"
        _norm(sd, f"{b}.norm1", blk["norm1"])
        _dense(sd, f"{b}.attn.qkv", blk["qkv"])
        _dense(sd, f"{b}.attn.proj", blk["proj"])
        _norm(sd, f"{b}.norm2", blk["norm2"])
        _dense(sd, f"{b}.mlp.fc1", blk["mlp1"])
        _dense(sd, f"{b}.mlp.fc2", blk["mlp2"])
        i += 1
    _norm(sd, "norm", p["norm"])
    _dense(sd, "head", p["head"])
    return sd


# ---------------------------------------------------------------------------
# legacy TransformerOCR (reference models/ocr.py:310-370)
# ---------------------------------------------------------------------------

# keys of a released ``TransformerOCR`` state dict that the port's module
# does not hold, as the JAX package's ``convert_legacy_ocr`` ignores them:
# BN step counters, the positional-encoding buffer (recomputed) and a
# submodule the reference never calls
LEGACY_OCR_IGNORED = re.compile(
    r"(num_batches_tracked$|^pe\.pe$|compress_attention_linear)")


def _bn_from_jax(sd: StateDict, prefix: str, p, s) -> None:
    _norm(sd, prefix, p)
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])


def _conv_bias(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _conv(p["kernel"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def legacy_ocr_from_jax(variables: Mapping[str, Any]) -> StateDict:
    """``LegacyTransformerOCR`` flax variables -> a state dict under the
    reference's ``TransformerOCR`` key names (the inverse of
    ``convert_legacy_ocr``, less the keys it ignores)."""
    p, s = variables["params"], variables["batch_stats"]
    ep, es = p["encoder"], s["encoder"]
    sd: StateDict = {"embedding_word.lut.weight":
                     _t(p["embedding"]["embedding"])}
    for i in (1, 2):
        _conv_bias(sd, f"encoder.conv{i}", ep[f"conv{i}"])
        _bn_from_jax(sd, f"encoder.bn{i}", ep[f"bn{i}"], es[f"bn{i}"])
    for name, blk in ep.items():
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if not m:
            continue
        base, bs = f"encoder.layer{m.group(1)}.{m.group(2)}", es[name]
        for j in (1, 2):
            _conv_bias(sd, f"{base}.conv{j}", blk[f"conv{j}"])
            _bn_from_jax(sd, f"{base}.bn{j}", blk[f"bn{j}"], bs[f"bn{j}"])
        if "down_conv" in blk:
            _conv_bias(sd, f"{base}.downsample.0", blk["down_conv"])
            _bn_from_jax(sd, f"{base}.downsample.1", blk["down_bn"],
                         bs["down_bn"])
    for li in (1, 2, 3):
        _conv_bias(sd, f"encoder.layer{li}_conv", ep[f"layer{li}_conv"])
        _bn_from_jax(sd, f"encoder.layer{li}_bn", ep[f"layer{li}_bn"],
                     es[f"layer{li}_bn"])
    _conv_bias(sd, "encoder.layer4_conv2", ep["out_conv"])
    _bn_from_jax(sd, "encoder.layer4_conv2_bn", ep["out_bn"], es["out_bn"])
    dec = p["decoder"]
    for attn, name in (("self_attn", "mask_multihead"),
                       ("cross_attn", "multihead")):
        for i, proj in enumerate(("q", "k", "v", "out")):
            _dense(sd, f"decoder.{name}.linears.{i}", dec[attn][proj])
    for i in (1, 2, 3):
        sd[f"decoder.mul_layernorm{i}.a_2"] = _t(dec[f"norm{i}"]["scale"])
        sd[f"decoder.mul_layernorm{i}.b_2"] = _t(dec[f"norm{i}"]["bias"])
    _dense(sd, "decoder.pff.w_1", dec["ff1"])
    _dense(sd, "decoder.pff.w_2", dec["ff2"])
    _dense(sd, "generator_word.proj", p["generator"])
    if "loc_head" in p:
        _dense(sd, "generator_loc.proj", p["loc_head"])
    return sd


def load_legacy_ocr(model: nn.Module, state: Mapping[str, Any]
                    ) -> nn.Module:
    """Strictly load a ``TransformerOCR`` state dict (a released
    ``net_real_world_ocr.pth`` / ``net_new_bbox.pth``, or
    :func:`legacy_ocr_from_jax`'s) into a ``LegacyTransformerOCR``: the
    keys of ``LEGACY_OCR_IGNORED`` are dropped, any other missing, extra or
    misshapen key raises."""
    sd = {k: torch.as_tensor(np.asarray(v, np.float32))
          if not torch.is_tensor(v) else v.float()
          for k, v in state.items() if not LEGACY_OCR_IGNORED.search(k)}
    model.load_state_dict(sd, strict=True)
    return model
