"""JAX param trees -> the port's `state_dict`.

A NumPy-only mirror of egohmr_tpu/interop/torch_export.py:export_egohmr
(which cannot be imported here: importing any `egohmr_tpu` module imports
JAX). The output uses the reference key layout, so
`EgoHMR.load_state_dict(state_dict_from_jax(params), strict=True)` loads
JAX-trained weights, and the reference's released `.pt` files load as they
are. Every array is copied, never aliased.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Flat = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)  # copies


def _lin(out: Flat, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = np.ascontiguousarray(_np(p["w"]).T)
    if "b" in p:
        out[prefix + ".bias"] = _np(p["b"])


def _conv(out: Flat, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = np.ascontiguousarray(
        _np(p["w"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _bn(out: Flat, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _np(p["scale"])
    out[prefix + ".bias"] = _np(p["bias"])
    out[prefix + ".running_mean"] = _np(p["mean"])
    out[prefix + ".running_var"] = _np(p["var"])
    out[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _resnet(out: Flat, prefix: str, p: dict) -> None:
    _conv(out, prefix + "conv1", p["conv1"])
    _bn(out, prefix + "bn1", p["bn1"])
    for li in range(1, 5):
        for b, blk in enumerate(p.get(f"layer{li}", ())):
            base = f"{prefix}layer{li}.{b}."
            for i in (1, 2, 3):
                if f"conv{i}" in blk:
                    _conv(out, base + f"conv{i}", blk[f"conv{i}"])
                    _bn(out, base + f"bn{i}", blk[f"bn{i}"])
            if "downsample" in blk:
                _conv(out, base + "downsample.0", blk["downsample"]["conv"])
                _bn(out, base + "downsample.1", blk["downsample"]["bn"])


def _pointnet(out: Flat, prefix: str, p: dict) -> None:
    _lin(out, prefix + "fc_pos_0", p["fc_pos_0"])
    for i in range(4):
        blk = p[f"block_{i}"]
        for name in ("fc_0", "fc_1", "shortcut"):
            if name in blk:
                _lin(out, f"{prefix}block_{i}.{name}", blk[name])
    _lin(out, prefix + "fc_c", p["fc_c"])


def _gconv(out: Flat, prefix: str, p: dict) -> None:
    for k in ("W", "M", "adj2", "bias"):
        out[f"{prefix}.{k}"] = _np(p[k])


def _graph_conv(out: Flat, prefix: str, p: dict) -> None:
    _gconv(out, prefix + ".gconv", p["gconv"])
    _bn(out, prefix + ".bn", p["bn"])


def _linear_as_conv1x1(out: Flat, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = np.ascontiguousarray(_np(p["w"]).T)[:, :, None, None]
    if "b" in p:
        out[prefix + ".bias"] = _np(p["b"])


def _gcn(out: Flat, prefix: str, p: dict) -> None:
    _graph_conv(out, prefix + "gconv_input.0", p["gconv_input"])
    for i, blk in enumerate(p["gconv_layers"]):
        _graph_conv(out, f"{prefix}gconv_layers.{i}.gconv1", blk["gconv1"])
        _graph_conv(out, f"{prefix}gconv_layers.{i}.gconv2", blk["gconv2"])
    _gconv(out, prefix + "gconv_output", p["gconv_output"])
    if "non_local" in p:  # 1x1 Conv2d modules over [B, C, 1, 24] in the reference
        nl = p["non_local"]
        for name in ("g", "theta", "phi"):
            _linear_as_conv1x1(out, f"{prefix}non_local.{name}", nl[name])
        _linear_as_conv1x1(out, prefix + "non_local.W.0", nl["w"])
        _bn(out, prefix + "non_local.W.1", nl["bn"])


def export_arrays(params: dict) -> Flat:
    """Stage-2 param tree -> {reference state_dict key: NumPy array}."""
    out: Flat = {}
    _resnet(out, "backbone.", params["backbone"])
    _pointnet(out, "scene_enc.", params["scene_enc"])
    _lin(out, "transl_enc.layers.0", params["transl_enc"]["l0"])
    _lin(out, "transl_enc.layers.2", params["transl_enc"]["l1"])
    _lin(out, "embed_timestep.time_embed.0", params["embed_timestep"]["l0"])
    _lin(out, "embed_timestep.time_embed.2", params["embed_timestep"]["l1"])
    _lin(out, "input_process.poseEmbedding",
         params["input_process"]["poseEmbedding"])
    _gcn(out, "diffusion_model.", params["diffusion_model"])
    _lin(out, "beta_layer.layers.0", params["beta_layer"]["l0"])
    _lin(out, "beta_layer.layers.2", params["beta_layer"]["l1"])
    out["beta_layer.init_betas"] = _np(
        params["beta_layer"]["init_betas"]).reshape(1, 10)
    return out


def state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """Stage-2 param tree (NumPy or JAX arrays) -> the port's state_dict."""
    return {k: torch.from_numpy(v) for k, v in export_arrays(params).items()}
