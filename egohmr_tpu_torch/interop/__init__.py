"""JAX param trees -> the port's `state_dict`.

NumPy-only mirrors of egohmr_tpu/interop/torch_export.py's
`export_egohmr`, `export_prohmr` (with `export_conditional_glow`) and
`export_discriminator` (which cannot be imported here: importing any
`egohmr_tpu` module imports JAX), and the two-way map of the learned
collision nets' weights (`collision_net_state_dict_from_jax`,
`collision_net_from_jax`, `collision_net_to_jax`). The converters of the
COAP and VolumetricSMPL releases are `interop.coap_convert` and
`interop.volsmpl_convert`. The output uses the reference key layout,
so `EgoHMR.load_state_dict(state_dict_from_jax(params), strict=True)`,
`ProHMR.load_state_dict(prohmr_state_dict_from_jax(params), strict=True)`
and `Discriminator.load_state_dict(discriminator_state_dict_from_jax(p),
strict=True)` load JAX-trained weights, and the reference's released `.pt`
files load as they are. Every array is copied, never aliased.
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


def export_conditional_glow(p: dict, prefix: str = "flow.flow.") -> Flat:
    """Glow param tree -> the nflows `ConditionalGlow` keys (ActNorm,
    LULinear and coupling at `_transform._transforms.{3k, 3k+1, 3k+2}`)."""
    out: Flat = {}
    b = f"{prefix}_transform._transforms."
    for k, step in enumerate(p["steps"]):
        an, lu = step["actnorm"], step["linear"]
        out[f"{b}{3 * k}.log_scale"] = _np(an["log_scale"]).reshape(1, -1)
        out[f"{b}{3 * k}.shift"] = _np(an["shift"]).reshape(1, -1)
        for name in ("lower_entries", "upper_entries", "unconstrained_upper_diag", "bias"):
            out[f"{b}{3 * k + 1}.{name}"] = _np(lu[name])
        net = step["coupling"]["net"]
        net_prefix = f"{b}{3 * k + 2}.transform_net."
        _lin(out, net_prefix + "initial_layer", net["initial_layer"])
        _lin(out, net_prefix + "final_layer", net["final_layer"])
        for j, blk in enumerate(net["blocks"]):
            _lin(out, f"{net_prefix}blocks.{j}.linear_layers.0", blk["l0"])
            _lin(out, f"{net_prefix}blocks.{j}.linear_layers.1", blk["l1"])
            if "context_layer" in blk:
                _lin(out, f"{net_prefix}blocks.{j}.context_layer", blk["context_layer"])
    return out


def export_prohmr(params: dict) -> Flat:
    """Stage-1 param tree -> {reference state_dict key: NumPy array}."""
    out: Flat = {}
    _resnet(out, "backbone.", params["backbone"])
    _pointnet(out, "scene_enc.", params["scene_enc"])
    out.update(export_conditional_glow(params["flow"], "flow.flow."))
    head = params["fc_head"]
    _lin(out, "flow.fc_head.layers.0", head["l0"])
    _lin(out, "flow.fc_head.layers.2", head["l1"])
    out["flow.fc_head.init_betas"] = _np(head["init_betas"]).reshape(1, 10)
    out["flow.fc_head.init_cam"] = _np(head["init_cam"]).reshape(1, 3)
    return out


def export_discriminator(p: dict, prefix: str = "discriminator.") -> Flat:
    """Discriminator param tree -> the reference keys: the per-joint 1x1
    convolutions as [out, in, 1, 1], everything else as linears."""
    out: Flat = {}
    for name in ("D_conv1", "D_conv2"):
        _linear_as_conv1x1(out, prefix + name, p[name])
    for i, lp in enumerate(p["pose_out"]):
        _lin(out, f"{prefix}pose_out.{i}", lp)
    for name in ("betas_fc1", "betas_fc2", "betas_out",
                 "D_alljoints_fc1", "D_alljoints_fc2", "D_alljoints_out"):
        _lin(out, prefix + name, p[name])
    return out


def prohmr_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """Stage-1 param tree (NumPy or JAX arrays) -> `ProHMR`'s state_dict."""
    return {k: torch.from_numpy(v) for k, v in export_prohmr(params).items()}


def discriminator_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """Discriminator param tree -> `Discriminator`'s state_dict (no
    `discriminator.` prefix)."""
    return {k: torch.from_numpy(v) for k, v in export_discriminator(params, "").items()}


def collision_net_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """A learned collision net's param tree (either backend, either layout;
    what the JAX package's `init_occupancy`/`init_sdfnet`, its converters and
    `load_npz_tree` give) -> `PartFieldNet`'s state_dict. The shared
    layout's `encoder.l*` and `decoder.i` become `nn.Linear`s, so their
    [in, out] `w` is transposed to `weight` [out, in]; the
    `per_part_networks` stacks keep their [K, in, out] layout."""
    out: Flat = {}
    if "part_encoder" in params:
        for name in ("part_encoder", "part_decoder"):
            for i, lp in enumerate(params[name]):
                out[f"{name}.{i}.weight"] = _np(lp["w"])
                out[f"{name}.{i}.bias"] = _np(lp["b"])
    else:
        for name in ("l0", "l1"):
            _lin(out, f"encoder.{name}", params["encoder"][name])
        for i, lp in enumerate(params["decoder"]):
            _lin(out, f"decoder.{i}", lp)
        if "part_embed" in params:
            out["part_embed"] = _np(params["part_embed"])
    return {k: torch.from_numpy(v) for k, v in out.items()}


def collision_net_from_jax(params: dict, cfg):
    """A `PartFieldNet` holding `params` (strict load). The shared layout is
    built from `cfg` and must match it; the per-part layout's widths come
    from the arrays, which `cfg` does not all hold."""
    from ..collision.neural_occupancy import PartFieldNet

    dims = {}
    if cfg.per_part_networks:
        for name, key in (("part_encoder", "enc_dims"), ("part_decoder", "dec_dims")):
            shapes = [np.shape(lp["w"]) for lp in params[name]]
            dims[key] = [shapes[0][1]] + [s[2] for s in shapes]
    net = PartFieldNet(cfg, **dims)
    net.load_state_dict(collision_net_state_dict_from_jax(params), strict=True)
    return net


def collision_net_to_jax(net) -> dict:
    """The inverse: a `PartFieldNet` -> the JAX package's param tree, as
    NumPy arrays (what `utils.checkpoint.save_npz` writes and the JAX
    package's `load_occupancy`/`load_sdfnet` read)."""
    def arr(t):
        return t.detach().float().cpu().numpy().copy()

    def lin(m):
        return {"w": np.ascontiguousarray(arr(m.weight).T), "b": arr(m.bias)}

    if net.cfg.per_part_networks:
        return {name: [{"w": arr(lp.weight), "b": arr(lp.bias)} for lp in getattr(net, name)]
                for name in ("part_encoder", "part_decoder")}
    tree = {"encoder": {k: lin(net.encoder[k]) for k in ("l0", "l1")},
            "decoder": [lin(m) for m in net.decoder]}
    if hasattr(net, "part_embed"):
        tree["part_embed"] = arr(net.part_embed)
    return tree
