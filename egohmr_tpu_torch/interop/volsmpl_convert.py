"""A VolumetricSMPL release's weights -> the signed-distance net's param
tree (copy of egohmr_tpu/interop/volsmpl_convert.py).

VolumetricSMPL keeps COAP's per-part MLP organisation with a signed-distance
head, so `convert_volsmpl` unwraps a Lightning checkpoint (`state_dict`),
strips the attach-point prefix and reuses `coap_convert`'s per-part
discovery and stacking. The result is the `per_part_networks` layout of
`collision/neural_sdf.py` with an unbounded head.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from .coap_convert import _PART_PATTERNS, _stack_parts, _walk_sequential, check_feature_contract

Flat = Mapping[str, np.ndarray]

# wrapper prefixes of Lightning / attach-point checkpoints, tried in order
_STRIP_PREFIXES = ("", "coap.", "volume.", "model.", "model.coap.",
                   "smpl.coap.", "smpl_volsmpl.volume.")


def convert_volsmpl(sd: Flat, *, num_parts: int = 24, enc_fmt: Optional[str] = None,
                    dec_fmt: Optional[str] = None, activation: str = "leaky_relu",
                    strict_feature_contract: bool = True):
    """A VolumetricSMPL-layout state_dict, flat or as a Lightning checkpoint
    (`{'state_dict': {...}}`) -> (params, SDFNetConfig) for
    `collision.neural_sdf`."""
    from ..collision.neural_occupancy import NUM_PARTS
    from ..collision.neural_sdf import SDFNetConfig

    if num_parts != NUM_PARTS:
        raise ValueError(
            f"convert_volsmpl: this framework decomposes the body into {NUM_PARTS} "
            f"parts; a {num_parts}-part release needs a part-assignment map added "
            "to collision/neural_sdf.py first")
    if "state_dict" in sd and isinstance(sd["state_dict"], Mapping):
        sd = sd["state_dict"]
    if enc_fmt is None or dec_fmt is None:
        # a (prefix, pattern) pair counts only if part 0's Sequentials walk
        # to Linears under it: a prefix match alone can hit a pattern that
        # misses the '.net' level
        found = None
        for strip in _STRIP_PREFIXES:
            trial = ({k[len(strip):]: v for k, v in sd.items() if k.startswith(strip)}
                     if strip else dict(sd))
            for e_fmt, d_fmt in _PART_PATTERNS:
                if (_walk_sequential(trial, e_fmt.format(k=0))
                        and _walk_sequential(trial, d_fmt.format(k=0))):
                    found = ((e_fmt, d_fmt), trial)
                    break
            if found:
                break
        if found is None:
            raise ValueError(
                "convert_volsmpl: no per-part module pattern matched this state "
                f"dict under any of the prefixes {_STRIP_PREFIXES}. The dict "
                f"starts with keys {sorted(sd)[:10]}. Pass enc_fmt/dec_fmt "
                "matching the release's layout ('{k}' = part index).")
        (enc_fmt, dec_fmt), sd = found
    enc = _stack_parts(sd, enc_fmt, "encoder", num_parts, "convert_volsmpl")
    dec = _stack_parts(sd, dec_fmt, "decoder", num_parts, "convert_volsmpl")
    if strict_feature_contract:
        check_feature_contract(enc, dec, "convert_volsmpl", "sdf_query")
    if int(dec[-1]["w"].shape[2]) != 1:
        raise ValueError(
            f"convert_volsmpl: decoder output dim {dec[-1]['w'].shape[2]} != 1 "
            "(signed distance)")
    cfg = SDFNetConfig(
        latent_dim=int(enc[-1]["w"].shape[2]),
        hidden_dim=int(dec[0]["w"].shape[2]) if len(dec) > 1 else 0,
        num_layers=len(dec), part_embed_dim=0, per_part_networks=True,
        activation=activation,
        bounded_output=False)  # releases regress raw signed distance
    return {"part_encoder": enc, "part_decoder": dec}, cfg
