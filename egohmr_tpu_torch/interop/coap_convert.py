"""A COAP release's weights -> the occupancy net's param tree (NumPy copy of
egohmr_tpu/interop/coap_convert.py, which imports JAX).

COAP (part-wise neural body occupancy) keeps one encoder and one decoder
MLP per body part, each a torch `nn.Sequential` of Linear layers.
`convert_coap` finds the per-part prefix, walks each Sequential's Linears
(activation slots own no params), transposes [out, in] -> [in, out] and
stacks the parts into [K, in, out] leaves: the `per_part_networks` layout
of `collision/neural_occupancy.py`, in the JAX package's tree form, which
`interop.collision_net_from_jax` loads. The encoder must take the 22
features per part that the query assembles (rot 9 + transl 3 + betas 10),
and the decoder 3 + latent; a release with another feature contract fails
loudly.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

Flat = Mapping[str, np.ndarray]

# per-part module prefixes tried in order; '{k}' is the part index (torch
# flattens nn.ModuleList entries by index)
_PART_PATTERNS: Tuple[Tuple[str, str], ...] = (
    ("part_encoders.{k}.net", "part_decoders.{k}.net"),
    ("part_encoders.{k}", "part_decoders.{k}"),
    ("encoders.{k}.net", "decoders.{k}.net"),
    ("encoders.{k}", "decoders.{k}"),
    ("coap.part_encoders.{k}", "coap.part_decoders.{k}"),
)


def _stack_parts(sd: Flat, fmt: str, what: str, num_parts: int,
                 who: str) -> List[Dict[str, np.ndarray]]:
    """Walk each part's Sequential under `fmt` and stack its Linears into
    [K, in, out] leaves, checking that every part's net has the same
    layers. Shared with `convert_volsmpl`; `who` names the caller in
    errors."""
    per_part = []
    for k in range(num_parts):
        layers = _walk_sequential(sd, fmt.format(k=k))
        if not layers:
            raise ValueError(
                f"{who}: no Linear layers found for {what} part {k} under "
                f"'{fmt.format(k=k)}': the checkpoint has {len(sd)} keys; is "
                f"num_parts={num_parts} right for this release?")
        per_part.append(layers)
    depth = len(per_part[0])
    for k, layers in enumerate(per_part):
        if len(layers) != depth:
            raise ValueError(
                f"{who}: {what} part {k} has {len(layers)} Linear layers but "
                f"part 0 has {depth}: per-part nets must be architecturally "
                "identical to stack")
        for i, layer in enumerate(layers):
            if layer["w"].shape != per_part[0][i]["w"].shape:
                raise ValueError(
                    f"{who}: {what} part {k} layer {i} shape {layer['w'].shape} "
                    f"!= part 0's {per_part[0][i]['w'].shape}")
    return [{"w": np.stack([p[i]["w"] for p in per_part]),
             "b": np.stack([p[i]["b"] for p in per_part])}
            for i in range(depth)]


def _walk_sequential(sd: Flat, prefix: str) -> List[Dict[str, np.ndarray]]:
    """The Linear layers of a torch nn.Sequential under `prefix`, in order:
    the indices with a `.weight` (activation modules own none)."""
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.weight$")
    idxs = sorted(int(m.group(1)) for m in map(pat.match, sd) if m)
    layers = []
    for i in idxs:
        w = np.asarray(sd[f"{prefix}.{i}.weight"])
        if w.ndim != 2:
            raise ValueError(
                f"{prefix}.{i}.weight has shape {w.shape}; expected a 2-D Linear "
                "weight: non-MLP per-part networks need a converter of their own")
        bkey = f"{prefix}.{i}.bias"
        layers.append({"w": w.T.copy(),  # torch [out, in] -> [in, out]
                       "b": (np.array(sd[bkey]) if bkey in sd
                             else np.zeros((w.shape[0],), w.dtype))})
    return layers


def _discover_pattern(sd: Flat, patterns: Sequence[Tuple[str, str]]) -> Tuple[str, str]:
    for enc_fmt, dec_fmt in patterns:
        if any(k.startswith(enc_fmt.format(k=0) + ".") for k in sd):
            return enc_fmt, dec_fmt
    raise ValueError(
        "convert_coap: no per-part module pattern matched this state dict. "
        f"Tried prefixes {[p[0] for p in patterns]}; the dict starts with "
        f"keys {sorted(sd)[:10]}. Pass enc_fmt/dec_fmt matching the release's "
        "layout (use '{k}' for the part index).")


def check_feature_contract(enc, dec, who: str, query: str) -> None:
    """The encoder must take the query's 22 features per part and the
    decoder the local point's 3 + latent."""
    enc_in, latent = int(enc[0]["w"].shape[1]), int(enc[-1]["w"].shape[2])
    dec_in = int(dec[0]["w"].shape[1])
    if enc_in != 22:
        raise ValueError(
            f"{who}: encoder expects {enc_in}-d input but this framework feeds "
            f"22 dims per part (rot 9 + transl 3 + betas 10 - {query}). A "
            "release with another feature contract converts with "
            f"strict_feature_contract=False, but {query}'s feature assembly "
            "must be extended to match before use.")
    if dec_in != 3 + latent:
        raise ValueError(
            f"{who}: decoder expects {dec_in}-d input but the query feeds "
            f"local-point 3 + latent {latent} = {3 + latent} dims.")


def convert_coap(sd: Flat, *, num_parts: int = 24, enc_fmt: Optional[str] = None,
                 dec_fmt: Optional[str] = None, activation: str = "leaky_relu",
                 strict_feature_contract: bool = True):
    """A COAP-layout torch state_dict (flat {name: array}) -> (params,
    OccupancyConfig) for `collision.neural_occupancy`. `num_parts` per-part
    MLPs for the encoder and the decoder, each a Sequential of Linears under
    `enc_fmt.format(k=k)` / `dec_fmt` (found among common namings when not
    given); all parts must share layer shapes, since they are stacked."""
    from ..collision.neural_occupancy import NUM_PARTS, OccupancyConfig

    if num_parts != NUM_PARTS:
        raise ValueError(
            f"convert_coap: this framework decomposes the body into {NUM_PARTS} "
            f"parts (one per SMPL joint); a {num_parts}-part release needs a "
            "part-assignment map added to collision/neural_occupancy.py first")
    if enc_fmt is None or dec_fmt is None:
        enc_fmt, dec_fmt = _discover_pattern(sd, _PART_PATTERNS)
    enc = _stack_parts(sd, enc_fmt, "encoder", num_parts, "convert_coap")
    dec = _stack_parts(sd, dec_fmt, "decoder", num_parts, "convert_coap")
    if strict_feature_contract:
        check_feature_contract(enc, dec, "convert_coap", "occupancy_query")
    if int(dec[-1]["w"].shape[2]) != 1:
        raise ValueError(
            f"convert_coap: decoder output dim {dec[-1]['w'].shape[2]} != 1 "
            "(occupancy logit)")
    cfg = OccupancyConfig(
        latent_dim=int(enc[-1]["w"].shape[2]),
        hidden_dim=int(dec[0]["w"].shape[2]) if len(dec) > 1 else 0,
        num_layers=len(dec), per_part_networks=True, activation=activation)
    return {"part_encoder": enc, "part_decoder": dec}, cfg
