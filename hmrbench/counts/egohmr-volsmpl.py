"""Operations of the `egohmr-volsmpl` configuration's guided request: stage
2's (`counts/egohmr-stage2.py`: ResNet-50, the scene PointNet, the heads,
two denoiser passes a step, SMPL) and the learned part-wise field's.

The field's count is its rows: guided steps x bodies x 24 parts x scene
points, each through the decoder (the local point's 3 columns of the first
layer, then hidden x hidden layers and the one-wide head) forward, and as
many again for the gradient w.r.t. its input on the way back. The latent
encoder runs once per (body, part) and is left out (under 0.01%). These
are f32 operations on CUDA cores (TF32 off): `field_roofline` holds them
to the f32 peak.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

from hmrbench.lib.common import load_file

_STAGE2 = load_file(Path(__file__).with_name("egohmr-stage2.py"))
PARTS = 24


def field_row_flops(net: Dict) -> float:
    """Forward operations of one (body, part, point) row of the decoder."""
    hid = net["hidden_dim"]
    return 2.0 * (3 * hid + (net["num_layers"] - 2) * hid * hid + hid)


def per_request(cfg: Dict, st: Dict) -> Dict[str, float]:
    """Counts of one served guided request (`st`: the driver's setting, with
    `guided_steps` and `guide_points`, the scene points the field reads)."""
    out = _STAGE2.per_request(cfg, st)
    rows = st["guided_steps"] * st["B"] * st["S"] * PARTS * st["guide_points"]
    field = 2.0 * rows * field_row_flops(cfg["collision"]["net"])
    out.update(flops=out["flops"] + field, field_rows=float(rows), field_flops=field)
    return out
