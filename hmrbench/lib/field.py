"""The learned collision field's weights, made from the seed.

A part-wise SDF net at its initialisation (`PartFieldNet`'s U(+-1/sqrt(in))
draw) is nearly constant: over a scene its raw output moves by under 1% of
its mean, so either no point lies inside the body or every one does, and
the guidance is nil or uniform. So the decoder's weights are drawn as a
trained field's keep their signal, He-normal (std sqrt(2 / fan_in)), its
biases zero, the encoder's and the part code as at initialisation. The
first decoder layer's latent columns are then scaled by `LATENT_SHARE`:
at their full share one part's code can win the min over parts for every
point, and the guidance, which moves only the leg joints, reads zero on
every body of a request; at a tenth the parts differ by their frames, as
a body's parts do. Last, the head's bias is set so that `INSIDE` of the
calibration bodies' scene points lies inside them: the drivers pass the
bodies the cell's first request samples, so that the guided steps, whose
bodies are near those, find an inside and an outside on every seed. The
calibration uses the plain reference's field (`reference/
egohmr-volsmpl.py`), not the program's.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from hmrbench.lib import synth
from hmrbench.lib.common import BENCH, load_file

INSIDE = 0.05  # share of the calibration bodies' scene points inside them
LATENT_SHARE = 0.1


@torch.no_grad()
def field_weights(net: torch.nn.Module, ncfg: Dict, seed: int, tables: Dict, scene: torch.Tensor,
                  rot: torch.Tensor, betas: torch.Tensor,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """A state dict for `net` (a shared-layout part-wise SDF net of widths
    `ncfg`) drawn from `seed` on `device`, its head's bias set so that
    `INSIDE` of the canonical scenes `scene` [N, P, 3] lies inside the
    bodies of local rotations `rot` [N, 24, 3, 3] and betas [N, 10] of the
    body tables `tables`."""
    layers = ncfg["num_layers"]
    rules = [("part_embed", "n", 0.1, 0.0)]
    for i in range(layers):
        fan_in = net.decoder[i].in_features
        rules += [(f"decoder.{i}.weight", "n", math.sqrt(2.0 / fan_in), 0.0),
                  (f"decoder.{i}.bias", "c", 0.0, 0.0)]
    Wf = synth.weights(net, seed, device, extra_rules=rules)
    Wf["decoder.0.weight"][:, 3:] *= LATENT_SHARE
    G = load_file(BENCH / "reference" / "egohmr-volsmpl.py")
    R, P = G.skeleton(tables, betas, rot)
    dec0 = G.field_latent(Wf, ncfg, R, P, betas)
    # the raw field's min over parts: its sign is the sdf's
    raw = torch.cat([G.field_raw(Wf, ncfg, R, P, dec0, pts).amin(dim=1).flatten()
                     for pts in scene.split(1024, dim=1)])
    head = f"decoder.{layers - 1}.bias"
    Wf[head] = Wf[head] - torch.quantile(raw, INSIDE)
    return Wf
