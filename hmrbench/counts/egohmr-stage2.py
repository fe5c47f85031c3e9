"""Operations and bytes of the `egohmr-stage2` configuration, from its
widths and a request's shapes: the model FLOPs of `mfu` and the least work
of kernel K1 (the scene PointNet).

A count is the model's arithmetic as published, whatever implements it:
the classifier-free sampler makes two denoiser passes a step. The layers
both stages share are counted in lib/flops.py.
"""
from __future__ import annotations

from typing import Dict

from hmrbench.lib.flops import k1_bound, pointnet_flops, resnet50_flops, smpl_flops


def context_dim(m: Dict) -> int:
    return m["img_feat_dim"] + m["scene_feat_dim"] + m["transl_embed_dim"] + 6


def heads_flops(m: Dict) -> float:
    """Translation encoder and betas head, per image."""
    return 2.0 * (3 * 64 + 64 * m["transl_embed_dim"] + context_dim(m) * 1024 + 1024 * 10)


def gcn_pass_flops(m: Dict) -> float:
    """One denoiser pass for one body: the embeddings and the modulated GCN
    over 24 joints (input layer, residual layers, output layer)."""
    hid, d_t, d_x = m["gcn_hid_dim"], m["timestep_embed_dim"], m["input_process_dim"]
    d_in = context_dim(m) + d_x + d_t
    mix = 2 * 24 * 24  # the two adjacency products, per channel
    macs = 2 * d_t * d_t + 24 * 6 * d_x
    macs += 24 * d_in * hid * 2 + mix * hid
    macs += m["gcn_layers"] * 2 * (24 * hid * hid * 2 + mix * hid)
    macs += 24 * hid * 6 * 2 + mix * 6
    return 2.0 * macs


def per_request(cfg: Dict, st: Dict) -> Dict[str, float]:
    """Counts of one served request (`st`: the driver's setting; unguided,
    DDIM over `respacing`'s steps)."""
    m, inp, V = cfg["model"], cfg["inputs"], cfg["smpl"]["num_vertices"]
    B, N = st["B"], st["B"] * st["S"]
    steps = int(st["respacing"][len("ddim"):])
    flops = B * (resnet50_flops(inp["img_size"]) + pointnet_flops(m, inp["scene_points"])
                 + heads_flops(m))
    flops += N * (steps * 2 * gcn_pass_flops(m) + smpl_flops(V))
    return {"flops": flops, "bodies": N,
            "k1_calls": 1.0 if st["pointnet_impl"] == "fused" else 0.0,
            "k1_bound_s": k1_bound(m, B, inp["scene_points"])}

