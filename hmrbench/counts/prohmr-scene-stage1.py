"""Operations and bytes of the `prohmr-scene-stage1` configuration, from
its widths and a request's shapes: the model FLOPs of `mfu` and the least
work of kernel K1 (the scene PointNet). A count is the model's arithmetic
as published, whatever implements it; the shared layers are counted in
lib/flops.py."""
from __future__ import annotations

from typing import Dict

from hmrbench.lib.flops import k1_bound, pointnet_flops, resnet50_flops, smpl_flops


def context_dim(m: Dict) -> int:
    return 6 + m["img_feat_dim"] + m["scene_feat_dim"]


def flow_flops(m: Dict) -> float:
    """The flow's inverse for one body: per step the coupling's residual
    net (its input half and the context in, the scale and shift out, each
    block two hidden layers and a context gate), the LU map's solve."""
    F, H, C = m["flow_dim"], m["flow_hidden"], context_dim(m)
    half = F // 2
    net = (half + C) * H + m["flow_depth"] * (2 * H * H + C * H) + H * 2 * half
    return 2.0 * m["flow_layers"] * (net + F * F)


def head_flops(m: Dict) -> float:
    return 2.0 * (context_dim(m) * m["fc_head_hidden"] + m["fc_head_hidden"] * 13)


def per_request(cfg: Dict, st: Dict) -> Dict[str, float]:
    """Counts of one batch of `st["B"]` images x `st["S"]` samples."""
    m, inp, V = cfg["model"], cfg["inputs"], cfg["smpl"]["num_vertices"]
    B, N = st["B"], st["B"] * st["S"]
    flops = B * (resnet50_flops(inp["img_size"]) + pointnet_flops(m, inp["scene_points"])
                 + head_flops(m))
    flops += N * (flow_flops(m) + smpl_flops(V))
    return {"flops": flops, "bodies": N,
            "k1_calls": 1.0 if st["pointnet_impl"] == "fused" else 0.0,
            "k1_bound_s": k1_bound(m, B, inp["scene_points"])}
