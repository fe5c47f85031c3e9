"""Operation and byte counts shared by the configurations' count files:
ResNet-50's convolutions, the ResnetPointnet scene encoder, SMPL skinning,
and the least work of kernel K1 (the scene PointNet). A matmul of
[m, k] x [k, n] is 2 m k n operations. K1's count is that of the port's
tools/time_kernels.py and chip_smoke.py (`k1_bound`): its per-point
products, bf16 points and weights in, the f32 feature out."""
from __future__ import annotations

from typing import Dict

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
RESNET50_BLOCKS = (3, 4, 6, 3)


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time: operations at the peak rate or bytes at the memory
    rate, whichever is longer."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def resnet50_flops(img: int) -> float:
    """Convolutions of ResNet-50 on one img x img image."""
    def out(s, k, stride, pad):
        return (s + 2 * pad - k) // stride + 1

    s = out(img, 7, 2, 3)
    macs = s * s * 64 * 7 * 7 * 3
    s = out(s, 3, 2, 1)  # max pool
    cin = 64
    for li, (planes, n) in enumerate(zip((64, 128, 256, 512), RESNET50_BLOCKS)):
        for b in range(n):
            stride = 2 if (li > 0 and b == 0) else 1
            s_out = out(s, 3, stride, 1)
            macs += s * s * cin * planes                 # 1x1
            macs += s_out * s_out * planes * planes * 9  # 3x3, strided
            macs += s_out * s_out * planes * planes * 4  # 1x1 expand
            if b == 0:
                macs += s_out * s_out * cin * planes * 4  # downsample
            cin, s = planes * 4, s_out
    return 2.0 * macs


def pointnet_point_macs(H: int) -> float:
    """Per point: fc_pos 3->2H, block 0 (2H->H, H->H, shortcut 2H->H),
    blocks 1-3 on the point's own half (three H->H each)."""
    return 3 * 2 * H + 2 * H * H + H * H + 2 * H * H + 9 * H * H


def pointnet_flops(m: Dict, P: int) -> float:
    H, out = m["pointnet_hidden_dim"], m["scene_feat_dim"]
    per_cloud = 3 * 2 * H * H + H * out  # the pooled halves, fc_c
    return 2.0 * (pointnet_point_macs(H) * P + per_cloud)


def smpl_flops(V: int) -> float:
    """Skinning one body: shape and pose blend shapes, joint regression,
    the 24 transforms blended per vertex and applied."""
    return 2.0 * (V * 3 * 10 + 24 * V * 3 + 207 * V * 3 + V * 24 * 12 + V * 12)


def k1_bound(m: Dict, B: int, P: int) -> float:
    H = m["pointnet_hidden_dim"]
    n_weights = (3 * 2 * H + 2 * H) + 4 * (2 * H * H + H + H * H + H + 2 * H * H) \
        + H * m["scene_feat_dim"] + m["scene_feat_dim"]
    return bound_s(2.0 * pointnet_point_macs(H) * B * P,
                   B * P * 3 * 2 + n_weights * 2 + B * H * 4, PEAK_BF16)

