"""Plain PyTorch layers of the two stages' references: the ResNet-50
backbone, the ResnetPointnet scene encoder, SMPL skinning and the rotation
conversions, as published, over a state dict of tensors. Nothing here
imports the program.

Every matmul and convolution runs in float32 with TF32 off (`exact()`)
unless a `Prec` rounds the operands of the parts the configuration runs in
a lower precision (the control)."""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
RESNET50_BLOCKS = (3, 4, 6, 3)
BN_EPS = 1e-5


def exact() -> None:
    """float32 matmuls and convolutions in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Prec:
    """Operand rounding of the matmuls and convolutions of a part run one
    precision below what the configuration states: none (the reference),
    float8 e4m3 with a per-tensor scale ("fp8", below bfloat16), bfloat16
    ("bf16", below float32 with TF32 allowed) or TF32's 10-bit mantissa
    ("tf32", below float32 with TF32 off)."""

    def __init__(self, mode: str = ""):
        if mode not in ("", "fp8", "bf16", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, x: Tensor) -> Tensor:
        if not self.mode or not x.is_floating_point():
            return x
        if self.mode == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        if self.mode == "tf32":
            bits = x.float().contiguous().view(torch.int32)
            return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)
        scale = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


F32 = Prec()


def linear(W: Dict[str, Tensor], name: str, x: Tensor, p: Prec = F32) -> Tensor:
    return F.linear(p(x), p(W[name + ".weight"]), W.get(name + ".bias"))


def batchnorm(W: Dict[str, Tensor], name: str, x: Tensor) -> Tensor:
    """BatchNorm over channel axis 1 (NCHW or [N, C]), running statistics."""
    shape = [1, -1] + [1] * (x.ndim - 2)
    mean = W[name + ".running_mean"].view(shape)
    var = W[name + ".running_var"].view(shape)
    return ((x - mean) / torch.sqrt(var + BN_EPS) * W[name + ".weight"].view(shape)
            + W[name + ".bias"].view(shape))


def conv(W, name, x, p: Prec, stride=1, padding=0) -> Tensor:
    return F.conv2d(p(x), p(W[name + ".weight"]), stride=stride, padding=padding)


def resnet50(W, img_nhwc: Tensor, p: Prec = F32) -> Tensor:
    """[B, H, W, 3] -> mean-pooled last-stage features [B, 2048]."""
    x = img_nhwc.permute(0, 3, 1, 2).contiguous()
    x = F.relu(batchnorm(W, "backbone.bn1", conv(W, "backbone.conv1", x, p, 2, 3)))
    x = F.max_pool2d(x, 3, 2, 1)
    for li, n in enumerate(RESNET50_BLOCKS, start=1):
        for b in range(n):
            pre = f"backbone.layer{li}.{b}"
            stride = 2 if (li > 1 and b == 0) else 1
            out = F.relu(batchnorm(W, pre + ".bn1", conv(W, pre + ".conv1", x, p)))
            out = F.relu(batchnorm(W, pre + ".bn2",
                                   conv(W, pre + ".conv2", out, p, stride, 1)))
            out = batchnorm(W, pre + ".bn3", conv(W, pre + ".conv3", out, p))
            if pre + ".downsample.0.weight" in W:
                res = batchnorm(W, pre + ".downsample.1",
                                conv(W, pre + ".downsample.0", x, p, stride))
            else:
                res = x
            x = F.relu(out + res)
    return x.mean(dim=(2, 3))


def pointnet(W, name: str, pts: Tensor, p: Prec = F32) -> Tensor:
    """ResnetPointnet: [B, P, 3] -> [B, out]; blocks 1-3 take each point's
    feature concatenated with the cloud's max-pool."""
    def block(i, x):
        pre = f"{name}.block_{i}"
        net = linear(W, pre + ".fc_0", F.relu(x), p)
        dx = linear(W, pre + ".fc_1", F.relu(net), p)
        xs = F.linear(p(x), p(W[pre + ".shortcut.weight"])) if pre + ".shortcut.weight" in W \
            else x
        return xs + dx

    net = block(0, linear(W, name + ".fc_pos_0", pts, p))
    for i in (1, 2, 3):
        pooled = net.amax(dim=1, keepdim=True).expand_as(net)
        net = block(i, torch.cat([net, pooled], dim=-1))
    return linear(W, name + ".fc_c", F.relu(net.amax(dim=1)), p)


def rot6d_to_rotmat(x: Tensor) -> Tensor:
    """6-D rotation, the two 3-vectors as columns -> [N, 3, 3]."""
    m = x.reshape(-1, 3, 2)
    b1 = F.normalize(m[:, :, 0], dim=-1, eps=1e-12)
    a2 = m[:, :, 1]
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1, eps=1e-12)
    return torch.stack([b1, b2, torch.cross(b1, b2, dim=-1)], dim=-1)


class Body(NamedTuple):
    vertices: Tensor   # [N, V, 3]
    joints: Tensor     # [N, 45, 3]


def smpl(S: Dict[str, Tensor], betas: Tensor, rot: Tensor, p: Prec = F32) -> Body:
    """SMPL skinning: betas [N, 10], rot [N, 24, 3, 3] -> the posed mesh
    and the 24 skeleton joints with the 21 vertex joints, untranslated."""
    N = betas.shape[0]
    v_shaped = S["v_template"][None] + torch.einsum("nl,vcl->nvc", p(betas), p(S["shapedirs"]))
    J = torch.einsum("jv,nvc->njc", p(S["j_regressor"]), p(v_shaped))
    eye = torch.eye(3, device=rot.device)
    pose_feat = (rot[:, 1:] - eye).reshape(N, 207)
    v_posed = v_shaped + (p(pose_feat) @ p(S["posedirs"])).reshape(N, -1, 3)
    parents = S["parents"].tolist()
    G: List[Tensor] = []
    for k in range(24):
        local_t = J[:, k] - (J[:, parents[k]] if k else 0)
        top = torch.cat([rot[:, k], local_t[..., None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=rot.device).expand(N, 1, 4)
        Tk = torch.cat([top, bottom], dim=1)
        G.append(Tk if k == 0 else p(G[parents[k]]) @ p(Tk))
    Gs = torch.stack(G, dim=1)                                  # [N, 24, 4, 4]
    joints = Gs[:, :, :3, 3]
    Jh = torch.cat([J, torch.zeros_like(J[..., :1])], -1)[..., None]
    A = Gs - torch.cat([torch.zeros_like(Gs[..., :3]), p(Gs) @ p(Jh)], dim=-1)
    T = torch.einsum("vk,nkij->nvij", p(S["lbs_weights"]), p(A))
    vh = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], -1)
    verts = torch.einsum("nvij,nvj->nvi", p(T), p(vh))[..., :3]
    return Body(verts, torch.cat([joints, verts[:, S["extra_joint_ids"]]], dim=1))

