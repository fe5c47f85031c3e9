"""ResnetPointnet scene encoder, plain PyTorch (port of
egohmr_tpu/nn/pointnet.py:pointnet_forward). This is the float32 path and
the reference the fused kernel K1 is held to."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.mesh import DataParallel, all_reduce_max
from .core import linear, mm


class ResnetBlockFC(nn.Module):
    def __init__(self, size_in: int, size_out: int, size_h: int):
        super().__init__()
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = (nn.Linear(size_in, size_out, bias=False)
                         if size_in != size_out else None)


class ResnetPointnet(nn.Module):
    def __init__(self, out_dim: int = 512, hidden_dim: int = 256):
        super().__init__()
        self.fc_pos_0 = nn.Linear(3, 2 * hidden_dim)
        for i in range(4):
            setattr(self, f"block_{i}",
                    ResnetBlockFC(2 * hidden_dim, hidden_dim, hidden_dim))
        self.fc_c = nn.Linear(hidden_dim, out_dim)


def _block(p: ResnetBlockFC, x: torch.Tensor) -> torch.Tensor:
    net = linear(p.fc_0, torch.relu(x))
    dx = linear(p.fc_1, torch.relu(net))
    xs = mm(x, p.shortcut.weight) if p.shortcut is not None else x
    return xs + dx


def _block_split(p: ResnetBlockFC, x: torch.Tensor,
                 pooled: torch.Tensor) -> torch.Tensor:
    """The block on cat([x, broadcast(pooled)]) without building the concat:
    cat(a, b) @ W == a @ W[:H] + b @ W[H:] (weights are [out, in] here)."""
    h = x.shape[-1]
    w0, ws = p.fc_0.weight, p.shortcut.weight
    net = (mm(torch.relu(x), w0[:, :h]) + mm(torch.relu(pooled), w0[:, h:])) + p.fc_0.bias
    dx = linear(p.fc_1, torch.relu(net))
    xs = mm(x, ws[:, :h]) + mm(pooled, ws[:, h:])
    return xs + dx


def pointnet_forward(model: ResnetPointnet, points: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """points [B, N, 3] -> [B, out_dim]; `mask` [B, N] bool keeps padded
    points out of the max-pools."""
    def pool(net):
        if mask is not None:
            net = torch.where(mask[..., None], net, -1e30)
        return net.amax(dim=1, keepdim=True)

    net = linear(model.fc_pos_0, points)
    net = _block(model.block_0, net)
    net = _block_split(model.block_1, net, pool(net))
    net = _block_split(model.block_2, net, pool(net))
    net = _block_split(model.block_3, net, pool(net))
    net = pool(net)[:, 0]
    return linear(model.fc_c, torch.relu(net))


@torch.no_grad()
def pointnet_forward_point_sharded(model: ResnetPointnet, points: torch.Tensor,
                                   dp: DataParallel) -> torch.Tensor:
    """`pointnet_forward` with the POINT axis sharded over the ranks of
    `dp`: each rank encodes its shard [B, N / world, 3] of every cloud, and
    the four max-pools become an all-reduce(MAX), so that every rank
    returns the whole clouds' [B, out_dim]. Equal to `pointnet_forward` on
    the gathered clouds up to the matmuls' rounding: a max is exact in any
    order. Inference only, as in the JAX package (a `pmax` there)."""
    def pool(net):
        return all_reduce_max(dp, net.amax(dim=1, keepdim=True))

    net = linear(model.fc_pos_0, points)
    net = _block(model.block_0, net)
    net = _block_split(model.block_1, net, pool(net))
    net = _block_split(model.block_2, net, pool(net))
    net = _block_split(model.block_3, net, pool(net))
    net = pool(net)[:, 0]
    return linear(model.fc_c, torch.relu(net))
