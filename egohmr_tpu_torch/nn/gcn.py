"""Modulated graph-convolutional denoiser (port of egohmr_tpu/nn/gcn.py).

The 24-node joint graph is tiny, so each layer is two [B*24, in] x [in, out]
matmuls plus 24x24 adjacency mixes; plain torch ops (the JAX package removed
its GCN kernel after it lost to XLA). BatchNorm statistics reduce over
(batch, joints).

The optional embedded-gaussian non-local block (`gcn_nonlocal_layer`, off in
the default config) follows the residual layers. Its modules carry the
reference's names and shapes: `g`, `theta`, `phi` and `W.0` are 1x1 Conv2d
over a [B, C, 1, 24] layout, which are per-node linears here, and `W.1` is
its BatchNorm2d.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .core import batchnorm, mm


class ModulatedGraphConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, n_nodes: int = 24):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(2, in_dim, out_dim))
        self.M = nn.Parameter(torch.zeros(n_nodes, out_dim))
        self.adj2 = nn.Parameter(torch.full((n_nodes, n_nodes), 1e-6))
        self.bias = nn.Parameter(torch.zeros(out_dim))


class GraphConv(nn.Module):
    """gconv -> BatchNorm (stats over batch and joints) -> ReLU."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.gconv = ModulatedGraphConv(in_dim, out_dim)
        self.bn = nn.BatchNorm1d(out_dim)


class ResGraphConv(nn.Module):
    def __init__(self, hid_dim: int):
        super().__init__()
        self.gconv1 = GraphConv(hid_dim, hid_dim)
        self.gconv2 = GraphConv(hid_dim, hid_dim)


class NonLocalBlock(nn.Module):
    """Embedded-gaussian non-local block over the 24 nodes, with the
    reference's configuration (no sub-sampling, BatchNorm on the output)."""

    def __init__(self, channels: int):
        super().__init__()
        inter = max(channels // 2, 1)
        self.g = nn.Conv2d(channels, inter, 1)
        self.theta = nn.Conv2d(channels, inter, 1)
        self.phi = nn.Conv2d(channels, inter, 1)
        self.W = nn.Sequential(nn.Conv2d(inter, channels, 1), nn.BatchNorm2d(channels))


class ModulatedGCN(nn.Module):
    def __init__(self, in_dim: int, hid_dim: int = 1024, out_dim: int = 6,
                 num_layers: int = 4, nonlocal_layer: bool = False):
        super().__init__()
        self.gconv_input = nn.ModuleList([GraphConv(in_dim, hid_dim)])
        self.gconv_layers = nn.ModuleList(
            [ResGraphConv(hid_dim) for _ in range(num_layers)])
        self.non_local = NonLocalBlock(hid_dim) if nonlocal_layer else None
        self.gconv_output = ModulatedGraphConv(hid_dim, out_dim)


def modulated_gconv_mix(p: ModulatedGraphConv, adj: torch.Tensor,
                        h0: torch.Tensor, h1: torch.Tensor) -> torch.Tensor:
    """Modulation + adjacency mix given h0 = x @ W[0], h1 = x @ W[1]."""
    # symmetrise in f32, then drop to the activation dtype: a f32 adjacency
    # would promote every layer's activations back to f32 on the bf16 path
    a = adj.float() + p.adj2.float()
    a = ((a.T + a) / 2).to(h0.dtype)
    eye = torch.eye(a.shape[0], dtype=h0.dtype, device=h0.device)
    m = p.M
    out = (torch.einsum("jk,bkd->bjd", a * eye, m * h0)
           + torch.einsum("jk,bkd->bjd", a * (1 - eye), m * h1))
    return out + p.bias


def modulated_gconv(p: ModulatedGraphConv, adj: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """x [B, J, in] -> [B, J, out]."""
    return modulated_gconv_mix(p, adj, x @ p.W[0], x @ p.W[1])


def _bn_relu(bn: nn.BatchNorm1d, x: torch.Tensor, train: bool) -> torch.Tensor:
    return torch.relu(batchnorm(bn, x, channel_dim=-1, train=train))


def graph_conv(p: GraphConv, adj: torch.Tensor, x: torch.Tensor,
               train: bool = False) -> torch.Tensor:
    return _bn_relu(p.bn, modulated_gconv(p.gconv, adj, x), train)


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv2d on [B, C, 1, J] as a linear on x [B, J, C]."""
    y = mm(x, conv.weight.view(conv.weight.shape[0], -1))
    return y + conv.bias.to(torch.promote_types(y.dtype, conv.bias.dtype))


def nonlocal_block(p: NonLocalBlock, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
    """x [B, J, C] -> [B, J, C]: z = BN(W(softmax(theta(x) phi(x)^T) g(x))) + x,
    the softmax over the nodes in f32 whatever the activation dtype."""
    g_x, theta_x, phi_x = (_conv1x1(c, x) for c in (p.g, p.theta, p.phi))
    f = torch.einsum("bjc,bkc->bjk", theta_x, phi_x)
    f = torch.softmax(f.float(), dim=-1).to(x.dtype)
    y = torch.einsum("bjk,bkc->bjc", f, g_x)
    w_y = batchnorm(p.W[1], _conv1x1(p.W[0], y), channel_dim=-1, train=train)
    return x + w_y


def modulated_gcn_forward(
    model: ModulatedGCN,
    adj: torch.Tensor,
    x: Optional[torch.Tensor],
    *,
    train: bool = False,
    input_h: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """x [B, 24, in] -> [B, 24, out]. `train`: BatchNorm on the batch's
    statistics, updating the running ones.

    `input_h`: precomputed (x @ W[0], x @ W[1]) of the input layer, so the
    sampler can hoist the loop-invariant conditioning projection; `x` is
    ignored when given."""
    gi = model.gconv_input[0]
    if input_h is not None:
        out = _bn_relu(gi.bn, modulated_gconv_mix(gi.gconv, adj, *input_h), train)
    else:
        out = graph_conv(gi, adj, x, train)
    for blk in model.gconv_layers:
        residual = out
        out = graph_conv(blk.gconv1, adj, out, train)
        out = graph_conv(blk.gconv2, adj, out, train)
        out = residual + out
    if model.non_local is not None:
        out = nonlocal_block(model.non_local, out, train=train)
    return modulated_gconv(model.gconv_output, adj, out)
