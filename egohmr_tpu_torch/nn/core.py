"""Primitives shared by the port's modules (port of egohmr_tpu/nn/core.py).

Parameters live in `nn.Module`s named like the reference `state_dict`
(Linear weights are [out, in]); the forward math is plain functions that
follow JAX's dtype rules, which differ from PyTorch's in two places:

* JAX promotes a mixed bf16 @ f32 matmul to f32, where `torch.matmul`
  refuses it. `mm`/`linear` cast both operands to the promoted dtype, so a
  f32 input meeting bf16-cast weights computes in f32 from the
  bf16-ROUNDED weights, exactly as JAX does.
* BatchNorm on low-precision activations folds the f32 statistics (running
  ones in eval, batch ones in training) into one per-channel scale/shift
  cast to the activation dtype.

Mixed-precision training casts every parameter and buffer outside the
BatchNorms to bf16 inside the differentiated function (`bf16_tensors`), so
the gradients land in f32 on the f32 master weights.
"""
from __future__ import annotations

import copy
from typing import Dict

import torch
from torch import nn

_BN_NAMES = frozenset(("weight", "bias", "running_mean", "running_var",
                       "num_batches_tracked"))


def mm(x: torch.Tensor, w_out_in: torch.Tensor) -> torch.Tensor:
    """x @ w.T in the promoted dtype of x and w (w in [out, in] layout)."""
    dt = torch.promote_types(x.dtype, w_out_in.dtype)
    return x.to(dt) @ w_out_in.to(dt).t()


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    y = mm(x, mod.weight)
    if mod.bias is not None:
        y = y + mod.bias.to(torch.promote_types(y.dtype, mod.bias.dtype))
    return y


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def batchnorm_eval(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                   channel_dim: int) -> torch.Tensor:
    """Eval BatchNorm with running statistics; channels on `channel_dim`."""
    shape = [1] * x.ndim
    shape[channel_dim] = -1
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    if x.dtype != inv.dtype:
        shift = bn.bias - bn.running_mean * inv
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)
    return ((x - bn.running_mean.view(shape)) * inv.view(shape)
            + bn.bias.view(shape))


def batchnorm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
              channel_dim: int, *, train: bool) -> torch.Tensor:
    """BatchNorm with channels on `channel_dim`, in JAX's arithmetic.

    Training: the batch statistics are f32 whatever the activation dtype,
    the variance as mean(x^2) - mean(x)^2 over every other axis, and
    gradients flow through them; the running statistics move by momentum
    `bn.momentum` towards the batch mean and the variance unbiased by
    n / (n - 1), written in place outside autograd. Eval: the running
    statistics (`batchnorm_eval`)."""
    if not train:
        return batchnorm_eval(bn, x, channel_dim)
    channel_dim %= x.ndim
    reduce = tuple(d for d in range(x.ndim) if d != channel_dim)
    xs = x.float()
    mean = xs.mean(dim=reduce)
    var = xs.square().mean(dim=reduce) - mean.square()
    n = x.numel() // x.shape[channel_dim]
    m = bn.momentum
    with torch.no_grad():
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * (var * (n / max(n - 1, 1))))
    shape = [1] * x.ndim
    shape[channel_dim] = -1
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    if x.dtype != inv.dtype:
        shift = bn.bias - mean * inv
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)
    return (x - mean.view(shape)) * inv.view(shape) + bn.bias.view(shape)


def _is_batchnorm(m: nn.Module) -> bool:
    names = {n for n, _ in m.named_parameters(recurse=False)}
    names |= {n for n, _ in m.named_buffers(recurse=False)}
    return names == _BN_NAMES


def cast_params_bf16(model: nn.Module) -> nn.Module:
    """A bf16 copy of `model` for low-precision inference.

    Every float32 parameter and buffer becomes bfloat16 — including the
    sinusoidal `pe` table and `init_betas`, as the JAX rule casts every f32
    leaf — except in modules whose tensors are exactly a BatchNorm's
    (weight, bias, running stats), which stay float32. BatchNorms are
    detected by that name set, not by type or parent name."""
    model = copy.deepcopy(model)
    for m in model.modules():
        if _is_batchnorm(m):
            continue
        for p in m.parameters(recurse=False):
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
        for name, b in list(m.named_buffers(recurse=False)):
            if b.dtype == torch.float32:
                m._buffers[name] = b.to(torch.bfloat16)
    return model


def bf16_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: bf16 cast} of every float32 parameter and buffer of `model`
    outside the BatchNorms, the set `cast_params_bf16` casts, for
    `torch.func.functional_call`. The casts are differentiable: called
    inside the differentiated function, they send the gradients back to the
    f32 tensors in f32."""
    out = {}
    for prefix, m in model.named_modules():
        if _is_batchnorm(m):
            continue
        prefix = prefix + "." if prefix else ""
        for name, t in (*m.named_parameters(recurse=False), *m.named_buffers(recurse=False)):
            if t.dtype == torch.float32:
                out[prefix + name] = t.to(torch.bfloat16)
    return out
