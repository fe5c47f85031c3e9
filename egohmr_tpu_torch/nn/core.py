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
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..parallel.mesh import DataParallel, all_reduce_sum

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
    if x.dtype != torch.promote_types(bn.running_var.dtype, bn.weight.dtype):
        inv, shift = batchnorm_eval_fold(bn, x.dtype)
        return x * inv.view(shape) + shift.view(shape)
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return ((x - bn.running_mean.view(shape)) * inv.view(shape)
            + bn.bias.view(shape))


def batchnorm_eval_fold(bn: nn.modules.batchnorm._BatchNorm,
                        dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm on activations of a lower precision than its f32
    statistics, as one per-channel (scale, shift) cast to `dtype`."""
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return inv.to(dtype), (bn.bias - bn.running_mean * inv).to(dtype)


def batchnorm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
              channel_dim: int, *, train: bool,
              dp: Optional[DataParallel] = None) -> torch.Tensor:
    """BatchNorm with channels on `channel_dim`, in JAX's arithmetic.

    Training: the batch statistics are f32 whatever the activation dtype,
    the variance as mean(x^2) - mean(x)^2 over every other axis, and
    gradients flow through them; the running statistics move by momentum
    `bn.momentum` towards the batch mean and the variance unbiased by
    n / (n - 1), written in place outside autograd. Eval: the running
    statistics (`batchnorm_eval`).

    With a data-parallel record `dp` the training statistics are the whole
    batch's (cross-replica BatchNorm, JAX's `axis_name`): mean(x) and
    mean(x^2) are summed over the ranks in one differentiable all-reduce
    and divided by the world size, and the unbiased correction counts the
    global n x world rows, not the shard's."""
    if not train:
        return batchnorm_eval(bn, x, channel_dim)
    channel_dim %= x.ndim
    reduce = tuple(d for d in range(x.ndim) if d != channel_dim)
    xs = x.float()
    mean = xs.mean(dim=reduce)
    mean2 = xs.square().mean(dim=reduce)
    n = x.numel() // x.shape[channel_dim]
    if dp is not None:
        mean, mean2 = (all_reduce_sum(dp, torch.cat([mean, mean2])) / dp.size).chunk(2)
        n *= dp.size
    var = mean2 - mean.square()
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


def is_bf16_copy(model: nn.Module) -> bool:
    """Whether `model` is a `cast_params_bf16` copy: its first parameter
    outside the BatchNorms is bfloat16."""
    first = next(p for m in model.modules() if not _is_batchnorm(m)
                 for p in m.parameters(recurse=False))
    return first.dtype == torch.bfloat16


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
