"""ResNet's glue after each convolution as one hand-written CUDA pass
(`csrc/resnet_epilogue.cu`).

After each convolution the plain path (`nn/resnet.py:_block`) runs eval
BatchNorm (a broadcast multiply and a broadcast add, `nn/core.py:
batchnorm_eval`), ReLU and, at a block's end, the residual add (through the
downsample branch's own BatchNorm), each a bf16 pass over the whole
activation. The kernel does all of it in f32 registers from the bf16
inputs and rounds once, at the store: one pass a convolution, the
downsample branch's BatchNorm merged into the block's last one (49 a
ResNet-50 forward). It replaces no TPU kernel: XLA fuses the same glue into
the convolutions on the JAX side.

`nn/resnet.py` takes this path only where the kernel's arithmetic is what
the caller gets anyway: CUDA tensors, bf16 activations and convolution
weights, f32 BatchNorm on its running statistics, no autograd. Training,
f32, the CPU and anything under autograd keep the plain path.

Each BatchNorm's folded scale and shift (`bn_constants`) are built once per
module, bit-equal to what `batchnorm_eval` builds on every call, and
rebuilt when a parameter or statistic changes.
"""
from __future__ import annotations

import ctypes
import sys
import weakref
from typing import Optional

import torch
from torch import nn

from ..utils.graphs import count_launch
from .core import batchnorm_eval_fold

# fused passes launched on the card since the count was last set to 0 (one
# per kernel launch, or per replay of a captured program that holds one:
# `utils/graphs.py:count_launch`)
resnet_fused = 0

VEC = 8  # channels a thread owns (`csrc/resnet_epilogue.cu`'s kVec): C a multiple of it
ALIGN = 16  # bytes: every tensor's start, for the kernel's 16-byte loads and stores

# the passes of a ResNet-50 forward at 224 x 224: (C, H = W, form, passes
# of that shape), 49 in all; form 0: BatchNorm and ReLU, 1: with the
# identity residual, 2: with the downsample branch through its own BatchNorm
RESNET50_PASSES = [(64, 112, 0, 1), (64, 56, 0, 6), (128, 56, 0, 1), (256, 56, 1, 2),
                   (256, 56, 2, 1), (128, 28, 0, 7), (512, 28, 1, 3), (512, 28, 2, 1),
                   (256, 28, 0, 1), (256, 14, 0, 11), (1024, 14, 1, 5), (1024, 14, 2, 1),
                   (512, 14, 0, 1), (512, 7, 0, 5), (2048, 7, 1, 2), (2048, 7, 2, 1)]

_lib = None


def _load():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("resnet_epilogue")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.resnet_epilogue.argtypes = [vp] * 4 + [ll, i, i, i, vp]
        lib.resnet_epilogue.restype = i
        lib.resnet_error_string.argtypes = [i]
        lib.resnet_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build_constants(bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """[2, C] bf16: BatchNorm's scale, then its shift, folded from its f32
    running statistics and cast as `batchnorm_eval` casts them for bf16
    activations."""
    with torch.no_grad():
        return torch.stack(batchnorm_eval_fold(bn, torch.bfloat16)).contiguous()


# BatchNorm -> (what its tensors were when built, the constants)
_built: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def bn_constants(bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """`build_constants(bn)`, kept while each parameter and statistic it
    reads is the same storage, dtype, device and version: an in-place
    update, a load_state_dict or a move to another device builds anew."""
    tensors = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    state = (bn.eps, tuple((t.data_ptr(), t._version, t.dtype, t.device) for t in tensors))
    hit = _built.get(bn)
    if hit is None or hit[0] != state:
        hit = (state, build_constants(bn))
        _built[bn] = hit
    return hit[1]


def resnet_epilogue_reference(a: torch.Tensor, c: torch.Tensor,
                              residual: Optional[torch.Tensor] = None,
                              c_res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(c[0] a + c[1] (+ residual, or + c_res[0] residual + c_res[1]))
    with channels on dim 1, in the kernel's arithmetic: f32 from the inputs,
    each product and sum rounded as written, the output rounded once to a's
    dtype (the plain version the kernel is held to)."""
    shape = (-1,) + (1,) * (a.ndim - 2)
    z = c[0].float().view(shape) * a.float() + c[1].float().view(shape)
    if residual is not None:
        r = residual.float()
        if c_res is not None:
            r = c_res[0].float().view(shape) * r + c_res[1].float().view(shape)
        z = z + r
    return torch.relu(z).to(a.dtype)


def _check(t: torch.Tensor, shape, what: str) -> None:
    if (tuple(t.shape) != tuple(shape) or not t.is_contiguous(memory_format=torch.channels_last)
            or t.data_ptr() % ALIGN):
        raise ValueError(f"{what} must be [N, C, H, W] = {tuple(shape)} in channels_last "
                         f"memory (NHWC rows), aligned to {ALIGN} bytes; got shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")


def resnet_epilogue(a: torch.Tensor, c: torch.Tensor, residual: Optional[torch.Tensor] = None,
                    c_res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A convolution's output a [N, C, H, W] (channels_last memory) through
    BatchNorm's constants c [2, C] and ReLU, with the identity residual
    (`residual`) or the downsample branch's output through its own
    constants (`residual`, `c_res`) added before the ReLU, written into a
    and returned. Through the kernel: CUDA tensors only
    (`resnet_epilogue_reference` is the same arithmetic in PyTorch)."""
    if a.ndim != 4:
        raise ValueError(f"a must be [N, C, H, W], got shape {tuple(a.shape)}")
    C = a.shape[1]
    if C % VEC or C < VEC:
        raise ValueError(f"the kernel takes channels in multiples of {VEC}, got {C}")
    if c_res is not None and residual is None:
        raise ValueError("c_res is the downsample branch's: it needs the residual")
    consts = [c] + ([] if c_res is None else [c_res])
    acts = [a] + ([] if residual is None else [residual])
    if not all(t.dtype == torch.bfloat16 for t in consts + acts):
        raise ValueError("the kernel takes bf16 activations and constants")
    for k in consts:
        if k.shape != (2, C) or not k.is_contiguous() or k.data_ptr() % ALIGN:
            raise ValueError(f"constants must be a contiguous [2, {C}] (scale, shift) aligned "
                             f"to {ALIGN} bytes, got shape {tuple(k.shape)}")
    _check(a, a.shape, "a")
    if residual is not None:
        _check(residual, a.shape, "residual")
        nbytes = a.numel() * a.element_size()
        if abs(residual.data_ptr() - a.data_ptr()) < nbytes:
            raise ValueError("the residual overlaps a, which the kernel writes")
    dev = a.device
    if any(t.device != dev for t in consts + acts):
        raise ValueError("activations and constants lie on different devices")
    if not a.is_cuda:
        raise ValueError(f"the ResNet epilogue runs on CUDA tensors, got {a.device}")
    form = 0 if residual is None else 1 if c_res is None else 2
    lib = _load()
    with torch.cuda.device(dev):
        code = lib.resnet_epilogue(
            a.data_ptr(), c.data_ptr(), None if residual is None else residual.data_ptr(),
            None if c_res is None else c_res.data_ptr(), a.numel() // C, C, form,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"resnet_epilogue launch failed: CUDA error {code} "
                           f"({lib.resnet_error_string(code).decode()})")
    count_launch(sys.modules[__name__], "resnet_fused")
    return a
