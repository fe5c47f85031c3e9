"""The GCN denoiser's graph-convolution epilogue as one hand-written CUDA
pass (`csrc/gconv_epilogue.cu`).

After a graph convolution's two weight products h0 = x @ W[0] and
h1 = x @ W[1], the plain path (`nn/gcn.py:modulated_gconv_mix` and
`_bn_relu`) runs the modulation, the two adjacency einsums, the bias, eval
BatchNorm, ReLU and the residual add as separate bf16 passes. The kernel
does all of it in f32 registers from the bf16 inputs and rounds once, at
the store. It replaces no TPU kernel: XLA fuses the same glue on the JAX
side.

`nn/gcn.py` takes this path only where the kernel's arithmetic is what the
caller gets anyway: CUDA tensors, bf16 activations and weights, BatchNorm
on its running statistics, no autograd. Training, the tensor-parallel
split, the CPU and f32 keep the plain path.

The constants (the symmetrised adjacency's diagonal and off-diagonal
parts, the modulation, the bias and BatchNorm's folded scale and shift)
are built once per module from its parameters (`epilogue_constants`),
bit-equal to what the plain path builds on every call, and rebuilt when a
parameter changes.
"""
from __future__ import annotations

import ctypes
import sys
import weakref
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..utils.graphs import count_launch
from .core import batchnorm_eval_fold

# fused graph convolutions launched on the card since the count was last set
# to 0 (one per kernel launch, or per replay of a captured program that holds
# one: `utils/graphs.py:count_launch`)
gconv_fused = 0

# the kernel's shape, as `csrc/gconv_epilogue.cu` fixes it (kJoints, kVec)
JOINTS = 24
VEC = 2  # channels a thread owns: the kernel takes D and rows in multiples of it

_lib = None


def _load():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("gconv_epilogue")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gconv_epilogue.argtypes = [vp, ll, vp, ll] + [vp] * 6 + [i, i, i, vp]
        lib.gconv_epilogue.restype = i
        lib.gconv_error_string.argtypes = [i]
        lib.gconv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class EpilogueConstants(NamedTuple):
    """One graph convolution's constants for bf16 activations, as the
    kernel reads them.

    diag: [J] f32, the symmetrised adjacency a's diagonal; off: [J, J] f32,
        a with its diagonal zeroed (a rounded to bf16 first, as
        `modulated_gconv_mix` rounds it to the activation dtype).
    m: [J, D] bf16, the modulation M.
    vec: [1, D] (no BatchNorm) or [3, D] bf16: the bias, then BatchNorm's
        scale and shift folded and cast as `batchnorm_eval` casts them.
    """
    diag: torch.Tensor
    off: torch.Tensor
    m: torch.Tensor
    vec: torch.Tensor


def build_constants(gconv: nn.Module, adj: torch.Tensor,
                    bn: Optional[nn.modules.batchnorm._BatchNorm]) -> EpilogueConstants:
    """The constants of the bf16 `ModulatedGraphConv` `gconv` over the
    adjacency `adj`, followed by `bn` (None: no BatchNorm or ReLU)."""
    dtype = torch.bfloat16
    with torch.no_grad():
        a = adj.float() + gconv.adj2.float()
        a = ((a.T + a) / 2).to(dtype)
        eye = torch.eye(a.shape[0], dtype=dtype, device=a.device)
        rows = [gconv.bias.to(dtype)]
        if bn is not None:
            rows.extend(batchnorm_eval_fold(bn, dtype))
        return EpilogueConstants(
            diag=(a * eye).diagonal().float().contiguous(),
            off=(a * (1 - eye)).float().contiguous(),
            m=gconv.M.detach().contiguous(),
            vec=torch.stack(rows).contiguous())


# graph convolution -> (what its parameters were when built, the constants)
_built: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def epilogue_constants(gconv: nn.Module, adj: torch.Tensor,
                       bn: Optional[nn.modules.batchnorm._BatchNorm]) -> EpilogueConstants:
    """`build_constants(gconv, adj, bn)`, kept while the adjacency
    and every parameter and statistic it reads is the same storage, dtype
    and version: an in-place update, a load_state_dict or a move to another
    device builds anew."""
    tensors = [adj, gconv.adj2, gconv.M, gconv.bias]
    if bn is not None:
        tensors += [bn.weight, bn.bias, bn.running_mean, bn.running_var]
    state = (None if bn is None else bn.eps,
             tuple((t.data_ptr(), t._version, t.dtype, t.device) for t in tensors))
    hit = _built.get(gconv)
    if hit is None or hit[0] != state:
        hit = (state, build_constants(gconv, adj, bn))
        _built[gconv] = hit
    return hit[1]


def gconv_epilogue_reference(c: EpilogueConstants, h0: torch.Tensor, h1: torch.Tensor,
                             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h0, h1 [N, J, D] -> [N, J, D] in the kernel's arithmetic: f32 from
    the inputs, rounded once to their dtype (the plain version the kernel
    is held to)."""
    m = c.m.float()
    vec = c.vec.float()
    z = c.diag[:, None] * (m * h0.float())
    z = z + torch.einsum("jk,nkd->njd", c.off, m * h1.float()) + vec[0]
    if vec.shape[0] == 3:
        z = torch.relu(vec[1] * z + vec[2])
    if residual is not None:
        z = z + residual.float()
    return z.to(h0.dtype)


def _check(h: torch.Tensor, J: int, D: int, what: str) -> None:
    if (h.ndim != 3 or h.shape[1:] != (J, D) or h.stride(2) != 1
            or h.stride(0) != J * h.stride(1) or h.stride(1) % VEC
            or h.data_ptr() % (VEC * h.element_size())):
        raise ValueError(f"{what} must be [N, {J}, {D}] with unit channel stride, rows a "
                         f"multiple of {VEC} apart and aligned to {VEC} elements, got shape "
                         f"{tuple(h.shape)}, strides {h.stride()}")


def gconv_epilogue(c: EpilogueConstants, h0: torch.Tensor, h1: torch.Tensor,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The graph convolution's output [N, J, D] from its products h0 and h1
    [N, J, D] (and the residual stream), by the constants `c`, through the
    kernel: CUDA tensors only (`gconv_epilogue_reference` is the same
    arithmetic in PyTorch)."""
    if not h0.is_cuda:
        raise ValueError(f"the graph-convolution epilogue runs on CUDA tensors, got {h0.device}")
    J, D = c.m.shape
    if J != JOINTS:
        raise ValueError(f"the kernel is built for {JOINTS} joints, got {J}")
    if D % VEC or D < VEC:
        raise ValueError(f"the kernel takes channels in multiples of {VEC}, got {D}")
    bf = torch.bfloat16
    if not all(t.dtype == bf for t in (h0, h1, c.m, c.vec)):
        raise ValueError("the kernel takes bf16 activations, modulation and vectors")
    N = h0.shape[0]
    _check(h0, J, D, "h0")
    _check(h1, J, D, "h1")
    if h1.shape[0] != N:
        raise ValueError(f"h0 and h1 differ in batch: {N} and {h1.shape[0]}")
    if residual is not None:
        if residual.shape != (N, J, D) or residual.dtype != bf:
            raise ValueError(f"residual must be [{N}, {J}, {D}] bf16")
        residual = residual.contiguous()
    dev = h0.device
    others = (h1, c.diag, c.off, c.m, c.vec) + (() if residual is None else (residual,))
    if any(t.device != dev for t in others):
        raise ValueError("activations and constants lie on different devices")
    lib = _load()
    out = torch.empty((N, J, D), dtype=bf, device=dev)
    with torch.cuda.device(dev):
        code = lib.gconv_epilogue(
            h0.data_ptr(), h0.stride(1), h1.data_ptr(), h1.stride(1),
            None if residual is None else residual.data_ptr(), c.diag.data_ptr(),
            c.off.data_ptr(), c.m.data_ptr(), c.vec.data_ptr(), out.data_ptr(), N, D,
            int(c.vec.shape[0] == 3), torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"gconv_epilogue launch failed: CUDA error {code} "
                           f"({lib.gconv_error_string(code).decode()})")
    count_launch(sys.modules[__name__], "gconv_fused")
    return out
