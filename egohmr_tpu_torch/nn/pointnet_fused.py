"""Kernel K1: the fused whole-network ResnetPointnet scene encoder.

Port of egohmr_tpu/nn/pointnet_fused.py. On a CUDA tensor the pooled
feature comes from the hand-written Hopper kernel in
`csrc/pointnet_fused.cu`; on a CPU tensor from `pointnet_fused_reference`,
a batched PyTorch transcription of the kernel's exact arithmetic (bf16
matmul inputs, f32 accumulation, bf16 activations between stages, each
pool taken from the f32 stage output). Inference only, no autograd.
"""
from __future__ import annotations

import ctypes
import functools
import sys
import weakref
from typing import NamedTuple, Tuple

import torch

from ..utils.graphs import count_launch
from .core import linear
from .pointnet import ResnetPointnet

# K1 chains launched on the card since the count was last set to 0 (one
# per `pointnet_fused_feature` call on a CUDA tensor, or per replay of a
# captured program that holds one: `utils/graphs.py:count_launch`)
launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("pointnet_fused")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.k1_stage0.argtypes = [vp] * 7 + [i, i, i, vp]
        lib.k1_stage.argtypes = [vp] * 6 + [i, i, i, vp]
        lib.k1_context.argtypes = [vp] * 7 + [i, vp]
        for f in (lib.k1_stage0, lib.k1_stage, lib.k1_context,
                  lib.k1_tile_points, lib.k1_hidden, lib.k1_slice_k):
            f.restype = i
        lib.k1_error_string.argtypes = [i]
        lib.k1_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def pointnet_fused_reference(model: ResnetPointnet,
                             points: torch.Tensor) -> torch.Tensor:
    """points [B, P, 3] -> pooled pre-fc_c feature [B, H] f32, in the
    kernel's arithmetic (the plain version the kernel is held to)."""
    bf = torch.bfloat16
    H = model.block_0.fc_1.weight.shape[0]

    def mm(a, w):  # w in nn.Linear's [out, in] layout
        return a.to(bf).float() @ w.to(bf).float().t()

    x = points.to(bf)
    net0 = mm(x, model.fc_pos_0.weight) + model.fc_pos_0.bias.float()
    p0 = model.block_0
    net = mm(torch.relu(net0), p0.fc_0.weight) + p0.fc_0.bias.float()
    dx = mm(torch.relu(net), p0.fc_1.weight) + p0.fc_1.bias.float()
    out = mm(net0, p0.shortcut.weight) + dx
    for i in (1, 2, 3):
        pool = out.amax(dim=1, keepdim=True)  # from the f32 stage output
        x = out.to(bf)
        p = getattr(model, f"block_{i}")
        w0, ws = p.fc_0.weight, p.shortcut.weight
        rpool = mm(torch.relu(pool), w0[:, H:]) + p.fc_0.bias.float()
        xspool = mm(pool, ws[:, H:])
        net = mm(torch.relu(x), w0[:, :H]) + rpool
        dx = mm(torch.relu(net), p.fc_1.weight) + p.fc_1.bias.float()
        out = mm(x, ws[:, :H]) + xspool + dx
    return out.amax(dim=1)


def _check(code: int) -> None:
    if code != 0:
        msg = _load().k1_error_string(code).decode()
        raise RuntimeError(f"K1 launch failed: CUDA error {code} ({msg})")


# ---------------------------------------------------------------------------
# The weights as the kernel wants them, prepared once per model

SLICE_K = 64  # K width of a weight slice: 128 bytes of bf16, one swizzle row
ENC_NEG_INF = -2139095041  # the kernel's order-preserving encoding of -inf


def _swizzle(w: torch.Tensor) -> torch.Tensor:
    """[H, K] -> [K / 64, H, 64]: K-slices whose 16-byte chunk c of row n
    sits at chunk c ^ (n % 8) (the 128-byte shared-memory swizzle that
    `wgmma` and `ldmatrix` read without bank conflicts). Its own inverse on
    the last two axes."""
    h, k = w.shape
    s = w.reshape(h, k // SLICE_K, 8, 8).permute(1, 0, 2, 3)
    n = torch.arange(h, device=w.device)[:, None]
    c = torch.arange(8, device=w.device)[None, :]
    return s[:, n, c ^ (n % 8)].reshape(k // SLICE_K, h, SLICE_K)


def _unswizzle(s: torch.Tensor) -> torch.Tensor:
    """[K / 64, H, 64] swizzled slices -> [H, K]."""
    n_slices, h, _ = s.shape
    n = torch.arange(h, device=s.device)[:, None]
    c = torch.arange(8, device=s.device)[None, :]
    plain = s.reshape(n_slices, h, 8, 8)[:, n, c ^ (n % 8)]
    return plain.permute(1, 0, 2, 3).reshape(h, n_slices * SLICE_K)


class PreparedWeights(NamedTuple):
    """K1's operands for one model: bf16 matrices, f32 biases.

    slices: per stage, the [H x 64] K-slices in the order a tile consumes
        them: fc_0 (its per-point half in stages 1-3), the shortcut
        (likewise), fc_1. 20 slices for stage 0, 12 for each later stage.
    wpos: [2H, 4] f32, fc_pos as (w0, w1, w2, bias) per channel, the weights
        rounded to bf16.
    wctx: [3, 2, H, H] bf16, the pooled halves of fc_0 and the shortcut of
        blocks 1-3, transposed to [k, h].
    b_hidden: [4, H] f32, fc_0's bias of every block. b_out: [4, H], fc_1's.
    """
    slices: Tuple[torch.Tensor, ...]
    wpos: torch.Tensor
    wctx: torch.Tensor
    b_hidden: torch.Tensor
    b_out: torch.Tensor


def _params(model: ResnetPointnet):
    yield model.fc_pos_0.weight
    yield model.fc_pos_0.bias
    for i in range(4):
        p = getattr(model, f"block_{i}")
        yield from (p.fc_0.weight, p.fc_0.bias, p.fc_1.weight, p.fc_1.bias,
                    p.shortcut.weight)


def prepare_weights(model: ResnetPointnet) -> PreparedWeights:
    """Lay the model's weights out for the kernel (see PreparedWeights)."""
    bf, f32 = torch.bfloat16, torch.float32
    H = model.block_0.fc_1.weight.shape[0]
    with torch.no_grad():
        slices = []
        for i in range(4):
            p = getattr(model, f"block_{i}")
            k = 2 * H if i == 0 else H  # the per-point columns
            parts = [p.fc_0.weight[:, :k], p.shortcut.weight[:, :k], p.fc_1.weight]
            slices.append(torch.cat([_swizzle(w.to(bf)) for w in parts]).contiguous())
        wpos = torch.cat([model.fc_pos_0.weight.to(bf).to(f32),
                          model.fc_pos_0.bias.to(f32)[:, None]], dim=1).contiguous()
        wctx = torch.stack([
            torch.stack([getattr(model, f"block_{i}").fc_0.weight[:, H:].to(bf).t(),
                         getattr(model, f"block_{i}").shortcut.weight[:, H:].to(bf).t()])
            for i in (1, 2, 3)]).contiguous()
        b_hidden = torch.stack([getattr(model, f"block_{i}").fc_0.bias.to(f32)
                                for i in range(4)]).contiguous()
        b_out = torch.stack([getattr(model, f"block_{i}").fc_1.bias.to(f32)
                             for i in range(4)]).contiguous()
    return PreparedWeights(tuple(slices), wpos, wctx, b_hidden, b_out)


def unpack_weights(prep: PreparedWeights) -> ResnetPointnet:
    """A ResnetPointnet (without fc_c's values) holding exactly what the
    kernel reads from `prep`: the plain version run on it shows what the
    prepared weights compute."""
    H = prep.b_out.shape[1]
    model = ResnetPointnet(1, H).to(prep.wpos.device)
    with torch.no_grad():
        model.fc_pos_0.weight.copy_(prep.wpos[:, :3])
        model.fc_pos_0.bias.copy_(prep.wpos[:, 3])
        for i in range(4):
            p = getattr(model, f"block_{i}")
            k = 2 * H if i == 0 else H
            n = k // SLICE_K
            s = prep.slices[i]
            w0, ws, w1 = _unswizzle(s[:n]), _unswizzle(s[n:2 * n]), _unswizzle(s[2 * n:])
            if i > 0:  # the pooled halves, back from [k, h]
                w0 = torch.cat([w0, prep.wctx[i - 1, 0].t()], dim=1)
                ws = torch.cat([ws, prep.wctx[i - 1, 1].t()], dim=1)
            p.fc_0.weight.copy_(w0)
            p.shortcut.weight.copy_(ws)
            p.fc_1.weight.copy_(w1)
            p.fc_0.bias.copy_(prep.b_hidden[i])
            p.fc_1.bias.copy_(prep.b_out[i])
    return model.eval()


# model -> (what its parameters were when prepared, the prepared weights)
_prepared: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
preparations = 0  # times `prepare_weights` ran for the cache


def prepared_weights(model: ResnetPointnet) -> PreparedWeights:
    """`prepare_weights(model)`, kept while every parameter is the same
    storage, dtype and version: an in-place update, a load_state_dict or a
    move to another device prepares anew."""
    global preparations
    state = tuple((p.data_ptr(), p._version, p.dtype, p.device) for p in _params(model))
    hit = _prepared.get(model)
    if hit is None or hit[0] != state:
        hit = (state, prepare_weights(model))
        _prepared[model] = hit
        preparations += 1
    return hit[1]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(model: ResnetPointnet, points: torch.Tensor) -> torch.Tensor:
    lib = _load()
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, P, 3], got {tuple(points.shape)}")
    B, P, _ = points.shape
    if not (B >= 1 and P >= 1 and B * P < 2 ** 31):
        raise ValueError(f"K1 takes B >= 1 clouds of P >= 1 points, B * P < 2^31, "
                         f"got B={B}, P={P}")
    H = model.block_0.fc_1.weight.shape[0]
    if H != lib.k1_hidden() or SLICE_K != lib.k1_slice_k():
        raise ValueError(f"K1 is built for hidden width {lib.k1_hidden()} and slices of "
                         f"{lib.k1_slice_k()}, the model has {H}, the wrapper {SLICE_K}")
    dev = points.device
    if model.fc_pos_0.weight.device != dev:
        raise ValueError(f"model on {model.fc_pos_0.weight.device}, points on {dev}")

    w = prepared_weights(model)
    bf, f32 = torch.bfloat16, torch.float32
    pts = points.detach().to(bf).contiguous()
    n_sm = _sm_count(dev)
    x = torch.empty((B, P, H), dtype=bf, device=dev)
    y = torch.empty_like(x)
    enc = torch.full((4, B, H), ENC_NEG_INF, dtype=torch.int32, device=dev)
    # the pooled feature; per cloud, the next stage's hidden and output biases
    pool, rpool, obias = (torch.empty((B, H), dtype=f32, device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.k1_stage0(
            pts.data_ptr(), w.slices[0].data_ptr(), w.wpos.data_ptr(),
            w.b_hidden[0].data_ptr(), w.b_out[0].data_ptr(), x.data_ptr(),
            enc[0].data_ptr(), B, P, n_sm, stream))
        src, dst = x, y
        for i in (1, 2, 3):
            _check(lib.k1_context(
                enc[i - 1].data_ptr(), w.wctx[i - 1].data_ptr(), w.b_hidden[i].data_ptr(),
                w.b_out[i].data_ptr(), None, rpool.data_ptr(), obias.data_ptr(), B, stream))
            _check(lib.k1_stage(
                src.data_ptr(), w.slices[i].data_ptr(), rpool.data_ptr(), obias.data_ptr(),
                dst.data_ptr() if i < 3 else None,  # the last stage writes no activations
                enc[i].data_ptr(), B, P, n_sm, stream))
            src, dst = dst, src
        _check(lib.k1_context(enc[3].data_ptr(), None, None, None, pool.data_ptr(),
                              None, None, B, stream))
    count_launch(sys.modules[__name__])
    return pool


def pointnet_fused_feature(model: ResnetPointnet,
                           points: torch.Tensor) -> torch.Tensor:
    """points [B, P, 3] -> pooled pre-fc_c feature [B, H] f32.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    the plain version. There is no fallback between the two."""
    with torch.no_grad():
        if points.device.type == "cuda":
            return _launch(model, points)
        if points.device.type == "cpu":
            return pointnet_fused_reference(model, points)
    raise ValueError(f"K1 runs on CUDA or CPU tensors, got {points.device}")


def pointnet_forward_fused(model: ResnetPointnet,
                           points: torch.Tensor) -> torch.Tensor:
    """Drop-in for `pointnet_forward(model, points)` without `mask`."""
    return linear(model.fc_c, torch.relu(pointnet_fused_feature(model, points)))
