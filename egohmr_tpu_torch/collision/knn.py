"""Kernel K2: the nearest body vertex of every scene point.

Port of egohmr_tpu/collision/knn_pallas.py. On a CUDA tensor the index
comes from the hand-written Hopper kernel in `csrc/nearest_vertex.cu`; on a
CPU tensor from `nearest_vertex_idx_reference`, the blocked
`|v|^2 - 2 p.v` + `argmin` of egohmr_tpu/collision/sdf.py's plain path.
Index only, no autograd: callers recompute the distance from the gathered
vertex.
"""
from __future__ import annotations

import ctypes

import torch

# K2 launches on the card since the count was last set to 0 (one per
# `nearest_vertex_idx` call on a CUDA tensor)
launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("nearest_vertex")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.k2_nearest_vertex.argtypes = [vp, vp, vp, i, i, i, vp]
        lib.k2_nearest_vertex.restype = i
        lib.k2_error_string.argtypes = [i]
        lib.k2_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_shapes(points: torch.Tensor, verts: torch.Tensor) -> None:
    if (points.ndim != 3 or verts.ndim != 3 or points.shape[-1] != 3
            or verts.shape[-1] != 3 or points.shape[0] != verts.shape[0]):
        raise ValueError(f"points [B, P, 3] and verts [B, V, 3] expected, got "
                         f"{tuple(points.shape)} and {tuple(verts.shape)}")
    if verts.shape[1] < 1:
        raise ValueError("verts holds no vertex")


def nearest_vertex_idx_reference(points: torch.Tensor, verts: torch.Tensor, *,
                                 block_size: int = 2048) -> torch.Tensor:
    """points [B, P, 3], verts [B, V, 3] -> argmin index int64 [B, P]: the
    plain version the kernel is held to. |p|^2 is constant per point and is
    left out; P goes in blocks so the [B, block, V] tile stays bounded."""
    _check_shapes(points, verts)
    with torch.no_grad():
        v_sq = torch.sum(verts * verts, dim=-1)[:, None, :]  # [B, 1, V]
        v_t = verts.transpose(1, 2)
        out = [torch.argmin(v_sq - 2.0 * torch.matmul(blk, v_t), dim=-1)
               for blk in points.split(block_size, dim=1)]
    return torch.cat(out, dim=1)


def _launch(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    global launches
    lib = _load()
    if points.dtype != torch.float32 or verts.dtype != torch.float32:
        raise ValueError(f"K2 takes float32, got {points.dtype} and {verts.dtype}")
    if verts.device != points.device:
        raise ValueError(f"points on {points.device}, verts on {verts.device}")
    B, P, _ = points.shape
    V = verts.shape[1]
    if not 1 <= B <= 65535:
        raise ValueError(f"K2 takes 1 <= B <= 65535 clouds, got B={B}")
    idx = torch.empty((B, P), dtype=torch.int64, device=points.device)
    if P == 0:
        return idx
    pts, vts = points.detach().contiguous(), verts.detach().contiguous()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        code = lib.k2_nearest_vertex(pts.data_ptr(), vts.data_ptr(),
                                     idx.data_ptr(), B, P, V, stream)
    if code != 0:
        msg = lib.k2_error_string(code).decode()
        raise RuntimeError(f"K2 launch failed: CUDA error {code} ({msg})")
    launches += 1
    return idx


def nearest_vertex_idx(points: torch.Tensor, verts: torch.Tensor, *,
                       block_size: int = 2048) -> torch.Tensor:
    """points [B, P, 3], verts [B, V, 3] -> nearest-vertex index int64
    [B, P], ties to the lowest index.

    A CUDA tensor goes through the kernel (or raises), whatever P and V:
    the kernel walks V in chunks and holds no tile. A CPU tensor goes
    through the plain version, `block_size` points at a time. There is no
    fallback between the two."""
    _check_shapes(points, verts)
    if points.device.type == "cuda":
        return _launch(points, verts)
    if points.device.type == "cpu":
        return nearest_vertex_idx_reference(points, verts, block_size=block_size)
    raise ValueError(f"K2 runs on CUDA or CPU tensors, got {points.device}")
