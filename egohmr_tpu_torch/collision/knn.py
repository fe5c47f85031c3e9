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
import functools
import sys

import torch

from ..utils.graphs import count_launch

# K2 launches on the card since the count was last set to 0 (one per
# `nearest_vertex_idx` call on a CUDA tensor, or per replay of a captured
# program that holds one: `utils/graphs.py:count_launch`)
launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("nearest_vertex")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.k2_nearest_vertex.argtypes = [vp] * 5 + [i] * 4 + [vp]
        lib.k2_nearest_vertex.restype = i
        lib.k2_block_vertices.restype = lib.k2_block_points.restype = i
        if (lib.k2_block_vertices(), lib.k2_block_points()) != (BLOCK_VERTICES, BLOCK_POINTS):
            raise RuntimeError("K2's blocks differ from launch_plan's")
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


BLOCK_POINTS = 512    # points of one cloud that a K2 CTA owns (128 threads x 4)
BLOCK_VERTICES = 32   # the kernel's min block: a V split is a multiple of it
MIN_SPLIT = 1536      # vertices: below this a CTA's set-up and its last phase show
CTAS_PER_SM = 16      # aimed at before V is split: the SMs even out over many CTAs


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, P: int, V: int, n_sm: int) -> dict:
    """How K2 covers B clouds of P points and V vertices on `n_sm` SMs:
    `point_blocks` CTAs of BLOCK_POINTS points a cloud, and the vertices cut
    into `splits` ranges of `split_len` (the last one shorter), one CTA per
    (point block, cloud, range). V is split only while the point blocks
    alone leave fewer than CTAS_PER_SM CTAs an SM, and never below MIN_SPLIT
    vertices a range. Pure arithmetic: the kernel takes `split_len` as
    given. (The constants are the best of a sweep on an H100: see PERF.md.)"""
    if min(B, P, V, n_sm) < 1:
        raise ValueError(f"launch_plan takes positive sizes, got {(B, P, V, n_sm)}")
    point_blocks = -(-P // BLOCK_POINTS)
    want = -(-CTAS_PER_SM * n_sm // (B * point_blocks))  # splits to fill the card
    splits = max(1, min(want, V // MIN_SPLIT, 65535))
    split_len = -(-V // splits)
    split_len = -(-split_len // BLOCK_VERTICES) * BLOCK_VERTICES
    return {"point_blocks": point_blocks, "split_len": split_len,
            "splits": -(-V // split_len)}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    lib = _load()
    if points.dtype != torch.float32 or verts.dtype != torch.float32:
        raise ValueError(f"K2 takes float32, got {points.dtype} and {verts.dtype}")
    if verts.device != points.device:
        raise ValueError(f"points on {points.device}, verts on {verts.device}")
    B, P, _ = points.shape
    V = verts.shape[1]
    if not (1 <= B <= 65535 and B * P < 2 ** 31 and V < 2 ** 31 // 3):
        raise ValueError(f"K2 takes 1 <= B <= 65535 clouds, B * P < 2^31 points and "
                         f"3 V < 2^31, got B={B}, P={P}, V={V}")
    dev = points.device
    idx = torch.empty((B, P), dtype=torch.int64, device=dev)
    if P == 0:
        return idx
    plan = launch_plan(B, P, V, _sm_count(dev))
    part_d = part_i = None
    if plan["splits"] > 1:  # each split's best (f32 distance, int32 index), for the combine kernel
        part = torch.empty((2, plan["splits"], B, P), dtype=torch.float32, device=dev)
        part_d = part.data_ptr()
        part_i = part_d + 4 * plan["splits"] * B * P
    pts, vts = points.detach().contiguous(), verts.detach().contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.k2_nearest_vertex(
            pts.data_ptr(), vts.data_ptr(), idx.data_ptr(),
            part_d, part_i, B, P, V, plan["split_len"], stream)
    if code != 0:
        msg = lib.k2_error_string(code).decode()
        raise RuntimeError(f"K2 launch failed: CUDA error {code} ({msg})")
    count_launch(sys.modules[__name__])
    return idx


def nearest_vertex_idx(points: torch.Tensor, verts: torch.Tensor, *,
                       block_size: int = 2048) -> torch.Tensor:
    """points [B, P, 3], verts [B, V, 3] -> nearest-vertex index int64
    [B, P], ties to the lowest index.

    A CUDA tensor goes through the kernel (or raises), whatever P and V:
    the kernel walks V in chunks and holds no tile (`launch_plan` says how
    it is spread over the card). A CPU tensor goes
    through the plain version, `block_size` points at a time. There is no
    fallback between the two."""
    _check_shapes(points, verts)
    if points.device.type == "cuda":
        return _launch(points, verts)
    if points.device.type == "cpu":
        return nearest_vertex_idx_reference(points, verts, block_size=block_size)
    raise ValueError(f"K2 runs on CUDA or CPU tensors, got {points.device}")
