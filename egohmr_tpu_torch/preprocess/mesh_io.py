"""Minimal mesh vertex I/O (OBJ / PLY) — open3d-free (a copy of
egohmr_tpu/preprocess/mesh_io.py, which imports no JAX but cannot be
imported without it).

The reference's offline preprocessing reads scene meshes with open3d
(reference preprocess_scene_s1.py:82-84); only vertex positions are ever
used downstream, so this module reads exactly that.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np


def read_mesh_vertices(path: str) -> np.ndarray:
    """Vertex positions [N, 3] float64 from .obj (ASCII) or .ply."""
    lower = path.lower()
    if lower.endswith(".obj"):
        return _read_obj(path)
    if lower.endswith(".ply"):
        return _read_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def _read_obj(path: str) -> np.ndarray:
    verts = []
    with open(path, "rb") as f:
        for raw in f:
            if raw[:2] == b"v ":
                parts = raw.split()
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
    return np.asarray(verts, np.float64)


_PLY_TYPES = {
    b"float": ("f", 4), b"float32": ("f", 4),
    b"double": ("d", 8), b"float64": ("d", 8),
    b"int": ("i", 4), b"int32": ("i", 4), b"uint": ("I", 4),
    b"uint32": ("I", 4), b"short": ("h", 2), b"ushort": ("H", 2),
    b"int16": ("h", 2), b"uint16": ("H", 2),
    b"char": ("b", 1), b"uchar": ("B", 1), b"int8": ("b", 1),
    b"uint8": ("B", 1),
}


def _read_ply(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        n_verts: Optional[int] = None
        vertex_props = []  # (name, struct_char, size) in order
        in_vertex_element = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == b"format":
                fmt = parts[1]
            elif parts[0] == b"element":
                in_vertex_element = parts[1] == b"vertex"
                if in_vertex_element:
                    n_verts = int(parts[2])
            elif parts[0] == b"property" and in_vertex_element:
                if parts[1] == b"list":
                    raise ValueError("list property in vertex element")
                ch, sz = _PLY_TYPES[parts[1]]
                vertex_props.append((parts[2], ch, sz))
            elif parts[0] == b"end_header":
                break
        assert n_verts is not None and fmt is not None

        names = [p[0] for p in vertex_props]
        ix, iy, iz = names.index(b"x"), names.index(b"y"), names.index(b"z")

        if fmt == b"ascii":
            out = np.empty((n_verts, 3), np.float64)
            for i in range(n_verts):
                vals = f.readline().split()
                out[i] = (float(vals[ix]), float(vals[iy]), float(vals[iz]))
            return out

        endian = "<" if fmt == b"binary_little_endian" else ">"
        rec_fmt = endian + "".join(p[1] for p in vertex_props)
        rec_size = struct.calcsize(rec_fmt)
        buf = f.read(rec_size * n_verts)
        out = np.empty((n_verts, 3), np.float64)
        unpack = struct.Struct(rec_fmt).unpack_from
        for i in range(n_verts):
            vals = unpack(buf, i * rec_size)
            out[i] = (vals[ix], vals[iy], vals[iz])
        return out


def uniform_downsample(verts: np.ndarray, target: int) -> np.ndarray:
    """open3d uniform_down_sample(every_k_points=n/target) then truncate
    (reference preprocess_scene_s1.py:105-114)."""
    n = len(verts)
    if n <= target:
        return verts
    k = int(n / target)
    return verts[::k][:target]
