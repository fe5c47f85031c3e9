"""ctypes bindings for the native host-side data kernels (native/): a copy
of egohmr_tpu/native.py, which has no framework code. The host library
`native/egohmr_native.cc` is shared by both packages.

Auto-builds `libegohmr_native.so` with make on first use if the toolchain is
available; every entry point has a pure-python fallback so the framework
works without a compiler.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libegohmr_native.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.decode_jpeg_file.restype = ctypes.c_int
    lib.decode_jpeg_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.warp_affine_norm.restype = None
    lib.warp_affine_norm.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32]
    lib.load_batch.restype = ctypes.c_int
    lib.load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_jpeg(path: str) -> Optional[np.ndarray]:
    """RGB uint8 [H, W, 3] or None on failure / missing lib."""
    lib = _load()
    if lib is None:
        return None
    cap = 4096 * 4096 * 3
    buf = np.empty(cap, np.uint8)
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    rc = lib.decode_jpeg_file(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    return buf[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def warp_affine_norm(
    img: np.ndarray, trans: np.ndarray, out_size: int,
    color_scale=(1.0, 1.0, 1.0),
    mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0), chw: bool = True,
) -> Optional[np.ndarray]:
    """Fused crop-warp + color jitter + normalize. img: [H, W, 3] uint8."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    t = np.ascontiguousarray(trans, np.float32)
    cs = np.asarray(color_scale, np.float32)
    me = np.asarray(mean, np.float32)
    sd = np.asarray(std, np.float32)
    out = (np.empty((3, out_size, out_size), np.float32) if chw
           else np.empty((out_size, out_size, 3), np.float32))
    lib.warp_affine_norm(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img.shape[0], img.shape[1], _fptr(t), out_size, _fptr(out),
        _fptr(cs), _fptr(me), _fptr(sd), 1 if chw else 0)
    return out


def load_batch(
    paths: Sequence[str], trans: np.ndarray, flips: np.ndarray,
    color_scales: np.ndarray, mean, std, out_size: int,
    num_threads: int = 0, strict: bool = True,
) -> Optional[np.ndarray]:
    """Threaded decode+flip+warp+normalize.

    trans: [N, 2, 3]; flips: [N] bool; color_scales: [N, 3].
    Returns [N, S, S, 3] float32 (NHWC) or None if unavailable.

    A corrupt/missing file raises (strict=True default) — the C++ side
    zero-fills the failed slot, and training on black images with real
    labels would silently corrupt gradients (the PIL path, like the torch
    reference's Image.open, crashes loudly). strict=False keeps the
    zero-fill + warning for salvage-style offline use.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    enc = [p.encode() for p in paths]
    arr = (ctypes.c_char_p * n)(*enc)
    t = np.ascontiguousarray(trans, np.float32)
    fl = np.ascontiguousarray(flips, np.uint8)
    cs = np.ascontiguousarray(color_scales, np.float32)
    me = np.asarray(mean, np.float32)
    sd = np.asarray(std, np.float32)
    out = np.empty((n, out_size, out_size, 3), np.float32)
    failures = lib.load_batch(
        arr, n, _fptr(t), fl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _fptr(cs), _fptr(me), _fptr(sd), out_size, _fptr(out), num_threads)
    if failures:
        if strict:
            raise RuntimeError(
                f"native load_batch: {failures}/{n} items failed to decode "
                "(corrupt or missing image files); failed slots are "
                "zero-filled — refusing to train on them. Pass strict=False "
                "to keep going with a warning.")
        import logging

        logging.getLogger("egohmr_tpu_torch").warning(
            "native load_batch: %d/%d items failed to decode", failures, n)
    return out
