"""ctypes binding of the native fast image loader (native/fastloader.cpp,
built by native/build.sh into native/libfastloader.so): the counterpart of
vivqa_tpu/data/fastloader.py, which binds the same library with cffi.

The library is a host-side C++ JPEG loader with its own thread pool, not
a device kernel. Its three entry points:
  fl_decode_resize_normalize  one JPEG buffer -> float32 HWC
  fl_batch_load               N paths -> float32 NHWC (eval / inference)
  fl_batch_load_train         N paths -> augmented float32 NHWC (flip,
                              color jitter, grayscale, rotation,
                              translation, random erasing: the
                              STRENGTH_PRESETS semantics), per-image
                              splitmix64 streams from one 64-bit seed
As in the JAX package the library is optional: where it cannot be loaded
(not built, or libjpeg missing) ``is_available()`` is False,
``ImageAugmentation.batch`` returns None and the loader takes the PIL
path.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from vivqa_tpu_torch.data.augmentation import CLIP_MEAN, CLIP_STD

_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_int_p = ctypes.POINTER(ctypes.c_int)
_LIB: list = []       # [ctypes.CDLL] once loaded, [None] once it failed


def _find_library() -> Optional[str]:
    candidates = [
        Path(__file__).resolve().parents[2] / "native" / "libfastloader.so",
        Path(os.environ.get("VIVQA_FASTLOADER", "")),
    ]
    for c in candidates:
        if str(c) not in ("", ".") and c.is_file():
            return str(c)
    return None


def get_fastloader() -> Optional[ctypes.CDLL]:
    """The loaded library, or None where it is missing or cannot be
    loaded (a missing libjpeg.so.62 raises OSError in ``CDLL``)."""
    if _LIB:
        return _LIB[0]
    path = _find_library()
    lib = None
    if path is not None:
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            lib = None
    if lib is not None:
        lib.fl_decode_resize_normalize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, _c_float_p,
            _c_float_p, _c_float_p]
        lib.fl_decode_resize_normalize.restype = ctypes.c_int
        lib.fl_batch_load.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            _c_float_p, _c_float_p, _c_float_p, _c_int_p, ctypes.c_int]
        lib.fl_batch_load.restype = ctypes.c_int
        lib.fl_batch_load_train.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            _c_float_p, _c_float_p, _c_float_p, _c_int_p, ctypes.c_int,
            ctypes.c_uint64] + [ctypes.c_float] * 6
        lib.fl_batch_load_train.restype = ctypes.c_int
    _LIB.append(lib)
    return lib


def is_available() -> bool:
    return get_fastloader() is not None


def _require():
    lib = get_fastloader()
    if lib is None:
        raise RuntimeError("native fastloader not built or not loadable: "
                           "run native/build.sh or use ImageAugmentation")
    return lib


def _f32(a: np.ndarray):
    return a.ctypes.data_as(_c_float_p)


def _prepare(paths: Sequence[str], image_size: int, mean, std,
             threads: int):
    n = len(paths)
    out = np.empty((n, image_size, image_size, 3), np.float32)
    status = np.empty((n,), np.int32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError(f"mean and std take 3 channels, got "
                         f"{mean.shape} and {std.shape}")
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    return n, out, status, mean, std, c_paths, threads


def batch_load(paths: Sequence[str], image_size: int,
               mean: np.ndarray = CLIP_MEAN, std: np.ndarray = CLIP_STD,
               threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """paths -> ((N, S, S, 3) float32, status (N,) int32; 0 = ok,
    failures are zero-filled)."""
    lib = _require()
    n, out, status, mean, std, c_paths, threads = _prepare(
        paths, image_size, mean, std, threads)
    lib.fl_batch_load(c_paths, n, image_size, _f32(mean), _f32(std),
                      _f32(out), status.ctypes.data_as(_c_int_p), threads)
    return out, status


def batch_load_train(paths: Sequence[str], image_size: int, preset: dict,
                     seed: int, mean: np.ndarray = CLIP_MEAN,
                     std: np.ndarray = CLIP_STD,
                     threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Training-path batch load: decode + augment (per the
    STRENGTH_PRESETS dict) + normalize, one native call. Deterministic
    given ``seed`` (taken to 64 bits), whatever the thread schedule."""
    lib = _require()
    n, out, status, mean, std, c_paths, threads = _prepare(
        paths, image_size, mean, std, threads)
    lib.fl_batch_load_train(
        c_paths, n, image_size, _f32(mean), _f32(std), _f32(out),
        status.ctypes.data_as(_c_int_p), threads,
        seed & 0xFFFFFFFFFFFFFFFF,
        float(preset.get("flip_p", 0.0)), float(preset.get("jitter", 0.0)),
        float(preset.get("gray_p", 0.0)), float(preset.get("rot_deg", 0.0)),
        float(preset.get("trans", 0.0)), float(preset.get("erase_p", 0.0)))
    return out, status


def decode_one(jpeg_bytes: bytes, image_size: int,
               mean: np.ndarray = CLIP_MEAN,
               std: np.ndarray = CLIP_STD) -> Optional[np.ndarray]:
    """One JPEG buffer -> (S, S, 3) float32, None on a decode failure or
    without the library."""
    lib = get_fastloader()
    if lib is None:
        return None
    out = np.empty((image_size, image_size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    rc = lib.fl_decode_resize_normalize(jpeg_bytes, len(jpeg_bytes),
                                        image_size, _f32(mean), _f32(std),
                                        _f32(out))
    return out if rc == 0 else None
