"""Camera images on the host without Pillow: JPEG decoding and Pillow's
geometry on uint8 arrays.

The JAX data layer reads a camera with ``np.asarray(Image.open(path))`` and
resamples it with Pillow (``Image.resize``, ``crop``, ``transpose`` and
``rotate`` in ``ImageAug3D`` and ``ScaleImageMultiViewImage``); the card's
machine has no Pillow. Each function here is the counterpart of one of
those calls, bit for bit (``tests/test_torch_image_io.py`` holds them
against Pillow case by case):

- ``decode`` / ``imread``: the baseline JPEG decoder of
  ``data/native/jpeg_decode.cpp`` (libjpeg-turbo's ISLOW IDCT, fancy
  upsampling and YCbCr tables, as Pillow drives it). RGB comes back
  (H, W, 3) and grayscale (H, W), as Pillow gives them. Progressive,
  arithmetic-coded, lossless, 12-bit and CMYK files raise
  ``NotImplementedError`` (ROADMAP.md Queue 3: Pillow reads them, the port
  does not).
- ``resize``: ``Image.resize(size)`` with its default BICUBIC filter
  (``data/native/image_ops.cpp``).
- ``crop``: ``Image.crop(box)``, zeros where the box leaves the image.
- ``flip_lr``: ``Image.transpose(FLIP_LEFT_RIGHT)``.
- ``rotate``: ``Image.rotate(angle)`` with its defaults (NEAREST, the
  centre, ``expand=False``, fill 0): its special cases, its matrix rounded
  to 15 places, then the native nearest-neighbour affine.
- ``encode_jpeg`` / ``imwrite``: a baseline writer (4:2:0, Annex K tables,
  libjpeg's quality scaling) for fixtures; nothing on the data path uses
  it.

The native library is built at first use and raises with the compiler's
messages if it cannot be (no fallback). ``call_count`` counts decodes;
``stats`` gives the host seconds spent decoding and resampling since the
last ``reset_call_count`` (host clock around each native call, from every
thread).
"""
from __future__ import annotations

import ctypes
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Tuple

import numpy as np

from . import native

_UNSUPPORTED = 1
# the ROADMAP.md entry that records what the decoder leaves out
SCOPE = ("the port's decoder reads baseline and extended sequential Huffman "
         "JPEGs only (ROADMAP.md Queue 3, the decoder's scope)")

_lock = threading.Lock()
_stats = {"decodes": 0, "decode_s": 0.0, "resamples": 0, "resample_s": 0.0}

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _bind(lib: ctypes.CDLL) -> None:
    lib.ffj_jpeg_info.restype = ctypes.c_int
    lib.ffj_jpeg_info.argtypes = [_u8p, ctypes.c_int64, _i32p, _i32p, _i32p,
                                  ctypes.c_char_p, ctypes.c_int]
    lib.ffj_jpeg_decode.restype = ctypes.c_int
    lib.ffj_jpeg_decode.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                    ctypes.c_int64, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.ffj_jpeg_encode.restype = ctypes.c_int64
    lib.ffj_jpeg_encode.argtypes = [_u8p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, _u8p,
                                    ctypes.c_int64]
    lib.ffi_resize_bicubic.restype = None
    lib.ffi_resize_bicubic.argtypes = [_u8p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _u8p, ctypes.c_int,
                                       ctypes.c_int]
    lib.ffi_affine_nearest.restype = ctypes.c_int
    lib.ffi_affine_nearest.argtypes = [_u8p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _u8p, ctypes.c_int,
                                       ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_double)]


def _lib() -> ctypes.CDLL:
    return native.image_lib(_bind)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _count(kind: str, seconds: float) -> None:
    with _lock:
        _stats[kind + "s"] += 1
        _stats[kind + "_s"] += seconds


def call_count() -> int:
    """Decodes since the last ``reset_call_count``."""
    return _stats["decodes"]


def stats() -> dict:
    """Decodes and resamples since the last ``reset_call_count``, with the
    host seconds each took (summed over threads)."""
    with _lock:
        return dict(_stats)


def reset_call_count() -> None:
    with _lock:
        _stats.update(decodes=0, decode_s=0.0, resamples=0, resample_s=0.0)


def _raise(status: int, err: ctypes.Array, what: str) -> None:
    msg = err.value.decode(errors="replace")
    if status == _UNSUPPORTED:
        raise NotImplementedError(f"{what}: {msg}; {SCOPE}")
    raise ValueError(f"{what}: corrupt JPEG: {msg}")


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """``np.asarray(Image.open(io.BytesIO(data)))`` for a baseline JPEG:
    (H, W, 3) RGB or (H, W) grayscale uint8."""
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    t0 = time.perf_counter()
    status = lib.ffj_jpeg_info(_ptr(buf), buf.size, ctypes.byref(w),
                               ctypes.byref(h), ctypes.byref(c), err, 256)
    if status:
        _raise(status, err, name)
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, np.uint8)
    status = lib.ffj_jpeg_decode(_ptr(buf), buf.size, _ptr(out), out.size,
                                 err, 256)
    if status:
        _raise(status, err, name)
    _count("decode", time.perf_counter() - t0)
    return out


def imread(path) -> np.ndarray:
    """``np.asarray(Image.open(path))`` for a baseline JPEG file."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, str(path))


def parallel_map(fn: Callable, items: Iterable) -> List:
    """``[fn(x) for x in items]`` on a thread each: the native calls
    release the interpreter lock, so a sample's six cameras decode and
    resample side by side. Results keep their order; the first exception
    is raised."""
    items = list(items)
    if len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(len(items)) as ex:
        return list(ex.map(fn, items))


def _image(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected an (H, W[, C]) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.resize(size)`` (size is (W, H)) with the default BICUBIC
    filter."""
    img = _image(img)
    W, H = (int(v) for v in size)
    if W <= 0 or H <= 0:
        raise ValueError(f"resize to {size}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((H, W) + img.shape[2:], np.uint8)
    t0 = time.perf_counter()
    _lib().ffi_resize_bicubic(_ptr(img), h, w, c, _ptr(out), H, W)
    _count("resample", time.perf_counter() - t0)
    return out


def crop(img: np.ndarray, box) -> np.ndarray:
    """``Image.crop(box)``: box (left, upper, right, lower), each rounded
    as Pillow rounds it; zeros where the box leaves the image."""
    img = _image(img)
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    h, w = img.shape[:2]
    out = np.zeros((max(0, y1 - y0), max(0, x1 - x0)) + img.shape[2:],
                   np.uint8)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x1, w), min(y1, h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


def flip_lr(img: np.ndarray) -> np.ndarray:
    """``Image.transpose(FLIP_LEFT_RIGHT)``."""
    return np.ascontiguousarray(_image(img)[:, ::-1])


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """``Image.rotate(angle)`` with its defaults: counter-clockwise by
    ``angle`` degrees about (W / 2, H / 2), nearest neighbour, the input's
    size, 0 outside."""
    img = _image(img)
    h, w = img.shape[:2]
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        # Transpose.ROTATE_90 / ROTATE_270
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    a, b, _, d, e, _ = m
    # Pillow: matrix[2], matrix[5] = transform(-cx, -cy); then += cx, cy
    m[2] = (a * -cx + b * -cy + 0.0) + cx
    m[5] = (d * -cx + e * -cy + 0.0) + cy
    c = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty_like(img)
    mat = (ctypes.c_double * 6)(*m)
    t0 = time.perf_counter()
    if _lib().ffi_affine_nearest(_ptr(img), h, w, c, _ptr(out), h, w, mat):
        raise NotImplementedError(
            f"rotate of a {w} x {h} image: Pillow's floating-point affine "
            "(a corner beyond +-32768 pixels) is not ported")
    _count("resample", time.perf_counter() - t0)
    return out


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """A baseline JFIF file of an (H, W, 3) RGB (4:2:0) or (H, W) gray
    uint8 image, quality scaled as libjpeg scales it. For fixtures only."""
    img = _image(img)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    if c not in (1, 3) or not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"cannot encode an image of shape {img.shape}")
    cap = 1024 + 2 * img.size
    out = np.empty(cap, np.uint8)
    n = _lib().ffj_jpeg_encode(_ptr(img), h, w, c, int(quality), _ptr(out),
                               cap)
    if n < 0:
        raise RuntimeError("JPEG writer: output larger than its buffer")
    return out[:n].tobytes()


def imwrite(path, img: np.ndarray, quality: int = 90) -> None:
    """Write ``img`` as a baseline 4:2:0 JPEG (fixtures only)."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality))
