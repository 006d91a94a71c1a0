"""ctypes bindings and on-demand builds of the native host libraries.

Two libraries, each compiled with g++ at first use into
``focalformer3d_tpu_torch/_build/`` under a name that hashes its sources
and the compiler command, so an edited source is never served by a stale
build. Nothing is built when the module is imported.

- The point loader, the port's copy of ``focalformer3d_tpu/data/native``:
  ``pointloader.cpp`` (the same source), ``g++ -O3 -shared -fPIC
  -std=c++17 -pthread``. Where the JAX copy returns ``None`` when the
  library cannot be built and its caller quietly takes the numpy path,
  this one raises, with the compiler's messages: a caller that asks for
  the native loader gets it or an error
  (``load_points_multisweep(use_native=False)`` is the numpy path).
  ``call_count`` counts the calls that loaded a sample natively.
- The image library (``image_lib``): ``jpeg_decode.cpp``, ``image_ops.cpp``
  and ``jpeg_encode.cpp``, with ``-ffp-contract=off`` (Pillow's resampler
  computes its coefficients without fused multiply-adds). Its bindings are
  ``data/image_io.py``; it has no fallback either.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "pointloader.cpp"
IMAGE_SOURCES = (HERE / "jpeg_decode.cpp", HERE / "image_ops.cpp",
                 HERE / "jpeg_encode.cpp")
BUILD_DIR = HERE.parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
IMAGE_FLAGS = CXX_FLAGS + ("-ffp-contract=off",)

_libs = {}
_lock = threading.Lock()  # one build even with a prefetch thread
_calls = [0]


def _library_path(stem: str, sources, flags) -> Path:
    h = hashlib.sha1(" ".join((CXX, *flags)).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:12]}.so"


def library_path() -> Path:
    return _library_path("pointloader", (SOURCE,), CXX_FLAGS)


def _build(lib: Path, sources, flags, what: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *flags, *map(str, sources), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"native {what}: cannot run {CXX!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native {what}: {' '.join(cmd)} exited with "
            f"{proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, lib)


def _load(lib_path: Path, sources, flags, what: str, bind) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(lib_path)
        if lib is not None:
            return lib
        if not lib_path.exists():
            _build(lib_path, sources, flags, what)
        lib = ctypes.CDLL(str(lib_path))
        bind(lib)
        _libs[lib_path] = lib
        return lib


def _bind_pointloader(lib: ctypes.CDLL) -> None:
    lib.ffl_load_sweeps.restype = ctypes.c_int64
    lib.ffl_load_sweeps.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
    ]


def get_lib() -> ctypes.CDLL:
    """The point loader, built first if it is missing; raises if it
    cannot be built or loaded."""
    return _load(library_path(), (SOURCE,), CXX_FLAGS, "point loader",
                 _bind_pointloader)


def image_lib(bind) -> ctypes.CDLL:
    """The image library, built first if it is missing and bound by
    ``bind(lib)`` when first loaded; raises if it cannot be built or
    loaded."""
    path = _library_path("imageio", IMAGE_SOURCES, IMAGE_FLAGS)
    return _load(path, IMAGE_SOURCES, IMAGE_FLAGS, "image library", bind)


def call_count() -> int:
    return _calls[0]


def reset_call_count() -> None:
    _calls[0] = 0


def load_sweeps_native(
    paths,
    rotations: np.ndarray,  # (n, 3, 3) float32
    translations: np.ndarray,  # (n, 3) float32
    time_lags: np.ndarray,  # (n,) float32
    use_rot: np.ndarray,  # (n,) uint8
    use_trans: np.ndarray,
    remove_close: np.ndarray,
    load_dim: int = 5,
    close_radius: float = 1.0,
    capacity: int = 400000,
    n_threads: int = 8,
) -> np.ndarray:
    """Parallel load + transform + concatenation of a sample's files;
    returns (rows, load_dim), at most ``capacity`` rows."""
    lib = get_lib()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(
        *[str(p).encode() for p in paths]
    )
    rot = np.ascontiguousarray(rotations, np.float32)
    tr = np.ascontiguousarray(translations, np.float32)
    tl = np.ascontiguousarray(time_lags, np.float32)
    ur = np.ascontiguousarray(use_rot, np.uint8)
    ut = np.ascontiguousarray(use_trans, np.uint8)
    rc = np.ascontiguousarray(remove_close, np.uint8)
    for a, shape in ((rot, (n, 3, 3)), (tr, (n, 3)), (tl, (n,)), (ur, (n,)),
                     (ut, (n,)), (rc, (n,))):
        if a.shape != shape:
            raise ValueError(f"expected shape {shape}, got {a.shape}")
    out = np.empty((capacity, load_dim), np.float32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def up(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    rows = lib.ffl_load_sweeps(
        c_paths, n, fp(rot), fp(tr), fp(tl), up(ur), up(ut), up(rc),
        load_dim, ctypes.c_float(close_radius), fp(out),
        ctypes.c_int64(capacity), n_threads,
    )
    with _lock:
        _calls[0] += 1
    return out[:rows]
