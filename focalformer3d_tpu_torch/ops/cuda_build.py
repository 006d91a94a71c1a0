"""Build and load the port's hand-written CUDA kernels.

Each source in ``focalformer3d_tpu_torch/csrc/`` has a plain C interface and
compiles with ``nvcc`` into a shared library of its own in
``focalformer3d_tpu_torch/_build/``, loaded with ``ctypes``. A library is
named by a hash of its source and flags, so an edited source is never served
by a stale build. ``build`` starts one nvcc per missing library, all at once,
and waits for all of them; nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(source: Path) -> Path:
    tag = hashlib.sha1(source.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def build(*sources: Path) -> Dict[str, float]:
    """Compile every source whose library is missing, one nvcc each, all
    started together. Returns the seconds each took, by source stem (0.0
    for a library already built); raises with nvcc's messages if any
    compile fails. No nvcc outlives the call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    secs: Dict[str, float] = {}
    jobs = {}
    t0 = time.perf_counter()
    try:
        for src in sources:
            lib = library_path(src)
            if lib.exists():
                secs[src.stem] = 0.0
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            log = BUILD_DIR / f"{src.stem}.{os.getpid()}.log"
            with open(log, "w") as fh:
                proc = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=fh, stderr=subprocess.STDOUT)
            jobs[src.stem] = (proc, tmp, lib, log)
        while any(stem not in secs for stem in jobs):
            for stem, (proc, *_rest) in jobs.items():
                if stem not in secs and proc.poll() is not None:
                    secs[stem] = time.perf_counter() - t0
            time.sleep(0.02)
    finally:
        for proc, *_rest in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    errors = []
    for stem, (proc, tmp, lib, log) in jobs.items():
        if proc.returncode != 0:
            errors.append(f"{stem}: nvcc exit {proc.returncode}\n"
                          f"{log.read_text()}")
        else:
            os.replace(tmp, lib)
        log.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return secs


def load(source: Path, symbol: str, argtypes: Sequence):
    """Build ``source`` if needed and return its C function ``symbol``,
    which returns a cudaError_t as an int."""
    build(source)
    fn = getattr(ctypes.CDLL(str(library_path(source))), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def on_card(*tensors) -> bool:
    """Whether a kernel's operands lie on a card (launch the kernel) or on
    the CPU (run its plain version); raises for operands on several devices
    or on another kind of device."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must be on one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def check_aligned(*tensors) -> None:
    """The kernels read and write 16-byte vectors."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("operands must be 16-byte aligned")


def check_launch(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


_COUNTERS: List["Launches"] = []


class Launches:
    """Launch counts of one module's kernels, by kind. A wrapper calls
    ``add(kind)`` where it launches its kernel. A call made while the
    current stream is being captured into a CUDA graph launches nothing: it
    is held apart until ``take_captured`` hands it to the code that replays
    the graph, and ``add_replays`` counts it once per replay."""

    def __init__(self, *kinds: str):
        self.counts = dict.fromkeys(kinds, 0)
        self.captured = dict.fromkeys(kinds, 0)
        _COUNTERS.append(self)

    def add(self, kind: str) -> None:
        held = (self.captured if torch.cuda.is_current_stream_capturing()
                else self.counts)
        held[kind] += 1

    def reset(self) -> None:
        for kind in self.counts:
            self.counts[kind] = 0


def take_captured() -> list:
    """The launches recorded in graph captures since the last call, as
    (counter, {kind: n}) pairs; clears them."""
    taken = []
    for counter in _COUNTERS:
        taken.append((counter, dict(counter.captured)))
        for kind in counter.captured:
            counter.captured[kind] = 0
    return taken


def add_replays(captured: list, replays: int) -> None:
    """Count ``replays`` replays of a graph whose capture recorded
    ``captured`` (from ``take_captured``)."""
    for counter, kinds in captured:
        for kind, n in kinds.items():
            counter.counts[kind] += n * replays
