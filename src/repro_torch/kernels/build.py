"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  All sources compile in parallel, one ``nvcc`` each,
on first use, into ``build/kernels/`` at the repository root; a library's
file name carries a hash of every source and header and of the flags, so an
edited source is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("enec_decode", "decompress_matmul", "enec_encode", "idd_scan",
           "decode_attention_kv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}     # name -> {"seconds", "cached", "ptxas"}


class LaunchCounter:
    """Plain count of one kernel entry's launches, kept in Python by the
    entry's wrapper.  Every counter registers itself under ``name``, so a
    CUDA graph, whose replays run no Python, can add what its capture
    counted (:func:`counts`, :func:`restore`, :func:`add`)."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0
        _COUNTERS[name] = self

    def reset(self):
        self.n = 0


_COUNTERS: dict = {}     # name -> LaunchCounter


def counts() -> dict:
    """Every launch counter's value, by name."""
    return {name: c.n for name, c in _COUNTERS.items()}


def restore(values: dict) -> None:
    """Set the counters back to ``values`` (a capture launched nothing)."""
    for name, n in values.items():
        _COUNTERS[name].n = n


def add(delta: dict) -> None:
    """Add ``delta`` to the counters (a replay launched what its capture
    recorded)."""
    for name, n in delta.items():
        _COUNTERS[name].n += n


def capturing() -> bool:
    """Is the current CUDA stream capturing a graph?"""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def refuse_in_capture(what: str) -> None:
    """Raise if a CUDA graph is being captured on the current stream: for
    host-side state that a replay would not renew."""
    if capturing():
        raise RuntimeError(f"{what} cannot be made or run inside a CUDA "
                           f"graph capture")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fixed = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fixed):
        return fixed
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source that has no current library (in parallel) and
    load them all; returns the loaded ``ctypes.CDLL`` by source name."""
    with _lock:
        if _libs:
            return _libs
        refuse_in_capture("the kernels' build")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        digest = _digest()
        jobs = {}
        t0 = time.perf_counter()
        for name in SOURCES:
            lib = BUILD_DIR / f"lib{name}-{digest}.so"
            if lib.exists():
                BUILD_LOG[name] = {"seconds": 0.0, "cached": True,
                                   "ptxas": ""}
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            jobs[name] = (lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        failed = []
        for name, (lib, tmp, proc) in jobs.items():
            out, err = proc.communicate()
            BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                               "cached": False, "ptxas": out + err}
            if proc.returncode:
                failed.append(f"{name}.cu:\n{out}{err}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(
                str(BUILD_DIR / f"lib{name}-{digest}.so"))
        return _libs


def load(name: str) -> ctypes.CDLL:
    return build_all()[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
