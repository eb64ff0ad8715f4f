"""Builds the CUDA sources under ``csrc/`` and loads them with ctypes.

Each ``*.cu`` file becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` at first use into ``_build/`` beside this
file.  The libraries of all the kernels can be compiled at once
(:func:`build_all` starts one ``nvcc`` per source), which is what a caller
that needs all of them should do first.  A build or load failure raises:
nothing here falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

SOURCES = ("ff_kernels", "ec_kernels", "totals_kernel", "hs_kernel",
           "column_scan_kernel", "split_tail_kernel", "jubjub_kernels",
           "ntt_kernel", "witness_kernel", "pairing_kernel")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
ptxas_log: dict[str, str] = {}


def nvcc_path() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}_{_digest(name)}.so"


def _start(name: str):
    """Start nvcc for one source; -> (process, temp path, final path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _target(name)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp, out) -> None:
    log, _ = proc.communicate()
    ptxas_log[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every source that is not built yet, all nvcc runs in parallel."""
    with _lock:
        jobs = [(n, *_start(n)) for n in SOURCES if not _target(n).exists()]
        errors = []
        for name, proc, tmp, out in jobs:
            try:
                _finish(name, proc, tmp, out)
            except RuntimeError as e:  # let the other compilers end first
                errors.append(e)
        if errors:
            raise errors[0]


def lib_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    return _target(name)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    got = _libs.get(name)
    if got is not None:
        return got
    with _lock:
        if name not in _libs:
            out = _target(name)
            if not out.exists():
                _finish(name, *_start(name))
            _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]
