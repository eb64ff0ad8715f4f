"""ctypes loader + NumPy fallback for the native codec (codec.c).

Builds ``libzc_codec_<digest>.so`` with cc on first use into the package's
``_build/`` directory (the digest is of the source and the flags, so an
edited source is rebuilt); every entry point has a pure-NumPy version, its
plain version, which runs where no C compiler is present.
``native_available()`` says which of the two is in use.

``scalars_to_bits_np`` is the host half of every scalar the port sends to
the card: the fixed-base MSMs of setup (prover/backend.py), the proof's
blinding scalars and its witness bits (msm/pippenger.py's
``scalars_to_bits``, prover/witness.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "codec.c"
BUILD_DIR = _SRC.parent.parent / "_build"
CC_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None


def _target() -> pathlib.Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CC_FLAGS).encode())
    return BUILD_DIR / f"libzc_codec_{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> bool:
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["cc", *CC_FLAGS, str(_SRC), "-o", str(tmp)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, out)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = _target()
    if not so.exists() and not _build(so):
        _lib = False
        return _lib
    try:
        lib = ctypes.CDLL(str(so))
        for name, args in [
            ("scalars_to_bits",
             [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]),
            ("scalars_to_limbs",
             [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]),
            ("limbs_to_scalars",
             [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]),
        ]:
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        _lib = lib
    except OSError:
        _lib = False
    return _lib


def native_available() -> bool:
    return bool(_load())


def _scalar_bytes(scalars: list[int]) -> np.ndarray:
    """ints (< 2^256) -> (N, 32) uint8, little-endian rows."""
    raw = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(scalars), 32)


def scalars_to_bits_np(scalars: list[int], n_bits: int = 255) -> np.ndarray:
    """ints -> (n_bits, N) int32 LE bit planes."""
    n = len(scalars)
    lib = _load()
    if lib:
        sb = np.ascontiguousarray(_scalar_bytes(scalars))
        out = np.empty((n_bits, n), dtype=np.int32)
        lib.scalars_to_bits(
            sb.ctypes.data, n, n_bits, out.ctypes.data
        )
        return out
    # NumPy fallback: unpack bits from the byte matrix
    sb = _scalar_bytes(scalars)  # (N, 32)
    bits = np.unpackbits(sb, axis=1, bitorder="little")  # (N, 256)
    out = np.zeros((n_bits, n), dtype=np.int32)
    take = min(n_bits, 256)
    out[:take] = bits[:, :take].T
    return out


def scalars_to_limbs_np(scalars: list[int], n_limbs: int) -> np.ndarray:
    """ints -> (n_limbs, N) int32 12-bit limb planes."""
    n = len(scalars)
    lib = _load()
    if lib:
        sb = np.ascontiguousarray(_scalar_bytes(scalars))
        out = np.empty((n_limbs, n), dtype=np.int32)
        lib.scalars_to_limbs(sb.ctypes.data, n, n_limbs, out.ctypes.data)
        return out
    out = np.zeros((n_limbs, n), dtype=np.int32)
    for j, s in enumerate(scalars):
        for l in range(n_limbs):
            out[l, j] = (s >> (12 * l)) & 0xFFF
    return out


def limbs_to_scalars(limbs: np.ndarray) -> list[int]:
    """(n_limbs, N) canonical int32 limb planes -> ints (≤ 256 bits)."""
    n_limbs, n = limbs.shape
    lib = _load()
    if lib:
        ll = np.ascontiguousarray(limbs, dtype=np.int32)
        out = np.empty((n, 32), dtype=np.uint8)
        lib.limbs_to_scalars(ll.ctypes.data, n, n_limbs, out.ctypes.data)
        return [int.from_bytes(row.tobytes(), "little") for row in out]
    vals = []
    for j in range(n):
        v = 0
        for l in range(n_limbs - 1, -1, -1):
            v = (v << 12) | int(limbs[l, j])
        vals.append(v)
    return vals
