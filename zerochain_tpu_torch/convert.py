"""Carries state of the JAX package (``zerochain_tpu``) over to this port.

Numpy in, tensors out; nothing of the JAX package is imported.  The JAX
package stores a field element as int32 limbs of 12 bits, limbs leading:
``(n12, *batch)`` with n12 = 32 for Fq (R = 2^384) and 22 for Fr/Fs
(R = 2^264).  This port stores 32-bit words: 12 for Fq (R = 2^384), 8 for
Fr/Fs (R = 2^256).

- Fq Montgomery representatives are the same integers on both sides (same
  R): conversion is pure bit repacking.
- Fr/Fs Montgomery representatives differ (R = 2^264 against 2^256), so
  Montgomery arrays go through canonical form: multiply by R_ref^-1 R_port
  (or its inverse) as Python integers.
"""

from __future__ import annotations

import numpy as np
import torch

from .ff import limbs as L
from .prover.pipeline import queries_from_arrays

REF_LIMB_BITS = 12
REF_LIMBS = {"Fq": 32, "Fr": 22, "Fs": 22}


def _ref_to_ints(arr: np.ndarray) -> list[int]:
    """(n12, N) 12-bit limb planes -> ints."""
    a = np.asarray(arr).astype(np.int64)
    n12, count = a.shape
    out = [0] * count
    # fold four limbs (48 bits) at a time to keep the Python loop short
    for base in range(0, n12, 4):
        chunk = np.zeros(count, dtype=np.int64)
        for k in range(min(4, n12 - base)):
            chunk |= a[base + k] << (REF_LIMB_BITS * k)
        shift = REF_LIMB_BITS * base
        for j, v in enumerate(chunk.tolist()):
            out[j] |= v << shift
    return out


def _ints_to_ref(vals, n12: int) -> np.ndarray:
    out = np.zeros((n12, len(vals)), dtype=np.int32)
    for j, v in enumerate(vals):
        for k in range(n12):
            out[k, j] = (v >> (REF_LIMB_BITS * k)) & 0xFFF
    return out


def from_ref_limbs(spec: L.FieldSpec, arr, mont: bool, device="cpu"):
    """JAX-package limb array (n12, *batch) -> this port's word tensor
    (n_words, *batch).  ``mont`` says the values are Montgomery
    representatives (and stay so, under this port's R)."""
    arr = np.asarray(arr)
    n12 = REF_LIMBS[spec.name]
    assert arr.shape[0] == n12, (arr.shape, n12)
    batch = arr.shape[1:]
    vals = _ref_to_ints(arr.reshape(n12, -1))
    r_ref = pow(2, REF_LIMB_BITS * n12, spec.p)
    if mont and r_ref != spec.r_mod_p:
        fix = pow(r_ref, -1, spec.p) * spec.r_mod_p % spec.p
        vals = [v * fix % spec.p for v in vals]
    words = L.ints_to_words_np(vals, spec.n).reshape(spec.n, *batch)
    return torch.from_numpy(words).to(device)


def to_ref_limbs(spec: L.FieldSpec, words, mont: bool) -> np.ndarray:
    """This port's word tensor -> JAX-package limb array (numpy int32)."""
    n12 = REF_LIMBS[spec.name]
    batch = tuple(words.shape[1:])
    vals = L.words_to_ints_np(words.detach().cpu().numpy().reshape(spec.n, -1))
    r_ref = pow(2, REF_LIMB_BITS * n12, spec.p)
    if mont and r_ref != spec.r_mod_p:
        fix = pow(spec.r_mod_p, -1, spec.p) * r_ref % spec.p
        vals = [v * fix % spec.p for v in vals]
    return _ints_to_ref(vals, n12).reshape(n12, *batch)


def points_from_ref(pts, device="cpu"):
    """A Jacobian point tuple of the JAX package (G1: three Fq limb arrays;
    G2: three pairs) -> this port's point tuple."""
    def conv(c):
        if isinstance(c, (tuple, list)):
            return tuple(from_ref_limbs(L.FQ, x, mont=True, device=device)
                         for x in c)
        return from_ref_limbs(L.FQ, c, mont=True, device=device)

    return tuple(conv(c) for c in pts)


def fq12_from_ref(a, device="cpu"):
    """A JAX-package Fq12 (nested tuples ((3 x Fq2), (3 x Fq2)) of Fq
    Montgomery limb arrays (32, *batch)) -> this port's tower tensor
    (12, 2, 3, 2, *batch) (``ec/tower.py``)."""
    return torch.stack([torch.stack([torch.stack(
        [from_ref_limbs(L.FQ, a[h][i][c], mont=True, device=device)
         for c in range(2)], 1) for i in range(3)], 2) for h in range(2)], 3)


def queries_from_ref_npz(path: str):
    """Read an ``.npz`` written by the JAX package's
    ``ConfidentialProver.save_queries`` (keys ``h_x`` ... ``b2_z1``, ``vk``)
    -> ``(queries, vk)`` for ``ConfidentialProver(None,
    _device_queries=queries, _vk=vk, device=...)``."""
    from .groth16.serialization import vk_from_bytes

    with np.load(path) as z:
        conv = {
            k: from_ref_limbs(L.FQ, z[k], mont=True).numpy()
            for k in z.files if k != "vk"
        }
        vk = vk_from_bytes(z["vk"].tobytes())
    return queries_from_arrays(conv), vk
