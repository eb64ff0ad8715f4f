"""Batch RedJubjub verification on the card: ``redjubjub.batch_verify``'s
sum of 3N terms as one ``var_chain`` launch (ec/cuda_jubjub.py) for every
term's scalar multiply, a pairwise tree of Jubjub adds and the cofactor's
three doublings over the Fr field kernels.  Decompression and h_star stay
on the host (redjubjub.py).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import _device
from ..ec import cuda_jubjub
from ..ec import jubjub as ej
from ..ff import limbs as L
from ..mirror import jubjub as jj
from ..mirror.field import S
from .redjubjub import DEFAULT_BASE, h_star

N_BITS = 252  # S < 2^252: the bits of every term's scalar

# seconds of the last batch_verify_device call that reached the device:
# "host" (decompression, h_star, the chains' inputs on the device) and
# "device" (the chains, the tree, the cofactor and the read of the verdict)
last_timings: dict = {}


def _terms(entries, base_index, rand_scalars):
    """The host part of the device check (redjubjub.rs:166-204): the 3N
    points [R_i, vk_i, P_G] and scalars [z, c z, -s z] mod S; None when a
    signature is malformed (R does not decode, or s >= S)."""
    gen = jj.generator(base_index)
    pts, scalars = [], []
    for i, (vk, msg, sig) in enumerate(entries):
        try:
            r = jj.from_bytes(sig.rbar)
        except jj.DecodeError:
            return None
        s = int.from_bytes(sig.sbar, "little")
        if s >= S:
            return None
        c = h_star(sig.rbar, msg)
        z = (
            rand_scalars[i]
            if rand_scalars is not None
            else int.from_bytes(os.urandom(32), "little") % S
        )
        pts += [r, vk.point, gen]
        scalars += [z, c * z % S, (S - s * z % S) % S]
    return pts, scalars


def _chain_inputs(pts, scalars, device):
    """Affine bases (x, y), each (8, m) Fr words in Montgomery form, and the
    scalars' little-endian bits (252, m) as uint8, built with numpy."""
    fr = L.FR
    x = fr.array([p[0] for p in pts], device, mont=True)
    y = fr.array([p[1] for p in pts], device, mont=True)
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in scalars),
                        np.uint8).reshape(len(scalars), 32)
    bits = np.unpackbits(raw, axis=1, bitorder="little")[:, :N_BITS]
    return (x, y), torch.from_numpy(np.ascontiguousarray(bits.T)).to(device)


def _device_total(bases, bits):
    """sum_j scalar_j * base_j before the cofactor, as one extended point
    (X, Y, Z, T), each (8,) words: the 3N scalar multiplies in one
    ``var_chain`` launch, then the JAX package's pairwise tree of adds over
    the term axis, padded to a power of two with the identity."""
    _, res = cuda_jubjub.var_chain(bases, bits)
    X, Y, Z = res[:, :, -1]                  # each (8, m): the last step
    # projective (X : Y : Z) -> extended (XZ : YZ : Z^2 : XY), one launch
    muls = tuple(ej.mul(torch.stack([X, Y, Z, X], dim=1),
                        torch.stack([Z, Z, Z, Y], dim=1)).unbind(1))
    m = X.shape[-1]
    width = 1 << (m - 1).bit_length()
    if width != m:
        ident = ej.identity((width - m,), X.device)
        muls = tuple(torch.cat([a, i], dim=-1) for a, i in zip(muls, ident))
    while width > 1:
        half = width // 2
        muls = ej.add(tuple(a[..., :half] for a in muls),
                      tuple(a[..., half:width] for a in muls))
        width = half
    return tuple(a[..., 0] for a in muls)


def batch_verify_device(entries, base_index: int = DEFAULT_BASE,
                        rand_scalars=None, device=None) -> bool:
    """``batch_verify`` with the 3N-term sum

        sum_i  z_i R_i + (c_i z_i) vk_i + (-s_i z_i) P_G

    on the card (``device=None``; it raises where there is none, and runs
    the kernels' plain versions for ``device="cpu"``): the terms' 252-step
    double-and-adds in one ``var_chain`` launch with the 3N points on the
    lane axis, a log2(3N)-level tree of adds, three doublings for the
    cofactor and one read of the identity check.  Decompression and h_star
    stay on the host (byte-level Blake2b)."""
    device = _device.resolve(device)
    entries = list(entries)
    if not entries:
        return True
    t0 = time.perf_counter()
    terms = _terms(entries, base_index, rand_scalars)
    if terms is None:
        return False
    inputs = _chain_inputs(*terms, device)
    t1 = time.perf_counter()
    total = _device_total(*inputs)
    for _ in range(3):  # cofactor 8
        total = ej.double(total)
    ok = bool(ej.is_identity(total).item())
    last_timings.update(host=t1 - t0, device=time.perf_counter() - t1)
    return ok
