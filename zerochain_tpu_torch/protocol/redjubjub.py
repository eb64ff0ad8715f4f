"""RedJubjub (RedDSA on Jubjub) — reference core/jubjub/src/redjubjub.rs.

Signatures are (rbar, sbar) 32-byte pairs; h_star is Blake2b-64 with
personalization "Zcash_RedJubjubH" reduced to Fs.  Verification is the
cofactor-multiplied check  8*(-S.P_G + R + c.vk) == 0  (redjubjub.rs:150-155).

``batch_verify`` is the host's bigint loop; ``batch_verify_device`` sums the
same 3N terms on the card: one ``var_chain`` launch (ec/cuda_jubjub.py) for
every term's scalar multiply, a pairwise tree of Jubjub adds and the
cofactor's three doublings over the Fr field kernels.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import _device
from ..ec import cuda_jubjub
from ..ec import jubjub as ej
from ..ff import limbs as L
from ..mirror import jubjub as jj
from ..mirror.field import S, fs_to_uniform

H_STAR_PERSONALIZATION = b"Zcash_RedJubjubH"

# The runtime signs with SpendingKeyGenerator... the reference's extrinsic
# flow signs with the same base used for rvk (NoteCommitmentRandomness);
# callers pass the index explicitly.
DEFAULT_BASE = jj.SPENDING_KEY_GENERATOR


def h_star(a: bytes, b: bytes) -> int:
    h = hashlib.blake2b(digest_size=64, person=H_STAR_PERSONALIZATION)
    h.update(a)
    h.update(b)
    return fs_to_uniform(h.digest())


@dataclass(frozen=True)
class Signature:
    rbar: bytes
    sbar: bytes

    def to_bytes(self) -> bytes:
        return self.rbar + self.sbar

    @classmethod
    def from_bytes(cls, b: bytes) -> "Signature":
        assert len(b) == 64
        return cls(b[:32], b[32:])


@dataclass(frozen=True)
class PrivateKey:
    fs: int

    def randomize(self, alpha: int) -> "PrivateKey":
        return PrivateKey((self.fs + alpha) % S)

    def sign(self, msg: bytes, base_index: int = DEFAULT_BASE,
             t: bytes | None = None) -> Signature:
        if t is None:
            t = os.urandom(80)
        assert len(t) == 80
        r = h_star(t, msg)
        r_g = jj.mul(jj.generator(base_index), r)
        rbar = jj.to_bytes(r_g)
        s = (h_star(rbar, msg) * self.fs + r) % S
        return Signature(rbar, s.to_bytes(32, "little"))

    def public_key(self, base_index: int = DEFAULT_BASE) -> "PublicKey":
        return PublicKey(jj.mul(jj.generator(base_index), self.fs))

    def to_bytes(self) -> bytes:
        return self.fs.to_bytes(32, "little")

    @classmethod
    def from_bytes(cls, b: bytes) -> "PrivateKey":
        v = int.from_bytes(b, "little")
        if v >= S:
            raise ValueError("scalar not in field")
        return cls(v)


@dataclass(frozen=True)
class PublicKey:
    point: tuple  # unknown-order Jubjub point

    def randomize(self, alpha: int, base_index: int = DEFAULT_BASE) -> "PublicKey":
        return PublicKey(
            jj.add(jj.mul(jj.generator(base_index), alpha), self.point)
        )

    def verify(self, msg: bytes, sig: Signature,
               base_index: int = DEFAULT_BASE) -> bool:
        c = h_star(sig.rbar, msg)
        try:
            r = jj.from_bytes(sig.rbar)
        except jj.DecodeError:
            return False
        s = int.from_bytes(sig.sbar, "little")
        if s >= S:
            return False
        # 8 * (-s.G + R + c.vk) == 0
        acc = jj.mul(self.point, c)
        acc = jj.add(acc, r)
        acc = jj.add(acc, jj.neg(jj.mul(jj.generator(base_index), s)))
        return jj.mul_by_cofactor(acc) == jj.ZERO

    def to_bytes(self) -> bytes:
        return jj.to_bytes(self.point)

    @classmethod
    def from_bytes(cls, b: bytes) -> "PublicKey":
        return cls(jj.from_bytes(b))


def batch_verify(entries, base_index: int = DEFAULT_BASE,
                 rand_scalars=None) -> bool:
    """Randomized batch verification (redjubjub.rs:166-204).

    entries: iterable of (PublicKey, msg bytes, Signature)."""
    acc = jj.ZERO
    for i, (vk, msg, sig) in enumerate(entries):
        try:
            r = jj.from_bytes(sig.rbar)
        except jj.DecodeError:
            return False
        s = int.from_bytes(sig.sbar, "little")
        if s >= S:
            return False
        c = h_star(sig.rbar, msg)
        z = (
            rand_scalars[i]
            if rand_scalars is not None
            else int.from_bytes(os.urandom(32), "little") % S
        )
        acc = jj.add(acc, jj.mul(r, z))
        acc = jj.add(acc, jj.mul(vk.point, c * z % S))
        acc = jj.add(
            acc, jj.neg(jj.mul(jj.generator(base_index), s * z % S))
        )
    return jj.mul_by_cofactor(acc) == jj.ZERO


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
