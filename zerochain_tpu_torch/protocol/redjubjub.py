"""RedJubjub (RedDSA on Jubjub) — reference core/jubjub/src/redjubjub.rs.

Signatures are (rbar, sbar) 32-byte pairs; h_star is Blake2b-64 with
personalization "Zcash_RedJubjubH" reduced to Fs.  Verification is the
cofactor-multiplied check  8*(-S.P_G + R + c.vk) == 0  (redjubjub.rs:150-155).

``batch_verify`` is the host's bigint loop; ``redjubjub_device.py`` sums the
same 3N terms on the card.  This module is host-only: it imports no torch,
so that the wallet's and the chain's commands start without it.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

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
