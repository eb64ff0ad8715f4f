"""Lifted ElGamal over Jubjub (reference no_std_aliases/elgamal.rs).

Enc(m) = ((m + r*s)G, rG) where s is the decryption key.  Homomorphic
add/sub; brute-force decrypt bounded at 1e6 (elgamal.rs:100-107) with an
optional baby-step/giant-step fast path.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..mirror import jubjub as jj
from .keys import EncryptionKey, DecryptionKey, BASE_INDEX

ELGAMAL_EXTEND_PERSONALIZATION = b"zech_elgamal_ext"

DECRYPT_BOUND = 1_000_000


def elgamal_extend(sk: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=64, person=ELGAMAL_EXTEND_PERSONALIZATION)
    h.update(sk)
    return h.digest()


@dataclass(frozen=True)
class Ciphertext:
    left: tuple  # affine Jubjub points
    right: tuple

    @classmethod
    def zero(cls) -> "Ciphertext":
        return cls(jj.ZERO, jj.ZERO)

    @classmethod
    def encrypt(
        cls, amount: int, randomness: int, enc_key: EncryptionKey,
        base_index: int = BASE_INDEX,
    ) -> "Ciphertext":
        g = jj.generator(base_index)
        right = jj.mul(g, randomness)
        v_point = jj.mul(g, amount)
        r_point = jj.mul(enc_key.point, randomness)
        return cls(jj.add(v_point, r_point), right)

    @classmethod
    def neg_encrypt(
        cls, amount: int, randomness: int, enc_key: EncryptionKey,
        base_index: int = BASE_INDEX,
    ) -> "Ciphertext":
        g = jj.generator(base_index)
        right = jj.mul(g, randomness)
        v_point = jj.neg(jj.mul(g, amount))
        r_point = jj.mul(enc_key.point, randomness)
        return cls(jj.add(v_point, r_point), right)

    def decrypt(
        self, dec_key: DecryptionKey, base_index: int = BASE_INDEX,
        bound: int = DECRYPT_BOUND, fast: bool = True,
    ):
        """Recover the u32 amount, or None if out of range."""
        sr = jj.mul(self.right, dec_key.fs)
        v_point = jj.add(self.left, jj.neg(sr))
        g = jj.generator(base_index)
        if not fast:
            acc = jj.ZERO
            for i in range(bound):
                if acc == v_point:
                    return i
                acc = jj.add(acc, g)
            return None
        # baby-step giant-step over [0, bound)
        m = int(bound ** 0.5) + 1
        table = {}
        acc = jj.ZERO
        for j in range(m):
            table[acc] = j
            acc = jj.add(acc, g)
        giant = jj.neg(jj.mul(g, m))
        cur = v_point
        for i in range(m + 1):
            if cur in table:
                val = i * m + table[cur]
                return val if val < bound else None
            cur = jj.add(cur, giant)
        return None

    def add(self, other: "Ciphertext") -> "Ciphertext":
        return Ciphertext(
            jj.add(self.left, other.left), jj.add(self.right, other.right)
        )

    def sub(self, other: "Ciphertext") -> "Ciphertext":
        return Ciphertext(
            jj.add(self.left, jj.neg(other.left)),
            jj.add(self.right, jj.neg(other.right)),
        )

    def to_bytes(self) -> bytes:
        return jj.to_bytes(self.left) + jj.to_bytes(self.right)

    @classmethod
    def from_bytes(cls, b: bytes) -> "Ciphertext":
        assert len(b) == 64
        return cls(
            jj.from_bytes_prime_order(b[:32]),
            jj.from_bytes_prime_order(b[32:]),
        )
