"""Key hierarchy (reference core/proofs/src/no_std_aliases/keys.rs).

seed --Blake2b-64("zech_ExpandSeed_")--> SpendingKey (Fs)
    --mul by NoteCommitmentRandomness base--> ProofGenerationKey (point)
    --Blake2s-32("zech_bdk"), drop 5 MSBs--> DecryptionKey (Fs)
    --mul by base--> EncryptionKey (point, the on-chain address)
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..mirror import jubjub as jj
from ..mirror.field import S, fs_to_uniform

PRF_EXPAND_PERSONALIZATION = b"zech_ExpandSeed_"
CRH_BDK_PERSONALIZATION = b"zech_bdk"
KEY_DIVERSIFICATION_PERSONALIZATION = b"zech_div"

BASE_INDEX = jj.NOTE_COMMITMENT_RANDOMNESS


def prf_expand_vec(sk: bytes, ts=()) -> bytes:
    h = hashlib.blake2b(digest_size=64, person=PRF_EXPAND_PERSONALIZATION)
    h.update(sk)
    for t in ts:
        h.update(t)
    return h.digest()


def prf_expand(sk: bytes, t: bytes) -> bytes:
    return prf_expand_vec(sk, [t])


def _scalar_to_bytes(fs: int) -> bytes:
    return fs.to_bytes(32, "little")


def _scalar_from_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= S:
        raise ValueError("scalar not in field")
    return v


@dataclass(frozen=True)
class SpendingKey:
    fs: int

    @classmethod
    def from_seed(cls, seed: bytes) -> "SpendingKey":
        # keys.rs:49-56: Blake2b-64(person="zech_ExpandSeed_")(seed), to_uniform
        h = hashlib.blake2b(digest_size=64, person=PRF_EXPAND_PERSONALIZATION)
        h.update(seed)
        return cls(fs_to_uniform(h.digest()))

    def into_rsk(self, alpha: int) -> int:
        """Re-randomized signing key (PrivateKey::randomize)."""
        return (self.fs + alpha) % S

    def to_bytes(self) -> bytes:
        return _scalar_to_bytes(self.fs)

    @classmethod
    def from_bytes(cls, b: bytes) -> "SpendingKey":
        return cls(_scalar_from_bytes(b))


@dataclass(frozen=True)
class DecryptionKey:
    fs: int

    def to_bytes(self) -> bytes:
        return _scalar_to_bytes(self.fs)

    @classmethod
    def from_bytes(cls, b: bytes) -> "DecryptionKey":
        return cls(_scalar_from_bytes(b))


@dataclass(frozen=True)
class ProofGenerationKey:
    point: tuple  # affine Jubjub point, prime order

    @classmethod
    def from_spending_key(cls, sk: SpendingKey) -> "ProofGenerationKey":
        return cls(jj.mul(jj.generator(BASE_INDEX), sk.fs))

    @classmethod
    def from_seed(cls, seed: bytes) -> "ProofGenerationKey":
        return cls.from_spending_key(SpendingKey.from_seed(seed))

    def into_rvk(self, alpha: int) -> tuple:
        """Randomized sig-verification key point (keys.rs:152-163)."""
        return jj.add(self.point, jj.mul(jj.generator(BASE_INDEX), alpha))

    def into_decryption_key(self) -> DecryptionKey:
        # keys.rs:166-185: Blake2s-32("zech_bdk") of the 32-byte point
        # encoding, mask top 5 bits, read LE.
        preimage = jj.to_bytes(self.point)
        h = hashlib.blake2s(digest_size=32, person=CRH_BDK_PERSONALIZATION)
        h.update(preimage)
        d = bytearray(h.digest())
        d[31] &= 0b0000_0111
        return DecryptionKey(int.from_bytes(bytes(d), "little"))

    def into_encryption_key(self) -> "EncryptionKey":
        return EncryptionKey.from_decryption_key(self.into_decryption_key())

    def add(self, other: "ProofGenerationKey") -> "ProofGenerationKey":
        return ProofGenerationKey(jj.add(self.point, other.point))

    def to_bytes(self) -> bytes:
        return jj.to_bytes(self.point)

    @classmethod
    def from_bytes(cls, b: bytes) -> "ProofGenerationKey":
        return cls(jj.from_bytes_prime_order(b))


@dataclass(frozen=True)
class EncryptionKey:
    point: tuple

    @classmethod
    def from_seed(cls, seed: bytes) -> "EncryptionKey":
        return cls.from_spending_key(SpendingKey.from_seed(seed))

    @classmethod
    def from_spending_key(cls, sk: SpendingKey) -> "EncryptionKey":
        return ProofGenerationKey.from_spending_key(sk).into_encryption_key()

    @classmethod
    def from_decryption_key(cls, dk: DecryptionKey) -> "EncryptionKey":
        return cls(jj.mul(jj.generator(BASE_INDEX), dk.fs))

    def to_bytes(self) -> bytes:
        return jj.to_bytes(self.point)

    @classmethod
    def from_bytes(cls, b: bytes) -> "EncryptionKey":
        return cls(jj.from_bytes_prime_order(b))
