"""Wire/storage types (reference core/primitives/src/).

All are thin 32/64/192-byte wrappers over the Jubjub/proof codecs with the
`IntoXY` conversion used to build circuit public inputs
(core/primitives/src/lib.rs:48-50).  Stored ciphertexts support the
homomorphic add/sub used by the balance modules
(core/primitives/src/ciphertext.rs).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..mirror import jubjub as jj

GEPOCH_PERSONALIZATION = b"zcgepoch"


class PrimitiveError(ValueError):
    pass


@dataclass(frozen=True)
class _Point32:
    """32-byte Jubjub point encoding.

    SCALE wire format: fixed-hash H256 — raw 32 bytes, no length prefix
    (core/primitives/src/enc_key.rs:43-52)."""

    data: bytes

    def __post_init__(self):
        assert len(self.data) == 32

    def encode(self) -> bytes:
        return self.data

    @classmethod
    def decode(cls, data: bytes, offset: int = 0):
        return cls(bytes(data[offset:offset + 32])), offset + 32

    @classmethod
    def from_point(cls, p):
        return cls(jj.to_bytes(p))

    def to_point(self):
        p = jj.from_bytes(self.data)
        if not (jj.is_prime_order(p) or p == jj.ZERO):
            raise PrimitiveError("not in the prime-order subgroup")
        return p

    def into_xy(self) -> tuple[int, int]:
        return self.to_point()

    @classmethod
    def zero(cls):
        return cls.from_point(jj.ZERO)


class EncKey(_Point32):
    """On-chain address (= EncryptionKey point)."""


class LeftCiphertext(_Point32):
    pass


class RightCiphertext(_Point32):
    pass


class Nonce(_Point32):
    pass


class GEpochBytes(_Point32):
    @classmethod
    def group_hash(cls, epoch: int) -> "GEpochBytes":
        p = jj.find_group_hash(
            epoch.to_bytes(4, "little"), GEPOCH_PERSONALIZATION
        )
        return cls.from_point(p)


class SigVerificationKey(_Point32):
    """AccountId: the re-randomized RedDSA verification key (rvk)."""


@dataclass(frozen=True)
class CiphertextBytes:
    """64-byte stored ciphertext: left || right (ciphertext.rs).

    SCALE wire format: Vec<u8> — compact length + bytes
    (core/primitives/src/ciphertext.rs:14-16)."""

    data: bytes

    def __post_init__(self):
        assert len(self.data) == 64

    def encode(self) -> bytes:
        from . import scale

        return scale.encode_bytes(self.data)

    @classmethod
    def decode(cls, data: bytes, offset: int = 0):
        from . import scale

        raw, offset = scale.decode_bytes(data, offset)
        return cls(raw), offset

    @classmethod
    def zero(cls):
        z = jj.to_bytes(jj.ZERO)
        return cls(z + z)

    @classmethod
    def from_left_right(cls, left: LeftCiphertext, right: RightCiphertext):
        return cls(left.data + right.data)

    def left(self) -> LeftCiphertext:
        return LeftCiphertext(self.data[:32])

    def right(self) -> RightCiphertext:
        return RightCiphertext(self.data[32:])

    def _points(self):
        return self.left().to_point(), self.right().to_point()

    def add(self, other: "CiphertextBytes") -> "CiphertextBytes":
        l1, r1 = self._points()
        l2, r2 = other._points()
        return CiphertextBytes(
            jj.to_bytes(jj.add(l1, l2)) + jj.to_bytes(jj.add(r1, r2))
        )

    def sub(self, other: "CiphertextBytes") -> "CiphertextBytes":
        l1, r1 = self._points()
        l2, r2 = other._points()
        return CiphertextBytes(
            jj.to_bytes(jj.add(l1, jj.neg(l2)))
            + jj.to_bytes(jj.add(r1, jj.neg(r2)))
        )


@dataclass(frozen=True)
class ProofBytes:
    """192-byte compressed Groth16 proof.

    SCALE wire format: Vec<u8> — compact length + bytes
    (core/primitives/src/proof.rs:12-14)."""

    data: bytes

    def __post_init__(self):
        assert len(self.data) == 192

    def encode(self) -> bytes:
        from . import scale

        return scale.encode_bytes(self.data)

    @classmethod
    def decode(cls, data: bytes, offset: int = 0):
        from . import scale

        raw, offset = scale.decode_bytes(data, offset)
        return cls(raw), offset
