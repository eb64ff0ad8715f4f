"""ZIP32-style hierarchical deterministic key derivation.

Reference zface/src/derive/mod.rs:19-228, constants.rs, components.rs.
Personalizations: master = "Zerochain_Master", fingerprint =
"ZerochainEFinger"; child derivation uses the 0x11/0x12/0x13 PRF-expand
domains exactly as upstream.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..mirror.field import S, fs_to_uniform
from ..protocol.keys import (
    ProofGenerationKey,
    SpendingKey,
    prf_expand,
    prf_expand_vec,
)

MASTER_PERSONALIZATION = b"Zerochain_Master"
EKFP_PERSONALIZATION = b"ZerochainEFinger"

HARDENED = 1 << 31


@dataclass(frozen=True)
class ChildIndex:
    index: int
    hardened: bool

    @classmethod
    def non_hardened(cls, i: int):
        return cls(i, False)

    @classmethod
    def hardened_(cls, i: int):
        return cls(i, True)

    @classmethod
    def from_index(cls, i: int):
        return cls(i - HARDENED, True) if i >= HARDENED else cls(i, False)

    def to_index(self) -> int:
        return self.index + HARDENED if self.hardened else self.index


def _fingerprint_tag(pgk: ProofGenerationKey) -> bytes:
    h = hashlib.blake2b(digest_size=32, person=EKFP_PERSONALIZATION)
    h.update(pgk.to_bytes())
    return h.digest()[:4]


@dataclass(frozen=True)
class ExtendedSpendingKey:
    depth: int
    parent_tag: bytes  # 4 bytes
    child_index: ChildIndex
    chain_code: bytes  # 32 bytes
    spending_key: SpendingKey

    @classmethod
    def master(cls, seed: bytes) -> "ExtendedSpendingKey":
        h = hashlib.blake2b(digest_size=64, person=MASTER_PERSONALIZATION)
        h.update(seed)
        d = h.digest()
        return cls(
            depth=0,
            parent_tag=b"\x00" * 4,
            child_index=ChildIndex.from_index(0),
            chain_code=d[32:],
            spending_key=SpendingKey.from_seed(d[:32]),
        )

    def derive_child(self, i: ChildIndex) -> "ExtendedSpendingKey":
        pgk = ProofGenerationKey.from_spending_key(self.spending_key)
        i_le = i.index.to_bytes(4, "little") if not i.hardened else (
            (i.index + HARDENED).to_bytes(4, "little")
        )
        if i.hardened:
            hashed = prf_expand_vec(
                self.chain_code,
                [b"\x11", self.spending_key.to_bytes(), i_le],
            )
        else:
            hashed = prf_expand_vec(
                self.chain_code, [b"\x12", pgk.to_bytes(), i_le]
            )
        left, right = hashed[:32], hashed[32:]
        fs = fs_to_uniform(prf_expand(left, b"\x13"))
        return ExtendedSpendingKey(
            depth=self.depth + 1,
            parent_tag=_fingerprint_tag(pgk),
            child_index=i,
            chain_code=right,
            spending_key=SpendingKey((fs + self.spending_key.fs) % S),
        )

    def to_bytes(self) -> bytes:
        return (
            bytes([self.depth])
            + self.parent_tag
            + self.child_index.to_index().to_bytes(4, "little")
            + self.chain_code
            + self.spending_key.to_bytes()
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "ExtendedSpendingKey":
        assert len(b) == 1 + 4 + 4 + 32 + 32
        return cls(
            depth=b[0],
            parent_tag=b[1:5],
            child_index=ChildIndex.from_index(
                int.from_bytes(b[5:9], "little")
            ),
            chain_code=b[9:41],
            spending_key=SpendingKey.from_bytes(b[41:]),
        )


@dataclass(frozen=True)
class ExtendedProofGenerationKey:
    depth: int
    parent_tag: bytes
    child_index: ChildIndex
    chain_code: bytes
    proof_gen_key: ProofGenerationKey

    @classmethod
    def from_xsk(cls, xsk: ExtendedSpendingKey):
        return cls(
            depth=xsk.depth,
            parent_tag=xsk.parent_tag,
            child_index=xsk.child_index,
            chain_code=xsk.chain_code,
            proof_gen_key=ProofGenerationKey.from_spending_key(
                xsk.spending_key
            ),
        )

    @classmethod
    def master(cls, seed: bytes):
        return cls.from_xsk(ExtendedSpendingKey.master(seed))

    def derive_child(self, i: ChildIndex) -> "ExtendedProofGenerationKey":
        if i.hardened:
            raise ValueError(
                "hardened key cannot be derived from ExtendedProofGenerationKey"
            )
        i_le = i.index.to_bytes(4, "little")
        hashed = prf_expand_vec(
            self.chain_code, [b"\x12", self.proof_gen_key.to_bytes(), i_le]
        )
        left, right = hashed[:32], hashed[32:]
        fs = fs_to_uniform(prf_expand(left, b"\x13"))
        pgk = ProofGenerationKey.from_spending_key(SpendingKey(fs)).add(
            self.proof_gen_key
        )
        return ExtendedProofGenerationKey(
            depth=self.depth + 1,
            parent_tag=_fingerprint_tag(self.proof_gen_key),
            child_index=i,
            chain_code=right,
            proof_gen_key=pgk,
        )

    def to_bytes(self) -> bytes:
        return (
            bytes([self.depth])
            + self.parent_tag
            + self.child_index.to_index().to_bytes(4, "little")
            + self.chain_code
            + self.proof_gen_key.to_bytes()
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "ExtendedProofGenerationKey":
        assert len(b) == 1 + 4 + 4 + 32 + 32
        return cls(
            depth=b[0],
            parent_tag=b[1:5],
            child_index=ChildIndex.from_index(
                int.from_bytes(b[5:9], "little")
            ),
            chain_code=b[9:41],
            proof_gen_key=ProofGenerationKey.from_bytes(b[41:]),
        )
