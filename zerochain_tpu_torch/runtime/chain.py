"""Minimal chain harness: block numbers + signed-extrinsic application.

The reference's node (Substrate: Aura consensus, libp2p, tx pool) is a host
application, not part of the proving framework; this harness reproduces the
runtime-visible semantics: AccountId = rvk (SigVerificationKey), RedDSA
signature checks on extrinsics (runtime/src/lib.rs:54, modules/executive),
and block-driven epochs.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..mirror import jubjub as jj
from ..protocol import redjubjub as rj
from . import scale
from .anonymous_balances import AnonymousBalances
from .encrypted_assets import EncryptedAssets
from .encrypted_balances import DispatchError, EncryptedBalances
from .primitives import SigVerificationKey
from .zk_system import ZkSystem

# local-simulation genesis id (RpcServer chain_getGenesisHash)
DEV_GENESIS_HASH = b"\x00" * 32


@dataclass
class Extrinsic:
    """A signed call: module.method(**args), signed by rsk against rvk.

    Wire format is SCALE/parity-codec: the signing payload is
    SCALE((Compact(nonce), Call, Era, genesis_hash)) hashed with
    BLAKE2b-256 exactly as the reference client does
    (core/proofs/src/confidential.rs:405-419), and `encode()`/`decode()`
    round-trip the substrate-1.0 UncheckedMortalCompactExtrinsic layout
    (runtime/src/lib.rs:241)."""

    module: str
    method: str
    args: dict
    rvk: SigVerificationKey
    signature: rj.Signature | None = None
    nonce_index: int = 0
    genesis_hash: bytes = DEV_GENESIS_HASH

    def call_bytes(self) -> bytes:
        return scale.encode_call(self.module, self.method, self.args)

    def payload(self) -> bytes:
        """The 32-byte message actually signed: blake2_256 of the SCALE
        signing payload (confidential.rs:414 `blake2_256(payload)`)."""
        return scale.signing_message(
            self.nonce_index, self.call_bytes(), self.genesis_hash
        )

    def sign(self, rsk_fs: int, t: bytes | None = None):
        self.signature = rj.PrivateKey(rsk_fs).sign(
            self.payload(), base_index=jj.NOTE_COMMITMENT_RANDOMNESS, t=t
        )
        return self

    def encode(self) -> bytes:
        """Full signed UncheckedExtrinsic bytes."""
        if self.signature is None:
            raise ValueError("extrinsic is unsigned")
        return scale.encode_unchecked_extrinsic(
            self.nonce_index, self.call_bytes(), self.rvk.data,
            self.signature.rbar + self.signature.sbar,
        )

    @classmethod
    def decode(cls, data: bytes, genesis_hash: bytes = DEV_GENESIS_HASH):
        from .primitives import (
            CiphertextBytes,
            EncKey,
            LeftCiphertext,
            Nonce,
            ProofBytes,
            RightCiphertext,
        )

        raw = scale.decode_unchecked_extrinsic(data)
        module, method, args = scale.decode_call(raw["call"])
        _, names, kinds = scale.CALL_SPECS[(module, method)]
        wrap_h256 = {
            "address_sender": EncKey, "address_recipient": EncKey,
            "issuer": EncKey, "owner": EncKey,
            "amount_sender": LeftCiphertext,
            "amount_recipient": LeftCiphertext, "fee_sender": LeftCiphertext,
            "total": LeftCiphertext, "fee": LeftCiphertext,
            "dummy_amount": LeftCiphertext, "dummy_fee": LeftCiphertext,
            "randomness": RightCiphertext, "right_ciphertext": RightCiphertext,
            "nonce": Nonce,
        }
        typed = {}
        for name, kind in zip(names, kinds):
            v = args[name]
            if kind == "h256":
                typed[name] = wrap_h256[name](v)
            elif kind == "vecu8":
                typed[name] = (ProofBytes(v) if name == "zkproof"
                               else CiphertextBytes(v))
            elif kind == "vec_h256":
                wrap = EncKey if name == "enc_keys" else LeftCiphertext
                typed[name] = [wrap(x) for x in v]
            else:
                typed[name] = v
        xt = cls(module=module, method=method, args=typed,
                 rvk=SigVerificationKey(raw["signer"]),
                 nonce_index=raw["nonce"], genesis_hash=genesis_hash)
        xt.signature = rj.Signature(
            rbar=raw["signature"][:32], sbar=raw["signature"][32:]
        )
        return xt


class Runtime:
    """Composes the modules (reference runtime/src/lib.rs construct_runtime!)."""

    def __init__(self, confidential_vk, anonymous_vk=None, epoch_length=7,
                 check_signatures: bool = True):
        self.block_number = 0
        self.zk_system = ZkSystem(confidential_vk, anonymous_vk, epoch_length)
        self.zk_system._system = self
        self.encrypted_balances = EncryptedBalances(self.zk_system)
        self.encrypted_assets = EncryptedAssets(self.zk_system)
        self.anonymous_balances = AnonymousBalances(self.zk_system)
        self.check_signatures = check_signatures
        self.account_nonce: dict[bytes, int] = {}

    def set_block(self, n: int):
        self.block_number = n

    def next_block(self):
        self.block_number += 1

    def apply_extrinsic(self, xt: Extrinsic):
        """Signature check (RedDSA over rvk) then dispatch."""
        if self.check_signatures:
            if xt.signature is None:
                raise DispatchError("unsigned extrinsic")
            vk = rj.PublicKey(jj.from_bytes(xt.rvk.data))
            if not vk.verify(
                xt.payload(), xt.signature,
                base_index=jj.NOTE_COMMITMENT_RANDOMNESS,
            ):
                raise DispatchError("bad signature")
            expected = self.account_nonce.get(xt.rvk.data, 0)
            if xt.nonce_index != expected:
                raise DispatchError("bad account nonce")
            self.account_nonce[xt.rvk.data] = expected + 1

        module = getattr(self, xt.module)
        method = getattr(module, xt.method)
        return method(xt.rvk, **xt.args)
