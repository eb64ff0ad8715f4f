"""zk-system module (reference modules/zk-system/src/lib.rs).

Stores both prepared verifying keys, epoch bookkeeping, the epoch
generator, and the nonce pool; builds the 22/104-element public-input
vectors and calls the Groth16 verifier.
"""

from __future__ import annotations

from ..groth16.core import PreparedVerifyingKey, verify_proof
from ..groth16.serialization import proof_from_bytes
from .primitives import (
    CiphertextBytes,
    GEpochBytes,
    Nonce,
    ProofBytes,
    PrimitiveError,
)

CONFIDENTIAL_INPUT_SIZE = 22
ANONYMOUS_INPUT_SIZE = 104


class ZkSystem:
    def __init__(
        self,
        confidential_vk: PreparedVerifyingKey,
        anonymous_vk: PreparedVerifyingKey | None = None,
        epoch_length: int = 7,
    ):
        self.confidential_vk = confidential_vk
        self.anonymous_vk = anonymous_vk
        self.epoch_length = epoch_length
        self.last_epoch = 0
        self.g_epoch = GEpochBytes.group_hash(0)
        self.nonce_pool: list[Nonce] = []
        self._system = None  # set by Runtime

    # ------------------------------------------------------------------
    def get_current_epoch(self) -> int:
        return self._system.block_number // self.epoch_length

    def init_nonce_pool(self, current_epoch: int):
        """(lib.rs:177-185)"""
        if self.last_epoch < current_epoch or current_epoch == 0:
            self.g_epoch = GEpochBytes.group_hash(current_epoch)
            self.nonce_pool = []
            self.last_epoch = current_epoch

    # ------------------------------------------------------------------
    def verify_confidential_proof(
        self,
        zkproof: ProofBytes,
        address_sender,
        address_recipient,
        amount_sender,
        amount_recipient,
        balance_sender: CiphertextBytes,
        rvk,
        fee_sender,
        randomness,
        nonce: Nonce,
    ) -> bool:
        """(lib.rs:56-115): public input order is [sender, recipient,
        amount_s, amount_r, randomness, fee, balance.left, balance.right,
        rvk, g_epoch, nonce] as (x, y) pairs."""
        inputs = []
        for item in (
            address_sender,
            address_recipient,
            amount_sender,
            amount_recipient,
            randomness,
            fee_sender,
            balance_sender.left(),
            balance_sender.right(),
            rvk,
            self.g_epoch,
            nonce,
        ):
            x, y = item.into_xy()
            inputs.extend([x, y])
        assert len(inputs) == CONFIDENTIAL_INPUT_SIZE

        try:
            proof = proof_from_bytes(zkproof.data)
        except Exception:
            raise PrimitiveError("failed to read zkproof")
        return verify_proof(self.confidential_vk, proof, inputs)

    def verify_anonymous_proof(
        self,
        zkproof: ProofBytes,
        enc_keys: list,
        left_ciphertexts: list,
        right_ciphertext,
        enc_balances: list[CiphertextBytes],
        rvk,
        nonce: Nonce,
    ) -> bool:
        """(lib.rs:118-165): [enc_keys x12, left_cts x12, balance lefts x12,
        balance rights x12, right_ct, rvk, g_epoch, nonce]."""
        inputs = []

        def push(item):
            x, y = item.into_xy()
            inputs.extend([x, y])

        for k in enc_keys:
            push(k)
        for c in left_ciphertexts:
            push(c)
        for b in enc_balances:
            push(b.left())
        for b in enc_balances:
            push(b.right())
        push(right_ciphertext)
        push(rvk)
        push(self.g_epoch)
        push(nonce)
        assert len(inputs) == ANONYMOUS_INPUT_SIZE

        try:
            proof = proof_from_bytes(zkproof.data)
        except Exception:
            raise PrimitiveError("failed to read zkproof")
        return verify_proof(self.anonymous_vk, proof, inputs)
