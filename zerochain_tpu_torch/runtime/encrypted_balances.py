"""encrypted-balances module (reference modules/encrypted-balances/src/lib.rs).

Zether-style confidential transfer of the native token: epoch rollover
(pending -> balance), nonce-pool replay protection, zk verification, then
homomorphic balance mutation.  Storage-mutation ordering matches the
reference's front-running-safe design (lib.rs:38-46).
"""

from __future__ import annotations

from .primitives import (
    CiphertextBytes,
    EncKey,
    LeftCiphertext,
    Nonce,
    ProofBytes,
    RightCiphertext,
)


class DispatchError(Exception):
    pass


class EncryptedBalances:
    def __init__(self, zk_system, transaction_base_fee: int = 1):
        self.zk = zk_system
        self.encrypted_balance: dict[bytes, CiphertextBytes] = {}
        self.pending_transfer: dict[bytes, CiphertextBytes] = {}
        self.last_rollover: dict[bytes, int] = {}
        self.transaction_base_fee = transaction_base_fee
        self.events: list = []

    # -- dispatchable ---------------------------------------------------
    def confidential_transfer(
        self,
        origin,  # rvk (SigVerificationKey) of the signed extrinsic
        zkproof: ProofBytes,
        address_sender: EncKey,
        address_recipient: EncKey,
        amount_sender: LeftCiphertext,
        amount_recipient: LeftCiphertext,
        fee_sender: LeftCiphertext,
        randomness: RightCiphertext,
        nonce: Nonce,
    ):
        """(lib.rs:25-96)"""
        rvk = origin
        self.rollover(address_sender)
        self.rollover(address_recipient)

        if any(n.data == nonce.data for n in self.zk.nonce_pool):
            raise DispatchError("nonce already in the pool")

        ok = self.zk.verify_confidential_proof(
            zkproof,
            address_sender,
            address_recipient,
            amount_sender,
            amount_recipient,
            self.encrypted_balance.get(
                address_sender.data, CiphertextBytes.zero()
            ),
            rvk,
            fee_sender,
            randomness,
            nonce,
        )
        if not ok:
            self.events.append(("InvalidZkProof",))
            raise DispatchError("invalid zkproof")

        self.zk.nonce_pool.append(nonce)

        self.sub_enc_balance(
            address_sender, amount_sender, fee_sender, randomness
        )
        self.add_pending_transfer(address_recipient, amount_recipient, randomness)

        self.events.append(
            (
                "ConfidentialTransfer",
                zkproof,
                address_sender,
                address_recipient,
                amount_sender,
                amount_recipient,
                fee_sender,
                randomness,
                self.encrypted_balance.get(
                    address_sender.data, CiphertextBytes.zero()
                ),
                rvk,
            )
        )

    # -- internals ------------------------------------------------------
    def rollover(self, addr: EncKey):
        """(lib.rs:133-170)"""
        current_epoch = self.zk.get_current_epoch()
        last = self.last_rollover.get(addr.data, 0)
        pending = self.pending_transfer.get(addr.data, CiphertextBytes.zero())
        if last < current_epoch:
            bal = self.encrypted_balance.get(addr.data)
            self.encrypted_balance[addr.data] = (
                bal.add(pending) if bal is not None else pending
            )
            self.pending_transfer.pop(addr.data, None)
            self.last_rollover[addr.data] = current_epoch
        self.zk.init_nonce_pool(current_epoch)

    def sub_enc_balance(
        self, address, amount, fee, randomness
    ):
        """(lib.rs:173-196)"""
        enc_amount = CiphertextBytes.from_left_right(amount, randomness)
        enc_fee = CiphertextBytes.from_left_right(fee, randomness)
        total = enc_amount.add(enc_fee)
        bal = self.encrypted_balance.get(address.data)
        self.encrypted_balance[address.data] = (
            bal.sub(total) if bal is not None else None
        )

    def add_pending_transfer(self, address, amount, randomness):
        """(lib.rs:199-222)"""
        enc_amount = CiphertextBytes.from_left_right(amount, randomness)
        cur = self.pending_transfer.get(address.data)
        self.pending_transfer[address.data] = (
            cur.add(enc_amount) if cur is not None else enc_amount
        )
