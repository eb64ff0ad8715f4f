"""anonymous-balances module (reference modules/anonymous-balances/src/lib.rs).

Anonymous transfer among a 12-member anonymity set: every member's balance
gets a pending delta; only the (hidden) sender/recipient deltas are
non-zero.  `issue` reuses the confidential circuit (lib.rs:87-134).
"""

from __future__ import annotations

from .encrypted_balances import DispatchError
from .primitives import CiphertextBytes, EncKey


class AnonymousBalances:
    def __init__(self, zk_system):
        self.zk = zk_system
        self.encrypted_balance: dict[bytes, CiphertextBytes] = {}
        self.pending_transfer: dict[bytes, CiphertextBytes] = {}
        self.last_rollover: dict[bytes, int] = {}
        self.enc_key_set: list[EncKey] = []
        self.events: list = []

    # -- dispatchables --------------------------------------------------
    def anonymous_transfer(
        self, origin, zkproof, enc_keys: list[EncKey],
        left_ciphertexts: list, right_ciphertext, nonce,
    ):
        """(lib.rs:23-83)"""
        if len(enc_keys) != len(left_ciphertexts):
            raise DispatchError("length should be equal")
        rvk = origin
        for e in enc_keys:
            self.rollover(e)
        if any(n.data == nonce.data for n in self.zk.nonce_pool):
            raise DispatchError("nonce already in the pool")

        acc = [
            self.encrypted_balance.get(c.data, CiphertextBytes.zero())
            for c in enc_keys
        ]
        ok = self.zk.verify_anonymous_proof(
            zkproof, enc_keys, left_ciphertexts, right_ciphertext, acc,
            rvk, nonce,
        )
        if not ok:
            self.events.append(("InvalidZkProof",))
            raise DispatchError("invalid zkproof")
        self.zk.nonce_pool.append(nonce)

        for e, c in zip(enc_keys, left_ciphertexts):
            self.add_pending_transfer(e, c, right_ciphertext)

        self.events.append(
            ("AnonymousTransfer", zkproof, enc_keys, left_ciphertexts,
             right_ciphertext, rvk)
        )

    def issue(self, origin, zkproof, issuer: EncKey, total, fee, balance,
              randomness, nonce):
        """(lib.rs:87-134): mint via the confidential circuit."""
        rvk = origin
        current_epoch = self.zk.get_current_epoch()
        self.zk.init_nonce_pool(current_epoch)
        if any(n.data == nonce.data for n in self.zk.nonce_pool):
            raise DispatchError("nonce already in the pool")
        ok = self.zk.verify_confidential_proof(
            zkproof, issuer, issuer, total, total, balance, rvk, fee,
            randomness, nonce,
        )
        if not ok:
            self.events.append(("InvalidZkProof",))
            raise DispatchError("invalid zkproof")
        self.zk.nonce_pool.append(nonce)

        total_ct = CiphertextBytes.from_left_right(total, randomness)
        self.encrypted_balance[issuer.data] = total_ct
        self.events.append(("Issued", issuer, total_ct))

    # -- internals ------------------------------------------------------
    def rollover(self, addr: EncKey):
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

    def add_pending_transfer(self, address, amount, randomness):
        enc_amount = CiphertextBytes.from_left_right(amount, randomness)
        cur = self.pending_transfer.get(address.data)
        self.pending_transfer[address.data] = (
            cur.add(enc_amount) if cur is not None else enc_amount
        )
