"""encrypted-assets module (reference modules/encrypted-assets/src/lib.rs).

Multi-asset variant keyed by (asset_id, address): `issue` mints a new
confidential asset class (reusing the confidential circuit with
issuer == sender, lib.rs:32-83), `confidential_transfer` moves assets
(lib.rs:86-164), `destroy` burns a class (lib.rs:167-215).
"""

from __future__ import annotations

from .encrypted_balances import DispatchError
from .primitives import CiphertextBytes, EncKey


class EncryptedAssets:
    def __init__(self, zk_system):
        self.zk = zk_system
        self.encrypted_balance: dict[tuple, CiphertextBytes] = {}
        self.pending_transfer: dict[tuple, CiphertextBytes] = {}
        self.last_rollover: dict[tuple, int] = {}
        self.total_supply: dict[int, CiphertextBytes] = {}
        self.next_asset_id = 0
        self.events: list = []

    # -- dispatchables --------------------------------------------------
    def issue(self, origin, zkproof, issuer: EncKey, total, fee, balance,
              randomness, nonce) -> int:
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

        asset_id = self.next_asset_id
        self.next_asset_id += 1
        total_ct = CiphertextBytes.from_left_right(total, randomness)
        self.encrypted_balance[(asset_id, issuer.data)] = total_ct
        self.total_supply[asset_id] = total_ct
        self.events.append(("Issued", asset_id, issuer, total_ct))
        return asset_id

    def confidential_transfer(
        self, origin, asset_id, zkproof, address_sender, address_recipient,
        amount_sender, amount_recipient, fee_sender, randomness, nonce,
    ):
        rvk = origin
        self.rollover(address_sender, asset_id)
        self.rollover(address_recipient, asset_id)
        if any(n.data == nonce.data for n in self.zk.nonce_pool):
            raise DispatchError("nonce already in the pool")
        ok = self.zk.verify_confidential_proof(
            zkproof,
            address_sender,
            address_recipient,
            amount_sender,
            amount_recipient,
            self.encrypted_balance.get(
                (asset_id, address_sender.data), CiphertextBytes.zero()
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
            address_sender, asset_id, amount_sender, fee_sender, randomness
        )
        self.add_pending_transfer(
            address_recipient, asset_id, amount_recipient, randomness
        )
        self.events.append(
            (
                "ConfidentialAssetTransferred",
                asset_id, zkproof, address_sender, address_recipient,
                amount_sender, amount_recipient, fee_sender, randomness,
                self.encrypted_balance.get(
                    (asset_id, address_sender.data), CiphertextBytes.zero()
                ),
                rvk,
            )
        )

    def destroy(self, origin, zkproof, owner: EncKey, asset_id, dummy_amount,
                dummy_fee, dummy_balance, randomness, nonce):
        rvk = origin
        current_epoch = self.zk.get_current_epoch()
        self.zk.init_nonce_pool(current_epoch)
        if any(n.data == nonce.data for n in self.zk.nonce_pool):
            raise DispatchError("nonce already in the pool")
        ok = self.zk.verify_confidential_proof(
            zkproof, owner, owner, dummy_amount, dummy_amount, dummy_balance,
            rvk, dummy_fee, randomness, nonce,
        )
        if not ok:
            self.events.append(("InvalidZkProof",))
            raise DispatchError("invalid zkproof")
        self.zk.nonce_pool.append(nonce)

        balance = self.encrypted_balance.pop(
            (asset_id, owner.data), CiphertextBytes.zero()
        )
        pending = self.pending_transfer.pop(
            (asset_id, owner.data), CiphertextBytes.zero()
        )
        self.events.append(("Destroyed", asset_id, owner, balance, pending))

    # -- internals (per-(asset,key) rollover, lib.rs:266) ---------------
    def rollover(self, addr: EncKey, asset_id: int):
        current_epoch = self.zk.get_current_epoch()
        key = (asset_id, addr.data)
        last = self.last_rollover.get(key, 0)
        pending = self.pending_transfer.get(key, CiphertextBytes.zero())
        if last < current_epoch:
            bal = self.encrypted_balance.get(key)
            self.encrypted_balance[key] = (
                bal.add(pending) if bal is not None else pending
            )
            self.pending_transfer.pop(key, None)
            self.last_rollover[key] = current_epoch
        self.zk.init_nonce_pool(current_epoch)

    def sub_enc_balance(self, address, asset_id, amount, fee, randomness):
        enc_amount = CiphertextBytes.from_left_right(amount, randomness)
        enc_fee = CiphertextBytes.from_left_right(fee, randomness)
        total = enc_amount.add(enc_fee)
        key = (asset_id, address.data)
        bal = self.encrypted_balance.get(key)
        self.encrypted_balance[key] = bal.sub(total) if bal is not None else None

    def add_pending_transfer(self, address, asset_id, amount, randomness):
        enc_amount = CiphertextBytes.from_left_right(amount, randomness)
        key = (asset_id, address.data)
        cur = self.pending_transfer.get(key)
        self.pending_transfer[key] = (
            cur.add(enc_amount) if cur is not None else enc_amount
        )
