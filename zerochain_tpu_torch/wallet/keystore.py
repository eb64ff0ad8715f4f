"""Encrypted keystore (reference zface/src/wallet/{keyfile.rs,disk.rs}).

A wallet directory holds a master keyfile plus per-account keyfiles and an
index file tracking the default account, exactly like zface's disk layout;
keyfiles encrypt the ExtendedSpendingKey with PBKDF2 + AES-128-CTR and a
keccak256 MAC (keyfile.rs:108-157).

Recovery uses a 12-word BIP39 English mnemonic exactly like the
reference (zface/src/wallet/commands.rs:29-37, 130-139); the wordlist is
vendored in bip39_words.py.  Hex-seed phrases from pre-BIP39 wallets
remain accepted by `recover`.
"""

from __future__ import annotations

import json
import os
import pathlib
from dataclasses import dataclass

from ..protocol.keys import EncryptionKey
from .crypto import aes_128_ctr, derive_key_iterations, derive_mac
from .derive import ChildIndex, ExtendedSpendingKey
from .ss58 import encode_ss58

DEFAULT_ITERATIONS = 10240
VERSION = 1


class KeystoreError(Exception):
    pass


@dataclass
class KeyFile:
    account_name: str
    ss58_address: str
    version: int
    encrypted_key: dict  # {ciphertext, mac, salt, iv, iterations} hex/int

    @classmethod
    def create(cls, account_name: str, password: bytes,
               xsk: ExtendedSpendingKey, iterations: int = DEFAULT_ITERATIONS,
               rng=os.urandom) -> "KeyFile":
        salt = rng(32)
        iv = rng(16)
        left, right = derive_key_iterations(password, salt, iterations)
        plain = xsk.to_bytes()
        ciphertext = aes_128_ctr(left, iv, plain)
        mac = derive_mac(right, ciphertext)
        ek = EncryptionKey.from_spending_key(xsk.spending_key)
        return cls(
            account_name=account_name,
            ss58_address=encode_ss58(ek.to_bytes()),
            version=VERSION,
            encrypted_key=dict(
                ciphertext=ciphertext.hex(),
                mac=mac.hex(),
                salt=salt.hex(),
                iv=iv.hex(),
                iterations=iterations,
            ),
        )

    def decrypt(self, password: bytes) -> ExtendedSpendingKey:
        ek = self.encrypted_key
        left, right = derive_key_iterations(
            password, bytes.fromhex(ek["salt"]), ek["iterations"]
        )
        ciphertext = bytes.fromhex(ek["ciphertext"])
        if derive_mac(right, ciphertext).hex() != ek["mac"]:
            raise KeystoreError("invalid password (MAC mismatch)")
        plain = aes_128_ctr(left, bytes.fromhex(ek["iv"]), ciphertext)
        return ExtendedSpendingKey.from_bytes(plain)

    def to_json(self) -> str:
        return json.dumps(
            dict(
                account_name=self.account_name,
                ss58_address=self.ss58_address,
                version=self.version,
                encrypted_key=self.encrypted_key,
            ),
            indent=2,
        )

    @classmethod
    def from_json(cls, s: str) -> "KeyFile":
        d = json.loads(s)
        return cls(
            account_name=d["account_name"],
            ss58_address=d["ss58_address"],
            version=d["version"],
            encrypted_key=d["encrypted_key"],
        )


class Wallet:
    """Directory wallet: master + derived accounts + index (disk.rs)."""

    def __init__(self, root: str | os.PathLike):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # -- paths ----------------------------------------------------------
    def _keyfile_path(self, name: str) -> pathlib.Path:
        return self.root / f"{name}.json"

    @property
    def _index_path(self) -> pathlib.Path:
        return self.root / "wallet_index.json"

    # -- operations -----------------------------------------------------
    def init(self, password: bytes, seed: bytes | None = None,
             iterations: int = DEFAULT_ITERATIONS,
             mnemonic: str | None = None) -> str:
        """Create the master + first account; returns the 12-word BIP39
        recovery phrase (reference zface/src/wallet/commands.rs:29-37:
        `Mnemonic::new(Words12, English)` + `Seed::new(&mnemonic, "")`)."""
        from . import bip39

        if self._index_path.exists():
            raise KeystoreError("wallet already initialized")
        if mnemonic is None:
            mnemonic = (bip39.generate(12) if seed is None
                        else bip39.entropy_to_mnemonic(seed[:16]))
        master_seed = bip39.to_seed(mnemonic)
        master = ExtendedSpendingKey.master(master_seed)
        kf = KeyFile.create("__master__", password, master, iterations)
        self._keyfile_path("__master__").write_text(kf.to_json())
        self._index_path.write_text(
            json.dumps(dict(default_account=None, accounts=[], next_index=0))
        )
        self.add_account("default", password, iterations)
        return mnemonic

    def recover(self, password: bytes, recovery_phrase: str,
                iterations: int = DEFAULT_ITERATIONS) -> None:
        """Rebuild the wallet from its 12-word mnemonic
        (commands.rs:130-139).  Legacy hex-seed phrases from earlier
        wallets are still accepted."""
        from . import bip39

        if bip39.validate(recovery_phrase):
            self.init(password, iterations=iterations,
                      mnemonic=recovery_phrase)
            return
        try:
            seed = bytes.fromhex(recovery_phrase)
        except ValueError:
            raise KeystoreError("invalid recovery phrase") from None
        # legacy path: derive straight from the raw seed bytes
        if self._index_path.exists():
            raise KeystoreError("wallet already initialized")
        master = ExtendedSpendingKey.master(seed)
        kf = KeyFile.create("__master__", password, master, iterations)
        self._keyfile_path("__master__").write_text(kf.to_json())
        self._index_path.write_text(
            json.dumps(dict(default_account=None, accounts=[], next_index=0))
        )
        self.add_account("default", password, iterations)

    def _master(self, password: bytes) -> ExtendedSpendingKey:
        kf = KeyFile.from_json(self._keyfile_path("__master__").read_text())
        return kf.decrypt(password)

    def add_account(self, name: str, password: bytes,
                    iterations: int = DEFAULT_ITERATIONS) -> str:
        idx = json.loads(self._index_path.read_text())
        if name in idx["accounts"]:
            raise KeystoreError(f"account {name!r} exists")
        master = self._master(password)
        child = master.derive_child(ChildIndex.hardened_(idx["next_index"]))
        kf = KeyFile.create(name, password, child, iterations)
        self._keyfile_path(name).write_text(kf.to_json())
        idx["accounts"].append(name)
        idx["next_index"] += 1
        if idx["default_account"] is None:
            idx["default_account"] = name
        self._index_path.write_text(json.dumps(idx))
        return kf.ss58_address

    def change_account(self, name: str) -> None:
        idx = json.loads(self._index_path.read_text())
        if name not in idx["accounts"]:
            raise KeystoreError(f"no account {name!r}")
        idx["default_account"] = name
        self._index_path.write_text(json.dumps(idx))

    def list_accounts(self) -> list[dict]:
        idx = json.loads(self._index_path.read_text())
        out = []
        for name in idx["accounts"]:
            kf = KeyFile.from_json(self._keyfile_path(name).read_text())
            out.append(
                dict(
                    name=name,
                    address=kf.ss58_address,
                    default=(name == idx["default_account"]),
                )
            )
        return out

    def default_account(self) -> str:
        idx = json.loads(self._index_path.read_text())
        if idx["default_account"] is None:
            raise KeystoreError("no accounts")
        return idx["default_account"]

    def spending_key(self, password: bytes, name: str | None = None):
        if name is None:
            name = self.default_account()
        kf = KeyFile.from_json(self._keyfile_path(name).read_text())
        return kf.decrypt(password).spending_key
