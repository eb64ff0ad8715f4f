"""The port's wallet stack on the cases of tests/test_wallet.py (HD
derivation laws, keystore round trips, SS58, BIP39), and against the JAX
package: its own AES-128-CTR against the JAX one (which goes through
``cryptography``) and SP 800-38A's vector, keystores written by either
package opened by the other, and ``wallet/crypto.py`` importing with
``cryptography`` blocked."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from zerochain_tpu_torch.wallet.crypto import aes_128_ctr, keccak256
from zerochain_tpu_torch.wallet.derive import (
    ChildIndex,
    ExtendedProofGenerationKey,
    ExtendedSpendingKey,
)
from zerochain_tpu_torch.wallet.keystore import KeystoreError, KeyFile, Wallet
from zerochain_tpu_torch.wallet.ss58 import decode_ss58, encode_ss58


def test_keccak_vectors():
    assert keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    )
    assert keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    )
    # cross rate boundary
    assert keccak256(b"x" * 200) == keccak256(b"x" * 200)


def test_hd_derivation_commutes():
    """xpgk(child(xsk)) == child(xpgk) for non-hardened (derive/mod.rs test)."""
    seed = b"a seed for hd derivation tests!!"
    xsk = ExtendedSpendingKey.master(seed)
    xpgk = ExtendedProofGenerationKey.master(seed)

    i3 = ChildIndex.non_hardened(3)
    assert (
        ExtendedProofGenerationKey.from_xsk(xsk.derive_child(i3))
        == xpgk.derive_child(i3)
    )

    # hardened from xpgk must fail; via xsk then non-hardened commutes
    h3 = ChildIndex.hardened_(3)
    with pytest.raises(ValueError):
        xpgk.derive_child(h3)
    xsk_h3 = xsk.derive_child(h3)
    xpgk_h3 = ExtendedProofGenerationKey.from_xsk(xsk_h3)
    n5 = ChildIndex.non_hardened(5)
    assert (
        ExtendedProofGenerationKey.from_xsk(xsk_h3.derive_child(n5))
        == xpgk_h3.derive_child(n5)
    )


def test_hd_serialization_roundtrip():
    xsk = ExtendedSpendingKey.master(b"roundtrip seed")
    child = xsk.derive_child(ChildIndex.hardened_(1))
    assert ExtendedSpendingKey.from_bytes(child.to_bytes()) == child
    xpgk = ExtendedProofGenerationKey.from_xsk(child)
    assert ExtendedProofGenerationKey.from_bytes(xpgk.to_bytes()) == xpgk


def test_keyfile_encrypt_decrypt():
    xsk = ExtendedSpendingKey.master(b"keyfile test seed")
    kf = KeyFile.create("acct", b"hunter2", xsk, iterations=64)
    assert kf.decrypt(b"hunter2") == xsk
    with pytest.raises(KeystoreError):
        kf.decrypt(b"wrong")
    kf2 = KeyFile.from_json(kf.to_json())
    assert kf2.decrypt(b"hunter2") == xsk


def test_wallet_lifecycle(tmp_path):
    w = Wallet(tmp_path / "w1")
    phrase = w.init(b"pw", seed=b"deterministic wallet seed 123456",
                    iterations=64)
    # recovery phrase is a valid 12-word BIP39 mnemonic derived from the
    # first 16 bytes of the supplied seed entropy
    from zerochain_tpu_torch.wallet import bip39

    assert len(phrase.split()) == 12
    assert bip39.validate(phrase)
    assert bip39.mnemonic_to_entropy(phrase) == \
        b"deterministic wallet seed 123456"[:16]
    addr1 = w.add_account("alice", b"pw", iterations=64)
    addr2 = w.add_account("bob", b"pw", iterations=64)
    assert addr1 != addr2
    accounts = w.list_accounts()
    assert [a["name"] for a in accounts] == ["default", "alice", "bob"]
    assert accounts[0]["default"]
    w.change_account("bob")
    assert w.default_account() == "bob"
    sk = w.spending_key(b"pw", "alice")

    # recovery reproduces the same keys
    w2 = Wallet(tmp_path / "w2")
    w2.recover(b"other-pw", phrase, iterations=64)
    w2.add_account("alice", b"other-pw", iterations=64)
    assert w2.spending_key(b"other-pw", "alice") == sk

    with pytest.raises(KeystoreError):
        w.init(b"pw")  # already initialized


def test_ss58_roundtrip():
    key = bytes(range(32))
    addr = encode_ss58(key)
    assert decode_ss58(addr) == key
    with pytest.raises(ValueError):
        decode_ss58(addr[:-1] + ("1" if addr[-1] != "1" else "2"))


# ---------------------------------------------------------------------------
# BIP39 (vendored English wordlist; reference wallet uses the bip39 crate,
# zface/src/wallet/commands.rs:29-37)
# ---------------------------------------------------------------------------

# published trezor BIP39 test vectors (entropy -> English mnemonic)
BIP39_VECTORS = [
    ("00000000000000000000000000000000",
     "abandon abandon abandon abandon abandon abandon abandon abandon "
     "abandon abandon abandon about"),
    ("7f7f7f7f7f7f7f7f7f7f7f7f7f7f7f7f",
     "legal winner thank year wave sausage worth useful legal winner "
     "thank yellow"),
    ("80808080808080808080808080808080",
     "letter advice cage absurd amount doctor acoustic avoid letter "
     "advice cage above"),
    ("ffffffffffffffffffffffffffffffff",
     "zoo zoo zoo zoo zoo zoo zoo zoo zoo zoo zoo wrong"),
    ("9e885d952ad362caeb4efe34a8e91bd2",
     "ozone drill grab fiber curtain grace pudding thank cruise elder "
     "eight picnic"),
    ("23db8160a31d3e0dca3688ed941adbf3",
     "cat swing flag economy stadium alone churn speed unique patch "
     "report train"),
    ("f30f8c1da665478f49b001d94c5fc452",
     "vessel ladder alter error federal sibling chat ability sun glass "
     "valve picture"),
]


def test_bip39_wordlist_structure():
    from zerochain_tpu_torch.wallet.bip39_words import WORDLIST

    assert len(WORDLIST) == 2048
    assert list(WORDLIST) == sorted(WORDLIST)
    assert len({w[:4] for w in WORDLIST}) == 2048  # unique 4-char prefixes


def test_bip39_trezor_vectors():
    from zerochain_tpu_torch.wallet import bip39

    for ent_hex, phrase in BIP39_VECTORS:
        assert bip39.entropy_to_mnemonic(bytes.fromhex(ent_hex)) == phrase
        assert bip39.mnemonic_to_entropy(phrase).hex() == ent_hex
    # published seed for the all-zero vector with passphrase "TREZOR"
    seed = bip39.to_seed(BIP39_VECTORS[0][1], "TREZOR")
    assert seed.hex().startswith("c55257c360c07c72029aebc1b53c05ed")


def test_bip39_checksum_rejection():
    import pytest

    from zerochain_tpu_torch.wallet import bip39

    good = BIP39_VECTORS[4][1].split()
    bad = " ".join(good[:-1] + ["abandon"])  # breaks the checksum
    assert not bip39.validate(bad)
    with pytest.raises(bip39.MnemonicError):
        bip39.mnemonic_to_entropy(bad)
    with pytest.raises(bip39.MnemonicError):
        bip39.mnemonic_to_entropy("definitely notaword " * 6)


def test_wallet_recover_from_mnemonic(tmp_path):
    from zerochain_tpu_torch.wallet import bip39

    w = Wallet(tmp_path / "m1")
    phrase = w.init(b"pw", iterations=64)
    assert bip39.validate(phrase)
    sk = w.spending_key(b"pw", "default")

    w2 = Wallet(tmp_path / "m2")
    w2.recover(b"pw2", phrase, iterations=64)
    assert w2.spending_key(b"pw2", "default") == sk


# ------------------------------------------------ AES-128-CTR without a library
def test_aes_128_ctr_sp800_38a_f51():
    """SP 800-38A F.5.1 (CTR-AES128.Encrypt) and F.5.2 (its decryption)."""
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    iv = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
    plain = bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172a" "ae2d8a571e03ac9c9eb76fac45af8e51"
        "30c81c46a35ce411e5fbc1191a0a52ef" "f69f2445df4f9b17ad2b417be66c3710")
    cipher = bytes.fromhex(
        "874d6191b620e3261bef6864990db6ce" "9806f66b7970fdff8617187bb9fffdff"
        "5ae4df3edbd5d35e5b4f09020db03eab" "1e031dda2fbe03d1792170a0f3009cee")
    assert aes_128_ctr(key, iv, plain) == cipher
    assert aes_128_ctr(key, iv, cipher) == plain


@pytest.mark.parametrize("iv_kind", ["random", "carry64", "wrap128"])
def test_aes_128_ctr_equals_jax(iv_kind):
    """Seeded keys, IVs and every length 0-100 against the JAX package's
    aes_128_ctr; the counter's carry past its low 64 bits and its wrap at
    2^128 included."""
    from zerochain_tpu.wallet.crypto import aes_128_ctr as jax_aes

    rng = np.random.default_rng(["random", "carry64", "wrap128"].index(iv_kind))
    for n in range(101):
        key = rng.bytes(16)
        iv = rng.bytes(16)
        if iv_kind == "carry64":  # low 64 bits about to overflow
            iv = iv[:8] + b"\xff" * 7 + bytes([256 - 1 - (n % 4)])
        elif iv_kind == "wrap128":
            iv = b"\xff" * 15 + bytes([256 - 1 - (n % 4)])
        data = rng.bytes(n)
        assert aes_128_ctr(key, iv, data) == jax_aes(key, iv, data), (n, iv)


def test_crypto_imports_without_cryptography():
    root = pathlib.Path(__file__).resolve().parent.parent
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'cryptography':\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from zerochain_tpu_torch.wallet import crypto, keystore\n"
        "key = bytes.fromhex('2b7e151628aed2a6abf7158809cf4f3c')\n"
        "iv = bytes.fromhex('f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff')\n"
        "out = crypto.aes_128_ctr(key, iv, bytes.fromhex("
        "'6bc1bee22e409f96e93d7e117393172a'))\n"
        "assert out.hex() == '874d6191b620e3261bef6864990db6ce', out.hex()\n"
        "assert 'cryptography' not in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd="/")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


# ------------------------------------------------ keystores across packages
def _accounts(wallet_cls, root, password):
    w = wallet_cls(root)
    return {a["name"]: (a["address"], a["default"],
                        w.spending_key(password, a["name"]).fs)
            for a in w.list_accounts()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_keystore_opened_across_packages(tmp_path, writer):
    """A wallet written by one package opens in the other with the same
    password: the same accounts, SS58 addresses and spending keys; and the
    reader's keyfile for a fresh account opens in the writer."""
    from zerochain_tpu.wallet.keystore import Wallet as JaxWallet

    write, read = ((JaxWallet, Wallet) if writer == "jax"
                   else (Wallet, JaxWallet))
    root = tmp_path / "w"
    seed = bytes(np.random.default_rng(42).integers(0, 256, 32, np.uint8))
    w = write(root)
    w.init(b"pw", seed=seed)  # DEFAULT_ITERATIONS, as the CLI writes
    w.add_account("bob", b"pw", iterations=64)
    written = _accounts(write, root, b"pw")
    assert _accounts(read, root, b"pw") == written
    with pytest.raises(Exception, match="MAC"):
        read(root).spending_key(b"wrong", "bob")

    read(root).add_account("carol", b"pw", iterations=64)
    both = _accounts(write, root, b"pw")
    assert both == _accounts(read, root, b"pw")
    assert set(both) == {"default", "bob", "carol"}
