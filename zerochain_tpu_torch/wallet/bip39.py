"""BIP39 mnemonics: entropy <-> 12/15/18/21/24-word phrase + seed KDF.

Matches the bip39 crate flow the reference wallet uses
(zface/src/wallet/commands.rs:29-37, 130-139: 12-word English phrase,
`Seed::new(&mnemonic, "")` = PBKDF2-HMAC-SHA512 over the NFKD phrase
with salt "mnemonic"+passphrase, 2048 iterations).
"""

from __future__ import annotations

import hashlib
import os
import unicodedata

from .bip39_words import WORD_INDEX, WORDLIST


class MnemonicError(ValueError):
    pass


def entropy_to_mnemonic(entropy: bytes) -> str:
    """Entropy (16/20/24/28/32 bytes) -> space-joined phrase with the
    SHA256 checksum bits appended (BIP39 generation rule)."""
    ent_bits = len(entropy) * 8
    if ent_bits not in (128, 160, 192, 224, 256):
        raise MnemonicError(f"entropy must be 16-32 bytes, got {len(entropy)}")
    cs_bits = ent_bits // 32
    checksum = hashlib.sha256(entropy).digest()[0] >> (8 - cs_bits)
    n = (int.from_bytes(entropy, "big") << cs_bits) | checksum
    total = ent_bits + cs_bits
    return " ".join(
        WORDLIST[(n >> (total - 11 * (i + 1))) & 0x7FF]
        for i in range(total // 11)
    )


def mnemonic_to_entropy(phrase: str) -> bytes:
    """Validate checksum and recover the entropy bytes."""
    words = unicodedata.normalize("NFKD", phrase).strip().lower().split()
    if len(words) not in (12, 15, 18, 21, 24):
        raise MnemonicError(f"phrase must have 12-24 words, got {len(words)}")
    n = 0
    for w in words:
        if w not in WORD_INDEX:
            raise MnemonicError(f"unknown mnemonic word: {w!r}")
        n = (n << 11) | WORD_INDEX[w]
    total = len(words) * 11
    cs_bits = total // 33
    ent_bits = total - cs_bits
    entropy = (n >> cs_bits).to_bytes(ent_bits // 8, "big")
    expected = hashlib.sha256(entropy).digest()[0] >> (8 - cs_bits)
    if (n & ((1 << cs_bits) - 1)) != expected:
        raise MnemonicError("mnemonic checksum mismatch")
    return entropy


def validate(phrase: str) -> bool:
    try:
        mnemonic_to_entropy(phrase)
        return True
    except MnemonicError:
        return False


def generate(words: int = 12, entropy: bytes | None = None) -> str:
    """New random phrase (reference: MnemonicType::Words12)."""
    if words not in (12, 15, 18, 21, 24):
        raise MnemonicError("word count must be 12/15/18/21/24")
    n_bytes = words * 11 * 32 // 33 // 8
    if entropy is None:
        entropy = os.urandom(n_bytes)
    if len(entropy) != n_bytes:
        raise MnemonicError(f"need {n_bytes} bytes of entropy")
    return entropy_to_mnemonic(entropy)


def to_seed(phrase: str, passphrase: str = "") -> bytes:
    """64-byte master seed: PBKDF2-HMAC-SHA512(NFKD(phrase),
    "mnemonic"+NFKD(passphrase), 2048) — `Seed::new(&mnemonic, "")`."""
    norm = unicodedata.normalize("NFKD", phrase.strip())
    salt = "mnemonic" + unicodedata.normalize("NFKD", passphrase)
    return hashlib.pbkdf2_hmac(
        "sha512", norm.encode(), salt.encode(), 2048
    )
