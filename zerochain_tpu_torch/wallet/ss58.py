"""SS58 address codec for encryption keys (reference zface/src/ss58.rs).

Substrate SS58: base58( version || 32-byte key || checksum[0:2] ) with
checksum = blake2b-512("SS58PRE" || version || key).  Zerochain addresses
encode the 32-byte EncryptionKey point with the generic version byte 42.
"""

from __future__ import annotations

import hashlib

_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
SS58_PREFIX = b"SS58PRE"
DEFAULT_VERSION = 42


def _b58encode(b: bytes) -> str:
    n = int.from_bytes(b, "big")
    out = ""
    while n:
        n, r = divmod(n, 58)
        out = _ALPHABET[r] + out
    pad = 0
    for c in b:
        if c == 0:
            pad += 1
        else:
            break
    return _ALPHABET[0] * pad + out


def _b58decode(s: str) -> bytes:
    n = 0
    for c in s:
        n = n * 58 + _ALPHABET.index(c)
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
    pad = 0
    for c in s:
        if c == _ALPHABET[0]:
            pad += 1
        else:
            break
    return b"\x00" * pad + raw


def encode_ss58(key32: bytes, version: int = DEFAULT_VERSION) -> str:
    assert len(key32) == 32
    body = bytes([version]) + key32
    h = hashlib.blake2b(digest_size=64)
    h.update(SS58_PREFIX + body)
    return _b58encode(body + h.digest()[:2])


def decode_ss58(addr: str, version: int = DEFAULT_VERSION) -> bytes:
    raw = _b58decode(addr)
    if len(raw) != 35:
        raise ValueError("bad SS58 length")
    if raw[0] != version:
        raise ValueError("bad SS58 version")
    body, checksum = raw[:33], raw[33:]
    h = hashlib.blake2b(digest_size=64)
    h.update(SS58_PREFIX + body)
    if h.digest()[:2] != checksum:
        raise ValueError("bad SS58 checksum")
    return body[1:]
