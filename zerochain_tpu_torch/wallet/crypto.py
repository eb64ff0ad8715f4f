"""Keystore crypto primitives (parity-crypto structure).

KDF = PBKDF2-HMAC-SHA256 (dk 32 B, split 16/16), cipher = AES-128-CTR,
MAC = keccak256(derived_right || ciphertext) — the same construction the
reference's keyfile uses via parity's `crypto` crate
(zface/src/wallet/keyfile.rs:108-157).  Keccak-f[1600] is implemented here
because hashlib only ships the NIST-padded SHA-3 variant, and AES-128
(FIPS-197) with its CTR mode (SP 800-38A) because the standard library has
no block cipher; the keystore encrypts 32-byte keys, so speed does not
matter.
"""

from __future__ import annotations

import hashlib

# ---------------------------------------------------------------- keccak
_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_MASK = (1 << 64) - 1


def _rol(v, n):
    return ((v << n) | (v >> (64 - n))) & _MASK


def _keccak_f(state):
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [
            state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3] ^ state[x][4]
            for x in range(5)
        ]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(state[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x][y] = b[x][y] ^ (
                    (~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _MASK
                )
        # iota
        state[0][0] ^= rc
    return state


def keccak256(data: bytes) -> bytes:
    rate = 136  # 1088-bit rate for 256-bit output
    state = [[0] * 5 for _ in range(5)]
    # pad10*1 with 0x01 domain (keccak, not SHA-3's 0x06)
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[i * 8 : (i + 1) * 8], "little")
            x, y = i % 5, i // 5
            state[x][y] ^= lane
        _keccak_f(state)
    out = b""
    for i in range(4):
        x, y = i % 5, i // 5
        out += state[x][y].to_bytes(8, "little")
    return out


# ------------------------------------------------------------------- kdf
def derive_key_iterations(password: bytes, salt: bytes, iterations: int):
    """-> (derived_left 16B, derived_right 16B)"""
    dk = hashlib.pbkdf2_hmac("sha256", password, salt, iterations, 32)
    return dk[:16], dk[16:]


def derive_mac(derived_right: bytes, ciphertext: bytes) -> bytes:
    return keccak256(derived_right + ciphertext)


# ---------------------------------------------------------------- cipher
def _xtime(a: int) -> int:
    """a * x in GF(2^8) mod x^8 + x^4 + x^3 + x + 1."""
    a <<= 1
    return a ^ 0x11B if a & 0x100 else a


def _gf_mul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a, b = _xtime(a), b >> 1
    return out


def _make_sbox() -> bytes:
    """FIPS-197 5.1.1: the multiplicative inverse (a^254; 0 -> 0), then
    the affine map b ^ rotl(b, 1..4) ^ 0x63."""
    box = bytearray(256)
    for a in range(256):
        inv, p, e = 1, a, 254
        while e:
            if e & 1:
                inv = _gf_mul(inv, p)
            p, e = _gf_mul(p, p), e >> 1
        b = inv if a else 0
        s = b
        for r in range(1, 5):
            s ^= ((b << r) | (b >> (8 - r))) & 0xFF
        box[a] = s ^ 0x63
    return bytes(box)


_SBOX = _make_sbox()
_MUL2 = bytes(_xtime(a) for a in range(256))
_MUL3 = bytes(_xtime(a) ^ a for a in range(256))


def _expand_key_128(key: bytes) -> list[list[int]]:
    """FIPS-197 5.2: the 11 round keys of AES-128, 16 bytes each."""
    if len(key) != 16:
        raise ValueError(f"AES-128 takes a 16-byte key, got {len(key)}")
    w = [list(key[4 * i: 4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [_SBOX[b] for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [sum(w[4 * r: 4 * r + 4], []) for r in range(11)]


def _encrypt_block(round_keys: list[list[int]], block: bytes) -> bytes:
    """FIPS-197 5.1: one 16-byte block; the state is column-major (byte
    r + 4c is row r, column c)."""
    s = [b ^ k for b, k in zip(block, round_keys[0])]
    for rnd in range(1, 11):
        s = [_SBOX[b] for b in s]
        s = [s[r + 4 * ((c + r) % 4)] for c in range(4) for r in range(4)]
        if rnd < 10:
            mixed = []
            for c in range(4):
                a0, a1, a2, a3 = s[4 * c: 4 * c + 4]
                mixed += [
                    _MUL2[a0] ^ _MUL3[a1] ^ a2 ^ a3,
                    a0 ^ _MUL2[a1] ^ _MUL3[a2] ^ a3,
                    a0 ^ a1 ^ _MUL2[a2] ^ _MUL3[a3],
                    _MUL3[a0] ^ a1 ^ a2 ^ _MUL2[a3],
                ]
            s = mixed
        s = [b ^ k for b, k in zip(s, round_keys[rnd])]
    return bytes(s)


def aes_128_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-128 in CTR mode (SP 800-38A 6.5): the 16-byte IV is the first
    counter block, incremented as one 128-bit big-endian integer (mod
    2^128) a block; encryption and decryption are the same call."""
    if len(iv) != 16:
        raise ValueError(f"CTR takes a 16-byte IV, got {len(iv)}")
    round_keys = _expand_key_128(key)
    ctr = int.from_bytes(iv, "big")
    out = bytearray()
    for off in range(0, len(data), 16):
        ks = _encrypt_block(round_keys, ctr.to_bytes(16, "big"))
        out += bytes(a ^ b for a, b in zip(data[off: off + 16], ks))
        ctr = (ctr + 1) & ((1 << 128) - 1)
    return bytes(out)
