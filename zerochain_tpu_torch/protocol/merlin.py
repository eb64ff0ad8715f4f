"""Merlin transcripts (STROBE-128 over Keccak-f[1600]) — byte-compatible
with the `merlin` Rust crate used by the reference's multi-party RedDSA
(reference core/multi-reddsa/src/transcript.rs:1-69, which drives
`merlin::Transcript::{append_message, challenge_bytes, build_rng}`).

Host-side protocol code: transcripts are tiny and off the proving hot
path, so this is deliberately plain Python.  The golden vector from the
merlin crate's own `equivalence_simple` test is reproduced in
tests/test_torch_multi_reddsa.py to pin byte compatibility.

Layout of this module:
  - keccak_f1600: the 24-round permutation on a 5x5 u64 lane state
  - Strobe128: merlin's internal mini-STROBE (security level 128,
    rate R=166 bytes) with the meta_ad/ad/prf/key operations
  - Transcript: Merlin v1.0 framing (label + LE32 length prefixes)
  - TranscriptRngBuilder/TranscriptRng: witness-scalar RNG
    (transcript.rs:47-67 `witness_scalar`)
"""

from __future__ import annotations

import os

_MASK = (1 << 64) - 1

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# rho rotation offsets, indexed [x][y]
_ROT = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(lanes: list[int]) -> list[int]:
    """Keccak-f[1600] permutation.  `lanes` is 25 u64 in A[x + 5y] order
    (the byte order used by SHA-3 / STROBE: little-endian lanes)."""
    a = [[lanes[x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y] & _MASK)
                                     & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= rc
    return [a[x][y] for y in range(5) for x in range(5)]


def _permute_bytes(state: bytearray) -> bytearray:
    lanes = [int.from_bytes(state[8 * i:8 * i + 8], "little")
             for i in range(25)]
    lanes = keccak_f1600(lanes)
    out = bytearray(200)
    for i, lane in enumerate(lanes):
        out[8 * i:8 * i + 8] = lane.to_bytes(8, "little")
    return out


STROBE_R = 166  # merlin's Strobe128 rate (200 - 128/8/2... fixed in-crate)

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    """merlin's internal STROBE-128 duplex (strobe.rs in the merlin crate)."""

    def __init__(self, protocol_label: bytes | None = None, _state=None):
        if _state is not None:
            self.state, self.pos, self.pos_begin, self.cur_flags = _state
            return
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self.state = _permute_bytes(st)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        if protocol_label is not None:
            self.meta_ad(protocol_label, False)

    def clone(self) -> "Strobe128":
        return Strobe128(_state=(bytearray(self.state), self.pos,
                                 self.pos_begin, self.cur_flags))

    # -- internal duplex machinery ------------------------------------
    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        self.state = _permute_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes):
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            if self.cur_flags != flags:
                raise ValueError("cannot continue op with different flags")
            return
        if flags & FLAG_T:
            raise ValueError("T flag unsupported (no transport)")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (FLAG_C | FLAG_K)) and self.pos != 0:
            self._run_f()

    # -- public ops (the subset merlin uses) --------------------------
    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool):
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)


def _le32(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    """merlin::Transcript (Merlin v1.0 framing)."""

    MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes, _strobe: Strobe128 | None = None):
        if _strobe is not None:
            self.strobe = _strobe
            return
        self.strobe = Strobe128(self.MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int):
        self.append_message(label, x.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(n), True)
        return self.strobe.prf(n, False)

    def build_rng(self) -> "TranscriptRngBuilder":
        return TranscriptRngBuilder(self.strobe.clone())

    def clone(self) -> "Transcript":
        return Transcript(b"", _strobe=self.strobe.clone())


class TranscriptRngBuilder:
    """merlin::TranscriptRngBuilder (rekey with witness data, then mix
    in external entropy)."""

    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def rekey_with_witness_bytes(self, label: bytes,
                                 witness: bytes) -> "TranscriptRngBuilder":
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(len(witness)), True)
        self.strobe.key(witness, False)
        return self

    def finalize(self, entropy: bytes | None = None) -> "TranscriptRng":
        if entropy is None:
            entropy = os.urandom(32)
        if len(entropy) != 32:
            raise ValueError("entropy must be 32 bytes")
        self.strobe.meta_ad(b"rng", False)
        self.strobe.key(entropy, False)
        return TranscriptRng(self.strobe)


class TranscriptRng:
    """merlin::TranscriptRng — deterministic once finalized."""

    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def fill_bytes(self, n: int) -> bytes:
        self.strobe.meta_ad(_le32(n), False)
        return self.strobe.prf(n, False)
