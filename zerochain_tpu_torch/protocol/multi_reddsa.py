"""Multi-party RedDSA (MuSig-style 3 rounds: commit -> reveal -> share).

Reference core/multi-reddsa/src/: per-signer key coefficients
a_i = H*(L, X_i) over the concatenated key list L, aggregated key
X_bar = sum a_i X_i, nonce commitments, and share verification
s_i*G == R_i + c*a_i*X_i; the aggregate (R, s) verifies like a plain
RedDSA signature against X_bar with c = H*(X_bar || R, m)
(mr_pubkey.rs:12-45).

The nonce commitment runs through a byte-exact Merlin (STROBE-128)
transcript matching the reference's merlin crate usage
(commitment.rs:16-22 `Commitment::from_R`; transcript.rs:17-23
`commit_point`), so commitment bytes interchange with Rust cosigners.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..mirror import jubjub as jj
from ..mirror.field import S
from .merlin import Transcript
from .redjubjub import Signature, h_star

DEFAULT_BASE = jj.NOTE_COMMITMENT_RANDOMNESS  # "Diversifier" upstream


class MultiSigError(Exception):
    pass


def commit_point(t: Transcript, label: bytes, point) -> None:
    """TranscriptProtocol::commit_point (transcript.rs:17-23): append the
    32-byte Edwards encoding under `label`."""
    t.append_message(label, jj.to_bytes(point))


def commit_scalar(t: Transcript, label: bytes, scalar: int) -> None:
    """TranscriptProtocol::commit_scalar (transcript.rs:25-31): 32-byte
    little-endian scalar repr under `label`."""
    t.append_message(label, int(scalar).to_bytes(32, "little"))


def challenge_scalar(t: Transcript) -> int:
    """TranscriptProtocol::challenge_scalar (transcript.rs:33-44):
    rejection-sample 32 challenge bytes (label b"read", big-endian repr)
    until the value lies in Fs."""
    while True:
        buf = t.challenge_bytes(b"read", 32)
        v = int.from_bytes(buf, "big")
        if v < S:
            return v


def witness_scalar(t: Transcript, label: bytes, witness: int,
                   entropy: bytes | None = None) -> int:
    """TranscriptProtocol::witness_scalar (transcript.rs:47-67): fork the
    transcript into an RNG rekeyed with the witness bytes, then
    rejection-sample an Fs element.  Deterministic iff `entropy` given."""
    rng = (t.build_rng()
           .rekey_with_witness_bytes(label, int(witness).to_bytes(32, "little"))
           .finalize(entropy))
    while True:
        buf = rng.fill_bytes(32)
        v = int.from_bytes(buf, "big")
        if v < S:
            return v


def _commitment(R) -> bytes:
    """Commitment::from_R (commitment.rs:16-22), byte-compatible with the
    reference: Merlin transcript "R-commitment", point under empty label,
    32 challenge bytes under "commitment"."""
    t = Transcript(b"R-commitment")
    commit_point(t, b"", R)
    return t.challenge_bytes(b"commitment", 32)


@dataclass(frozen=True)
class SignerKeys:
    """Public key list + aggregation coefficients (commitment.rs:44-120)."""

    pub_keys: tuple

    def __post_init__(self):
        assert len(self.pub_keys) > 1

    def L(self) -> bytes:
        return b"".join(jj.to_bytes(pk) for pk in self.pub_keys)

    def a_factor(self, pk) -> int:
        return h_star(self.L(), jj.to_bytes(pk))

    def agg_pub_key(self):
        acc = jj.ZERO
        for pk in self.pub_keys:
            acc = jj.add(acc, jj.mul(pk, self.a_factor(pk)))
        return acc

    def __len__(self):
        return len(self.pub_keys)


class MRPubkey:
    """Aggregated verification key (mr_pubkey.rs)."""

    def __init__(self, point):
        self.point = point

    def verify(self, msg: bytes, sig: Signature,
               base_index: int = DEFAULT_BASE) -> bool:
        c = h_star(jj.to_bytes(self.point) + sig.rbar, msg)
        try:
            r = jj.from_bytes(sig.rbar)
        except jj.DecodeError:
            return False
        s = int.from_bytes(sig.sbar, "little")
        if s >= S:
            return False
        acc = jj.mul(self.point, c)
        acc = jj.add(acc, r)
        acc = jj.add(acc, jj.neg(jj.mul(jj.generator(base_index), s)))
        return jj.mul_by_cofactor(acc) == jj.ZERO


class CommitmentStage:
    """Round 1: publish H(R_i) (lib.rs:17-83)."""

    def __init__(self, msg: bytes, x_i: int, signer_keys: SignerKeys,
                 pos: int, base_index: int = DEFAULT_BASE,
                 t: bytes | None = None):
        self.msg = msg
        self.x_i = x_i
        self.signer_keys = signer_keys
        self.pos = pos
        self.base_index = base_index
        if t is None:
            t = os.urandom(80)
        self.r_i = h_star(t, msg)
        self.R_i = jj.mul(jj.generator(base_index), self.r_i)
        self.commitment = _commitment(self.R_i)

    def commit(self, commitments: list[bytes]) -> "RevealStage":
        """Receive everyone's commitments; publish R_i next."""
        return RevealStage(self, commitments)


class RevealStage:
    """Round 2: publish R_i, check against commitments, compute share."""

    def __init__(self, prev: CommitmentStage, commitments: list[bytes]):
        self._c = prev
        self.commitments = commitments

    @property
    def R_i(self):
        return self._c.R_i

    def reveal(self, reveals: list) -> tuple["ShareStage", int]:
        c = self._c
        sum_R = jj.ZERO
        for R in reveals:
            sum_R = jj.add(sum_R, R)
        for comm, R in zip(self.commitments, reveals):
            if _commitment(R) != comm:
                raise MultiSigError("nonce reveal does not match commitment")

        xbar_r = jj.to_bytes(c.signer_keys.agg_pub_key()) + jj.to_bytes(sum_R)
        ch = h_star(xbar_r, c.msg)
        a_i = c.signer_keys.a_factor(c.signer_keys.pub_keys[c.pos])
        s_i = (c.r_i + ch * a_i % S * c.x_i) % S
        return ShareStage(c, xbar_r, sum_R, reveals), s_i


class ShareStage:
    """Round 3: verify everyone's shares, aggregate (lib.rs:131-167)."""

    def __init__(self, c: CommitmentStage, xbar_r: bytes, sum_R, reveals):
        self._c = c
        self.xbar_r = xbar_r
        self.sum_R = sum_R
        self.reveals = reveals

    def share(self, shares: list[int]) -> Signature:
        c = self._c
        g = jj.generator(c.base_index)
        ch = h_star(self.xbar_r, c.msg)
        s_total = 0
        for pos, (share, R_i) in enumerate(zip(shares, self.reveals)):
            # s_i * G == R_i + c * a_i * X_i   (cosigners.rs:60-78)
            a_i = c.signer_keys.a_factor(c.signer_keys.pub_keys[pos])
            lhs = jj.mul(g, share)
            rhs = jj.add(
                jj.mul(c.signer_keys.pub_keys[pos], ch * a_i % S), R_i
            )
            if lhs != rhs:
                raise MultiSigError(f"invalid share from signer {pos}")
            s_total = (s_total + share) % S
        return Signature(
            rbar=jj.to_bytes(self.sum_R),
            sbar=s_total.to_bytes(32, "little"),
        )
