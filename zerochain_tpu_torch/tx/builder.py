"""Proof drivers and extrinsic builders.

Reference flow (core/proofs/src/confidential.rs:105-431):
  derive keys -> synthesize witness -> groth16 prove -> local check_proof
  with the runtime's public-input layout -> package ConfidentialXt bytes ->
  RedDSA-sign the call.  The anonymous twin follows anonymous.rs:97-362.

``backend=`` is a ``prover.backend.TorchBackend``, which runs setup's
fixed-base exponentiations and the proof's MSMs and quotient NTTs on its
device, or ``groth16.core.MIRROR`` (host bigints).  ``None``, the default,
is a ``TorchBackend`` on the CUDA device, which raises where there is none:
the CPU is used only when the caller passes MIRROR or
``TorchBackend(device="cpu")``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..groth16 import serialization as ser
from ..groth16.core import (
    Parameters,
    PreparedVerifyingKey,
    create_proof,
    generate_parameters,
    prepare_verifying_key,
    verify_proof,
)
from ..mirror import jubjub as jj
from ..mirror.field import R, S
from ..models.anonymous import ANONIMITY_SIZE, AnonymousTransfer
from ..models.confidential import ConfidentialTransfer
from ..protocol.elgamal import Ciphertext
from ..protocol.keys import (
    DecryptionKey,
    EncryptionKey,
    ProofGenerationKey,
    SpendingKey,
)
from ..runtime.chain import Extrinsic
from ..runtime.primitives import (
    CiphertextBytes,
    EncKey,
    LeftCiphertext,
    Nonce,
    ProofBytes,
    RightCiphertext,
    SigVerificationKey,
)


def _rand_fs() -> int:
    return int.from_bytes(os.urandom(32), "little") % S


def _backend_or_card(backend):
    if backend is not None:
        return backend
    from ..prover.backend import TorchBackend

    return TorchBackend()


class KeyContext:
    """Proving key + prepared verifying key pair (crypto_components.rs:297)."""

    def __init__(self, params: Parameters, pvk: PreparedVerifyingKey):
        self.params = params
        self.pvk = pvk

    @classmethod
    def setup(cls, circuit_factory, backend=None) -> "KeyContext":
        backend = _backend_or_card(backend)
        params = generate_parameters(
            circuit_factory(),
            tau=_rand_fs() % R or 7,
            alpha=_rand_fs() % R or 11,
            beta=_rand_fs() % R or 13,
            gamma=_rand_fs() % R or 17,
            delta=_rand_fs() % R or 19,
            backend=backend,
        )
        return cls(params, prepare_verifying_key(params.vk))

    # -- persistence (ProofBuilder::write_to_file / read_from_path) -----
    def write_to_files(self, pk_path: str, vk_path: str, circuit_factory):
        with open(pk_path, "wb") as f:
            f.write(ser.params_to_bytes(self.params))
        with open(vk_path, "wb") as f:
            f.write(ser.pvk_to_bytes(self.pvk))

    @classmethod
    def read_from_files(cls, pk_path: str, vk_path: str, circuit_factory):
        dens = ser.densities_for(circuit_factory())
        params = ser.params_from_bytes(open(pk_path, "rb").read(), dens)
        pvk = ser.pvk_from_bytes(open(vk_path, "rb").read())
        return cls(params, pvk)


@dataclass
class ConfidentialXt:
    """The on-chain call bytes (confidential.rs:357-370)."""

    proof: bytes  # 192
    enc_key_sender: bytes  # 32
    enc_key_recipient: bytes  # 32
    left_amount_sender: bytes  # 32
    left_amount_recipient: bytes  # 32
    left_fee: bytes  # 32
    right_randomness: bytes  # 32
    enc_balance: bytes  # 64
    nonce: bytes  # 32
    rvk: bytes  # 32
    rsk: bytes  # 32 (client-side signing key, never broadcast)

    def to_extrinsic(self, nonce_index: int = 0) -> Extrinsic:
        xt = Extrinsic(
            module="encrypted_balances",
            method="confidential_transfer",
            args=dict(
                zkproof=ProofBytes(self.proof),
                address_sender=EncKey(self.enc_key_sender),
                address_recipient=EncKey(self.enc_key_recipient),
                amount_sender=LeftCiphertext(self.left_amount_sender),
                amount_recipient=LeftCiphertext(self.left_amount_recipient),
                fee_sender=LeftCiphertext(self.left_fee),
                randomness=RightCiphertext(self.right_randomness),
                nonce=Nonce(self.nonce),
            ),
            rvk=SigVerificationKey(self.rvk),
            nonce_index=nonce_index,
        )
        return xt.sign(int.from_bytes(self.rsk, "little"))


def build_confidential_xt(
    ctx: KeyContext,
    amount: int,
    remaining_balance: int,
    spending_key: SpendingKey,
    enc_key_recipient: EncryptionKey,
    encrypted_balance: Ciphertext,
    g_epoch,
    fee: int = 1,
    backend=None,
    alpha: int | None = None,
    randomness: int | None = None,
    rs=None,
    check: bool = True,
) -> ConfidentialXt:
    """(confidential.rs:105-279 gen_proof + check_proof + gen_xt)"""
    backend = _backend_or_card(backend)
    pgk = ProofGenerationKey.from_spending_key(spending_key)
    dec_key = pgk.into_decryption_key()
    enc_key_sender = EncryptionKey.from_decryption_key(dec_key)
    if alpha is None:
        alpha = _rand_fs()
    if randomness is None:
        randomness = _rand_fs()

    circuit = ConfidentialTransfer(
        amount=amount,
        remaining_balance=remaining_balance,
        randomness=randomness,
        alpha=alpha,
        proof_generation_key=pgk.point,
        dec_key_sender=dec_key.fs,
        enc_key_recipient=enc_key_recipient.point,
        encrypted_balance=(encrypted_balance.left, encrypted_balance.right),
        fee=fee,
        g_epoch=g_epoch,
    )
    r, s = rs if rs is not None else (_rand_fs() % R, _rand_fs() % R)
    proof = create_proof(circuit, ctx.params, r, s, backend=backend)

    ct_amount_sender = Ciphertext.encrypt(amount, randomness, enc_key_sender)
    ct_amount_recipient = Ciphertext.encrypt(
        amount, randomness, enc_key_recipient
    )
    ct_fee = Ciphertext.encrypt(fee, randomness, enc_key_sender)
    rvk = pgk.into_rvk(alpha)
    nonce = jj.mul(g_epoch, dec_key.fs)

    if check:
        inputs = []
        for p in (
            enc_key_sender.point,
            enc_key_recipient.point,
            ct_amount_sender.left,
            ct_amount_recipient.left,
            ct_amount_sender.right,
            ct_fee.left,
            encrypted_balance.left,
            encrypted_balance.right,
            rvk,
            g_epoch,
            nonce,
        ):
            inputs.extend(p)
        assert verify_proof(ctx.pvk, proof, inputs), "local check_proof failed"

    return ConfidentialXt(
        proof=ser.proof_to_bytes(proof),
        enc_key_sender=jj.to_bytes(enc_key_sender.point),
        enc_key_recipient=jj.to_bytes(enc_key_recipient.point),
        left_amount_sender=jj.to_bytes(ct_amount_sender.left),
        left_amount_recipient=jj.to_bytes(ct_amount_recipient.left),
        left_fee=jj.to_bytes(ct_fee.left),
        right_randomness=jj.to_bytes(ct_amount_sender.right),
        enc_balance=jj.to_bytes(encrypted_balance.left)
        + jj.to_bytes(encrypted_balance.right),
        nonce=jj.to_bytes(nonce),
        rvk=jj.to_bytes(rvk),
        rsk=spending_key.into_rsk(alpha).to_bytes(32, "little"),
    )


@dataclass
class AnonymousXt:
    proof: bytes
    enc_keys: list  # 12 x 32 B
    left_ciphertexts: list  # 12 x 32 B
    right_ciphertext: bytes
    nonce: bytes
    rvk: bytes
    rsk: bytes

    def to_extrinsic(self, nonce_index: int = 0) -> Extrinsic:
        xt = Extrinsic(
            module="anonymous_balances",
            method="anonymous_transfer",
            args=dict(
                zkproof=ProofBytes(self.proof),
                enc_keys=[EncKey(k) for k in self.enc_keys],
                left_ciphertexts=[
                    LeftCiphertext(c) for c in self.left_ciphertexts
                ],
                right_ciphertext=RightCiphertext(self.right_ciphertext),
                nonce=Nonce(self.nonce),
            ),
            rvk=SigVerificationKey(self.rvk),
            nonce_index=nonce_index,
        )
        return xt.sign(int.from_bytes(self.rsk, "little"))


def build_anonymous_xt(
    ctx: KeyContext,
    amount: int,
    remaining_balance: int,
    s_index: int,
    t_index: int,
    spending_key: SpendingKey,
    enc_keys: list,  # 12 EncryptionKey, positions s/t are sender/recipient
    enc_balances: list,  # 12 Ciphertext
    g_epoch,
    backend=None,
    alpha: int | None = None,
    randomness: int | None = None,
    rs=None,
    check: bool = True,
) -> AnonymousXt:
    """(anonymous.rs:97-278)"""
    backend = _backend_or_card(backend)
    assert len(enc_keys) == ANONIMITY_SIZE
    pgk = ProofGenerationKey.from_spending_key(spending_key)
    dec_key = pgk.into_decryption_key()
    enc_key_sender = EncryptionKey.from_decryption_key(dec_key)
    assert enc_keys[s_index].point == enc_key_sender.point
    if alpha is None:
        alpha = _rand_fs()
    if randomness is None:
        randomness = _rand_fs()

    # left ciphertexts: sender neg-encrypts, recipient encrypts, decoys 0
    lefts = []
    for i, ek in enumerate(enc_keys):
        if i == s_index:
            lefts.append(Ciphertext.neg_encrypt(amount, randomness, ek).left)
        elif i == t_index:
            lefts.append(Ciphertext.encrypt(amount, randomness, ek).left)
        else:
            lefts.append(Ciphertext.encrypt(0, randomness, ek).left)
    right_ct = jj.mul(jj.generator(jj.NOTE_COMMITMENT_RANDOMNESS), randomness)

    circuit = AnonymousTransfer(
        amount=amount,
        remaining_balance=remaining_balance,
        s_index=s_index,
        t_index=t_index,
        randomness=randomness,
        alpha=alpha,
        proof_generation_key=pgk.point,
        dec_key=dec_key.fs,
        enc_keys=[k.point for k in enc_keys],
        left_ciphertexts=lefts,
        right_ciphertext=right_ct,
        enc_balances=[(b.left, b.right) for b in enc_balances],
        g_epoch=g_epoch,
    )
    r, s = rs if rs is not None else (_rand_fs() % R, _rand_fs() % R)
    proof = create_proof(circuit, ctx.params, r, s, backend=backend)

    rvk = pgk.into_rvk(alpha)
    nonce = jj.mul(g_epoch, dec_key.fs)

    if check:
        inputs = []
        for k in enc_keys:
            inputs.extend(k.point)
        for lc in lefts:
            inputs.extend(lc)
        for b in enc_balances:
            inputs.extend(b.left)
        for b in enc_balances:
            inputs.extend(b.right)
        inputs.extend(right_ct)
        inputs.extend(rvk)
        inputs.extend(g_epoch)
        inputs.extend(nonce)
        assert verify_proof(ctx.pvk, proof, inputs), "local check_proof failed"

    return AnonymousXt(
        proof=ser.proof_to_bytes(proof),
        enc_keys=[jj.to_bytes(k.point) for k in enc_keys],
        left_ciphertexts=[jj.to_bytes(lc) for lc in lefts],
        right_ciphertext=jj.to_bytes(right_ct),
        nonce=jj.to_bytes(nonce),
        rvk=jj.to_bytes(rvk),
        rsk=spending_key.into_rsk(alpha).to_bytes(32, "little"),
    )
