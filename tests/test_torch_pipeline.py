"""The slice as a whole: the port's prover against the JAX prover.

The JAX prover holds a CRS from fixed toxic waste and writes it with
``save_queries``; ``convert.queries_from_ref_npz`` carries it into the port.
With the same assignments and the same (r, s) both provers must return the
same proofs, integer for integer (tolerance 0); the port's own
``from_toxic_waste`` must give them again; the host verifier accepts them
and rejects a perturbed public input.

XLA compiles the JAX prover's graphs for most of this file's time on a CPU,
so the MiniCommit case spares two of them: the JAX prover takes its CRS from
the bigint ``generate_parameters`` (same toxic waste, no fixed-base MSM
graph) and sums A/B/C on the host (``ZEROCHAIN_HOST_ASSEMBLE``, no
double-and-add graph); witness, quotient, digits and the five MSMs run as
JAX graphs.  The port's CRS generation and assembly are held against the
JAX prover's key and proofs all the same, and against the bigint prover
below.  The ConfidentialTransfer circuit goes through the JAX prover's own
``from_toxic_waste`` and device assembly behind ZEROCHAIN_PIPELINE=1."""

import os

import pytest
import torch

from zerochain_tpu_torch import convert
from zerochain_tpu_torch.groth16.core import prepare_verifying_key, verify_proof
from zerochain_tpu_torch.mirror.field import R

torch.set_num_threads(2)  # several test workers share the cores

TOXIC = dict(tau=424242, alpha=111, beta=222, gamma=333, delta=444)
RS = [(0x1234567 * 31337 % R, 0x7654321 * 271828 % R),
      (R - 5, 0xDEADBEEF)]


def _ints(proofs):
    """Proofs as plain integer tuples (the two packages have a Proof class
    each, and dataclasses of different classes never compare equal)."""
    return [(p.a, p.b, p.c) for p in proofs]


def confidential_assignments(n):
    from zerochain_tpu_torch.mirror import jubjub as jj
    from zerochain_tpu_torch.mirror.field import S
    from zerochain_tpu_torch.protocol.elgamal import Ciphertext
    from zerochain_tpu_torch.protocol.keys import (
        EncryptionKey, ProofGenerationKey)

    out = []
    g_epoch = jj.find_group_hash(b"\x02\x00\x00\x00", b"zcgepoch")
    for i in range(n):
        pgk = ProofGenerationKey.from_seed(f"test-sender-{i}".encode())
        dk = pgk.into_decryption_key()
        ek_s = EncryptionKey.from_decryption_key(dk)
        ek_r = EncryptionKey.from_seed(f"test-recipient-{i}".encode())
        ct = Ciphertext.encrypt(27, (0xABCDEF + i) % S, ek_s)
        out.append(dict(
            amount=10, remaining_balance=16, fee=1, dec_key=dk.fs,
            randomness=(0x1337C0DE + i) % S, alpha=(41 + i) % S,
            enc_key_recipient=ek_r.point, enc_balance_left=ct.left,
            enc_balance_right=ct.right, pgk=pgk.point, g_epoch=g_epoch))
    return out


def _both_provers(tmp_path, jprover, port_cls, assignments):
    path = str(tmp_path / "queries.npz")
    jprover.save_queries(path)
    jproofs = jprover.prove(assignments, rs=RS)
    jpub = jprover.public_inputs(assignments)

    queries, vk = convert.queries_from_ref_npz(path)
    prover = port_cls(None, _device_queries=queries, _vk=vk, device="cpu")
    proofs = prover.prove(assignments, rs=RS)
    assert _ints(proofs) == _ints(jproofs)
    assert prover.public_inputs(assignments) == jpub

    pvk = prepare_verifying_key(prover.vk)
    for proof, pub in zip(proofs, jpub):
        assert verify_proof(pvk, proof, pub)
    bad = list(jpub[0])
    bad[-1] = (bad[-1] + 1) % R
    assert not verify_proof(pvk, proofs[0], bad)
    assert not verify_proof(pvk, proofs[0], jpub[1])
    return prover, proofs


MINI_ASSIGNMENTS = [dict(amount=10), dict(amount=0xFFFF0001)]


@pytest.fixture(scope="module")
def own():
    """The port's MiniProver on its own CRS, and its proofs for the fixed
    (r, s): built once for the module."""
    from zerochain_tpu_torch.prover import MiniProver

    old = os.environ.get("ZEROCHAIN_MSM_CHUNK")
    os.environ["ZEROCHAIN_MSM_CHUNK"] = "256"
    try:
        prover = MiniProver.from_toxic_waste(
            **TOXIC, chunk=256, chunk_g2=256, device="cpu")
    finally:
        if old is None:
            del os.environ["ZEROCHAIN_MSM_CHUNK"]
        else:
            os.environ["ZEROCHAIN_MSM_CHUNK"] = old
    return prover, prover.prove(MINI_ASSIGNMENTS, rs=RS)


def test_mini_prover_matches_jax(monkeypatch, tmp_path, own):
    monkeypatch.setenv("ZEROCHAIN_MSM_CHUNK", "256")
    monkeypatch.setenv("ZEROCHAIN_HOST_ASSEMBLE", "1")  # read by the JAX prover only
    from zerochain_tpu.groth16.core import generate_parameters
    from zerochain_tpu.models.mini import MiniCommit
    from zerochain_tpu.prover_tpu.pipeline import MiniProver as JMini
    from zerochain_tpu_torch.prover import MiniProver

    jprover = JMini(generate_parameters(MiniCommit(), **TOXIC))
    prover, proofs = _both_provers(
        tmp_path, jprover, MiniProver, MINI_ASSIGNMENTS)
    assert set(prover.last_timings) >= {"witness", "quotient", "digits",
                                        "msm_a", "msm_b2", "assemble"}
    # the port's own CRS generation gives the same key and the same proofs
    own_prover, own_proofs = own
    assert own_prover.vk == prover.vk
    assert _ints(own_proofs) == _ints(proofs)


def test_own_crs_cache_round_trip(monkeypatch, tmp_path, own):
    monkeypatch.setenv("ZEROCHAIN_MSM_CHUNK", "256")
    from zerochain_tpu_torch.prover import MiniProver

    own_prover, _ = own
    cache = str(tmp_path / "own.npz")
    own_prover.save_queries(cache)
    cached = MiniProver.from_cache(cache, device="cpu")
    assert cached.vk == own_prover.vk
    for name in ("a_chunks", "b1_chunks", "b2_chunks", "l_chunks", "h_chunks"):
        for ca, cb in zip(getattr(cached, name), getattr(own_prover, name)):
            for x, y in zip(_leaves(ca), _leaves(cb)):
                assert torch.equal(x, y)


def _leaves(pt):
    out = []
    for c in pt:
        out.extend(c if isinstance(c, tuple) else (c,))
    return out


def test_own_proofs_match_the_host_prover(own):
    """The bigint Groth16 prover of groth16.core on the same toxic waste,
    witness and (r, s): the oracle for the proof itself."""
    from zerochain_tpu_torch.groth16.core import create_proof, generate_parameters
    from zerochain_tpu_torch.models.mini import MiniCommit

    _, own_proofs = own
    params = generate_parameters(MiniCommit(), **TOXIC)
    oracle = [create_proof(MiniCommit(amount=a["amount"]), params, r, s)
              for a, (r, s) in zip(MINI_ASSIGNMENTS, RS)]
    assert _ints(own_proofs) == _ints(oracle)


def test_prove_draws_its_own_randomness(own):
    prover, fixed = own
    proofs = prover.prove(MINI_ASSIGNMENTS)          # rs=None: os.urandom
    assert all(a != b for a, b in zip(_ints(proofs), _ints(fixed)))
    pvk = prepare_verifying_key(prover.vk)
    for proof, pub in zip(proofs, prover.public_inputs(MINI_ASSIGNMENTS)):
        assert verify_proof(pvk, proof, pub)


@pytest.mark.skipif(
    not os.environ.get("ZEROCHAIN_PIPELINE"),
    reason="set ZEROCHAIN_PIPELINE=1 to run the full ConfidentialTransfer pipeline on a CPU",
)
def test_confidential_prover_matches_jax(monkeypatch, tmp_path):
    from zerochain_tpu.prover_tpu.pipeline import ConfidentialProver as JProver
    from zerochain_tpu_torch.prover import ConfidentialProver

    _both_provers(tmp_path, JProver.from_toxic_waste(**TOXIC),
                  ConfidentialProver, confidential_assignments(2))
