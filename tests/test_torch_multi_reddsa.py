"""Multi-party RedDSA in the port: 3-round signing, aggregate verification,
misuse, the merlin golden vector, and the signature's bytes against the JAX
package's for the same secrets and nonces."""

import pytest

from zerochain_tpu_torch.mirror import jubjub as jj
from zerochain_tpu_torch.mirror.field import S
from zerochain_tpu_torch.protocol.multi_reddsa import (
    CommitmentStage,
    MRPubkey,
    MultiSigError,
    SignerKeys,
    DEFAULT_BASE,
)


def _sign(msg, secrets, signer_keys, tweak=None):
    stages = [
        CommitmentStage(msg, x, signer_keys, i, t=bytes([i]) * 80)
        for i, x in enumerate(secrets)
    ]
    comms = [s.commitment for s in stages]
    reveal_stages = [s.commit(comms) for s in stages]
    reveals = [s.R_i for s in reveal_stages]
    share_pairs = [s.reveal(reveals) for s in reveal_stages]
    shares = [sh for _, sh in share_pairs]
    if tweak is not None:
        shares[tweak] = (shares[tweak] + 1) % S
    sigs = [st.share(shares) for st, _ in share_pairs]
    for s in sigs[1:]:
        assert s == sigs[0]
    return sigs[0]


@pytest.fixture(scope="module")
def setup():
    secrets = [11, 22, 33]
    g = jj.generator(DEFAULT_BASE)
    pub_keys = tuple(jj.mul(g, x) for x in secrets)
    keys = SignerKeys(pub_keys)
    return secrets, keys


def test_three_party_signature(setup):
    secrets, keys = setup
    msg = b"multi-sig message"
    sig = _sign(msg, secrets, keys)
    agg = MRPubkey(keys.agg_pub_key())
    assert agg.verify(msg, sig)
    assert not agg.verify(b"other message", sig)


def test_bad_share_rejected(setup):
    secrets, keys = setup
    with pytest.raises(MultiSigError):
        _sign(b"msg", secrets, keys, tweak=1)


def test_merlin_golden_vector():
    """merlin crate's own `equivalence_simple` test vector (merlin-2.0
    src/transcript.rs tests) — pins byte compatibility of the STROBE-128
    duplex + Merlin framing with the Rust implementation the reference
    links (core/multi-reddsa/src/transcript.rs:1-69)."""
    from zerochain_tpu_torch.protocol.merlin import Transcript, keccak_f1600

    # keccak-f[1600] permutation of the all-zero state (standard vector)
    out = keccak_f1600([0] * 25)
    assert out[0] == 0xF1258F7940E1DDE7
    assert out[1] == 0x84D5CCF933C0478A

    t = Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"
    )


def test_merlin_transcript_rng_deterministic():
    from zerochain_tpu_torch.protocol.merlin import Transcript

    def mk():
        t = Transcript(b"witness test")
        t.append_message(b"msg", b"hello")
        return (t.build_rng()
                .rekey_with_witness_bytes(b"w", b"\x01" * 32)
                .finalize(b"\x42" * 32))

    a, b = mk(), mk()
    x = a.fill_bytes(32)
    assert x == b.fill_bytes(32)
    assert a.fill_bytes(32) != x  # stream advances


def test_commitment_uses_merlin(setup):
    """Commitment::from_R parity shape: transcript "R-commitment", point
    under empty label, 32 bytes under "commitment"."""
    from zerochain_tpu_torch.protocol.merlin import Transcript
    from zerochain_tpu_torch.protocol.multi_reddsa import _commitment, commit_point

    R = jj.mul(jj.generator(DEFAULT_BASE), 7)
    t = Transcript(b"R-commitment")
    commit_point(t, b"", R)
    assert _commitment(R) == t.challenge_bytes(b"commitment", 32)


def test_commitment_mismatch_rejected(setup):
    secrets, keys = setup
    msg = b"msg"
    stages = [
        CommitmentStage(msg, x, keys, i, t=bytes([i]) * 80)
        for i, x in enumerate(secrets)
    ]
    comms = [s.commitment for s in stages]
    rs = [s.commit(comms) for s in stages]
    reveals = [s.R_i for s in rs]
    reveals[2] = jj.mul(jj.generator(DEFAULT_BASE), 999)  # lie in reveal
    with pytest.raises(MultiSigError):
        rs[0].reveal(reveals)


def test_three_party_signature_matches_jax(setup):
    """The same secrets, signer order and nonce seeds t give the JAX
    package's commitments, aggregate key and signature bytes."""
    from zerochain_tpu.protocol import multi_reddsa as jm

    secrets, keys = setup
    msg = b"multi-sig message"
    sig = _sign(msg, secrets, keys)
    jkeys = jm.SignerKeys(keys.pub_keys)
    assert jkeys.agg_pub_key() == keys.agg_pub_key()
    stages = [jm.CommitmentStage(msg, x, jkeys, i, t=bytes([i]) * 80)
              for i, x in enumerate(secrets)]
    ours = [CommitmentStage(msg, x, keys, i, t=bytes([i]) * 80)
            for i, x in enumerate(secrets)]
    assert [s.commitment for s in stages] == [s.commitment for s in ours]
    comms = [s.commitment for s in stages]
    reveal_stages = [s.commit(comms) for s in stages]
    reveals = [s.R_i for s in reveal_stages]
    share_pairs = [s.reveal(reveals) for s in reveal_stages]
    shares = [sh for _, sh in share_pairs]
    jsig = share_pairs[0][0].share(shares)
    assert jsig.to_bytes() == sig.to_bytes()
    assert jm.MRPubkey(jkeys.agg_pub_key()).verify(msg, jsig)
