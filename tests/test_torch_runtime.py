"""The port's runtime (SCALE codec, extrinsics, the balance and asset
modules, the zk-gated dispatch) on the cases of tests/test_scale.py and
tests/test_runtime_modules.py, and its extrinsics against the JAX
package's: the same fixed inputs sign and encode to the same bytes, and each
side decodes the other's.  Host-only: nothing here compiles JAX."""

import json
import os

import pytest

from zerochain_tpu_torch.mirror import jubjub as jj
from zerochain_tpu_torch.protocol.elgamal import Ciphertext
from zerochain_tpu_torch.protocol.keys import EncryptionKey
from zerochain_tpu_torch.runtime import Runtime, scale
from zerochain_tpu_torch.runtime.chain import Extrinsic
from zerochain_tpu_torch.runtime.encrypted_balances import DispatchError
from zerochain_tpu_torch.runtime.primitives import (
    CiphertextBytes,
    EncKey,
    LeftCiphertext,
    Nonce,
    ProofBytes,
    RightCiphertext,
    SigVerificationKey,
)


# hand-computed SCALE compact vectors
COMPACT_VECTORS = [
    (0, b"\x00"),
    (1, b"\x04"),
    (42, b"\xa8"),
    (63, b"\xfc"),
    (64, b"\x01\x01"),
    (69, b"\x15\x01"),
    (16383, b"\xfd\xff"),
    (16384, b"\x02\x00\x01\x00"),
    ((1 << 30) - 1, b"\xfe\xff\xff\xff"),
    (1 << 30, b"\x03\x00\x00\x00\x40"),
    ((1 << 32) - 1, b"\x03\xff\xff\xff\xff"),
    (1 << 32, b"\x07\x00\x00\x00\x00\x01"),
]


@pytest.mark.parametrize("value,encoding", COMPACT_VECTORS)
def test_compact_vectors(value, encoding):
    assert scale.compact_encode(value) == encoding
    decoded, offset = scale.compact_decode(encoding)
    assert decoded == value and offset == len(encoding)


def test_fixed_hash_and_vec_encodings():
    """EncKey/H256 = raw bytes; Ciphertext (64B Vec<u8>) = 0x0101 ++ bytes;
    Proof (192B Vec<u8>) = 0x0103 ++ bytes — hand-computed."""
    ek = bytes(range(32))
    assert scale._encode_arg("h256", EncKey(ek)) == ek

    ct = bytes(64)
    assert scale.encode_bytes(ct) == b"\x01\x01" + ct  # compact(64)=0x0101

    proof = bytes(192)
    assert scale.encode_bytes(proof) == b"\x01\x03" + proof  # compact(192)


def test_call_encoding_confidential_transfer():
    args = dict(
        zkproof=ProofBytes(b"\xaa" * 192),
        address_sender=EncKey(b"\x01" * 32),
        address_recipient=EncKey(b"\x02" * 32),
        amount_sender=LeftCiphertext(b"\x03" * 32),
        amount_recipient=LeftCiphertext(b"\x04" * 32),
        fee_sender=LeftCiphertext(b"\x05" * 32),
        randomness=RightCiphertext(b"\x06" * 32),
        nonce=Nonce(b"\x07" * 32),
    )
    enc = scale.encode_call("encrypted_balances", "confidential_transfer",
                            args)
    # module 0, call 0, Vec<u8> proof with compact(192) prefix, then 7 H256s
    expected = (b"\x00\x00" + b"\x01\x03" + b"\xaa" * 192
                + b"\x01" * 32 + b"\x02" * 32 + b"\x03" * 32 + b"\x04" * 32
                + b"\x05" * 32 + b"\x06" * 32 + b"\x07" * 32)
    assert enc == expected

    module, method, decoded = scale.decode_call(enc)
    assert (module, method) == ("encrypted_balances", "confidential_transfer")
    assert decoded["zkproof"] == b"\xaa" * 192
    assert decoded["nonce"] == b"\x07" * 32


def test_signing_payload_layout():
    call = b"\x00\x00" + b"\x01"  # arbitrary
    genesis = b"\x10" * 32
    payload = scale.signing_payload(5, call, genesis)
    assert payload == b"\x14" + call + b"\x00" + genesis  # compact(5)=0x14
    assert scale.signing_message(5, call, genesis) == scale.blake2_256(payload)


def test_extrinsic_sign_encode_decode_roundtrip():
    from zerochain_tpu_torch.protocol import redjubjub as rj

    rsk = 12345
    rvk_point = jj.mul(jj.generator(jj.NOTE_COMMITMENT_RANDOMNESS), rsk)
    rvk = SigVerificationKey(jj.to_bytes(rvk_point))

    args = dict(
        zkproof=ProofBytes(b"\x11" * 192),
        address_sender=EncKey(b"\x01" * 32),
        address_recipient=EncKey(b"\x02" * 32),
        amount_sender=LeftCiphertext(b"\x03" * 32),
        amount_recipient=LeftCiphertext(b"\x04" * 32),
        fee_sender=LeftCiphertext(b"\x05" * 32),
        randomness=RightCiphertext(b"\x06" * 32),
        nonce=Nonce(b"\x07" * 32),
    )
    xt = Extrinsic("encrypted_balances", "confidential_transfer", args,
                   rvk, nonce_index=3).sign(rsk, t=b"\x09" * 80)

    wire = xt.encode()
    # substrate-1.0 layout: compact(len) ++ 0x81 ++ 0xff ++ signer ++ sig64
    total, off = scale.compact_decode(wire)
    assert len(wire) - off == total
    assert wire[off] == 0x81
    assert wire[off + 1] == 0xFF
    assert wire[off + 2:off + 34] == rvk.data

    back = Extrinsic.decode(wire)
    assert back.module == "encrypted_balances"
    assert back.method == "confidential_transfer"
    assert back.nonce_index == 3
    assert back.rvk.data == rvk.data
    assert back.args["zkproof"].data == b"\x11" * 192
    assert back.payload() == xt.payload()
    # decoded signature verifies against the SCALE signing message
    vk = rj.PublicKey(jj.from_bytes(rvk.data))
    assert vk.verify(back.payload(), back.signature,
                     base_index=jj.NOTE_COMMITMENT_RANDOMNESS)


def test_anonymous_transfer_call_roundtrip():
    args = dict(
        zkproof=ProofBytes(b"\x22" * 192),
        enc_keys=[EncKey(bytes([i]) * 32) for i in range(12)],
        left_ciphertexts=[LeftCiphertext(bytes([i + 100]) * 32)
                          for i in range(12)],
        right_ciphertext=RightCiphertext(b"\x63" * 32),
        nonce=Nonce(b"\x64" * 32),
    )
    enc = scale.encode_call("anonymous_balances", "anonymous_transfer", args)
    assert enc[:2] == b"\x02\x00"
    # Vec<EncKey> prefix: compact(12) = 12<<2 = 0x30
    assert enc[2 + 2 + 192:2 + 2 + 192 + 1] == b"\x30"
    module, method, decoded = scale.decode_call(enc)
    assert (module, method) == ("anonymous_balances", "anonymous_transfer")
    assert len(decoded["enc_keys"]) == 12
    assert decoded["enc_keys"][5] == bytes([5]) * 32


VEC = os.path.join(os.path.dirname(__file__), "vectors")


def _runtime(accept=True):
    rt = Runtime(confidential_vk=None, anonymous_vk=None, epoch_length=7,
                 check_signatures=False)
    calls = []

    def conf(*a, **k):
        calls.append(("conf", a))
        return accept

    def anon(*a, **k):
        calls.append(("anon", a))
        return accept

    rt.zk_system.verify_confidential_proof = conf
    rt.zk_system.verify_anonymous_proof = anon
    rt._calls = calls
    rt.set_block(0)
    return rt


def _addr(seed: bytes) -> EncKey:
    return EncKey.from_point(EncryptionKey.from_seed(seed).point)


def _ct_parts(amount, randomness, seed):
    ek = EncryptionKey.from_seed(seed)
    ct = Ciphertext.encrypt(amount, randomness, ek)
    return (
        LeftCiphertext.from_point(ct.left),
        RightCiphertext.from_point(ct.right),
    )


def _nonce(i: int) -> Nonce:
    return Nonce.from_point(
        jj.mul(jj.generator(jj.NOTE_COMMITMENT_RANDOMNESS), 3 + i)
    )


_PROOF = ProofBytes(bytes(192))
_RVK = SigVerificationKey(bytes(32))


def test_encrypted_assets_issue_transfer_destroy():
    rt = _runtime()
    ea = rt.encrypted_assets
    alice = _addr(b"assets alice")
    bob = _addr(b"assets bob")

    total_l, rand_r = _ct_parts(100, 5, b"assets alice")
    aid = ea.issue(_RVK, _PROOF, alice, total_l, total_l, total_l,
                   rand_r, _nonce(0))
    assert aid == 0
    assert (aid, alice.data) in ea.encrypted_balance
    assert ea.total_supply[aid].data == (total_l.data + rand_r.data)
    # second asset class gets a fresh id
    aid2 = ea.issue(_RVK, _PROOF, alice, total_l, total_l, total_l,
                    rand_r, _nonce(1))
    assert aid2 == 1

    # transfer within asset 0: sender loses amount+fee, recipient pends
    amt_l, r_r = _ct_parts(10, 7, b"assets alice")
    fee_l, _ = _ct_parts(1, 7, b"assets alice")
    before = ea.encrypted_balance[(0, alice.data)]
    ea.confidential_transfer(
        _RVK, 0, _PROOF, alice, bob, amt_l, amt_l, fee_l, r_r, _nonce(2)
    )
    moved = CiphertextBytes.from_left_right(amt_l, r_r).add(
        CiphertextBytes.from_left_right(fee_l, r_r)
    )
    assert ea.encrypted_balance[(0, alice.data)].data == before.sub(
        moved
    ).data
    assert (0, bob.data) in ea.pending_transfer
    # asset-1 balances untouched (per-(asset, key) storage)
    assert ea.encrypted_balance[(1, alice.data)].data == (
        total_l.data + rand_r.data
    )

    # destroy asset 0 for alice: storage entries removed
    ea.destroy(_RVK, _PROOF, alice, 0, amt_l, fee_l, amt_l, r_r,
               _nonce(3))
    assert (0, alice.data) not in ea.encrypted_balance
    assert ea.events[-1][0] == "Destroyed"


def test_encrypted_assets_per_asset_rollover():
    """Pending transfers roll into the balance per (asset, key) when the
    epoch advances (lib.rs:266 semantics)."""
    rt = _runtime()
    ea = rt.encrypted_assets
    bob = _addr(b"rollover bob")
    amt_l, r_r = _ct_parts(10, 3, b"rollover bob")
    pend = CiphertextBytes.from_left_right(amt_l, r_r)
    ea.pending_transfer[(0, bob.data)] = pend
    ea.pending_transfer[(1, bob.data)] = pend.add(pend)

    rt.set_block(7)  # epoch 1
    ea.rollover(bob, 0)
    assert ea.encrypted_balance[(0, bob.data)].data == pend.data
    assert (0, bob.data) not in ea.pending_transfer
    # asset 1 not rolled yet
    assert (1, bob.data) in ea.pending_transfer
    # idempotent within the epoch
    ea.rollover(bob, 0)
    assert ea.encrypted_balance[(0, bob.data)].data == pend.data


def test_encrypted_assets_wrong_proof_rejected():
    rt = _runtime(accept=False)
    ea = rt.encrypted_assets
    alice = _addr(b"reject alice")
    total_l, rand_r = _ct_parts(50, 9, b"reject alice")
    with pytest.raises(DispatchError):
        ea.issue(_RVK, _PROOF, alice, total_l, total_l, total_l, rand_r,
                 _nonce(0))
    assert ("InvalidZkProof",) in ea.events
    assert not ea.encrypted_balance  # nothing minted
    assert not rt.zk_system.nonce_pool  # nonce NOT consumed


def test_anonymous_balances_dispatch():
    rt = _runtime()
    ab = rt.anonymous_balances
    keys = [_addr(f"anon member {i}".encode()) for i in range(12)]
    issuer = keys[0]
    total_l, rand_r = _ct_parts(100, 11, b"anon member 0")
    ab.issue(_RVK, _PROOF, issuer, total_l, total_l, total_l, rand_r,
             _nonce(0))
    assert ab.encrypted_balance[issuer.data].data == (
        total_l.data + rand_r.data
    )

    lefts = [
        _ct_parts(0 if i > 1 else 10, 13, f"anon member {i}".encode())[0]
        for i in range(12)
    ]
    right = _ct_parts(10, 13, b"anon member 0")[1]
    ab.anonymous_transfer(_RVK, _PROOF, keys, lefts, right, _nonce(1))
    # EVERY member of the set received a pending delta
    for i, k in enumerate(keys):
        assert ab.pending_transfer[k.data].data == (
            lefts[i].data + right.data
        )
    assert ab.events[-1][0] == "AnonymousTransfer"

    # mismatched lengths rejected before any verification
    with pytest.raises(DispatchError):
        ab.anonymous_transfer(_RVK, _PROOF, keys, lefts[:11], right,
                              _nonce(2))

    # epoch advance merges pending into balances
    rt.set_block(7)
    ab.rollover(keys[3])
    assert ab.encrypted_balance[keys[3].data].data == (
        lefts[3].data + right.data
    )
    assert keys[3].data not in ab.pending_transfer


def test_zk_gated_dispatch_real_verifier():
    """Dispatch with REAL Groth16 verification deciding accept/reject:
    the committed MiniCommit fixture proof passes the gate and mutates
    storage; a corrupted proof byte is rejected by the PAIRING CHECK
    (not a stub) and storage stays untouched."""
    from zerochain_tpu_torch.groth16.core import (
        prepare_verifying_key, verify_proof,
    )
    from zerochain_tpu_torch.groth16.serialization import (
        proof_from_bytes, vk_from_bytes,
    )

    vk = vk_from_bytes(open(os.path.join(VEC, "mini_vk.dat"), "rb").read())
    pvk = prepare_verifying_key(vk)
    proof_bytes = open(os.path.join(VEC, "mini_proof.dat"), "rb").read()
    pub = [int(x) for x in json.loads(
        open(os.path.join(VEC, "mini_public_inputs.json")).read()
    )]

    rt = Runtime(confidential_vk=pvk, epoch_length=7,
                 check_signatures=False)
    rt.set_block(0)

    def gate(zkproof, *args, **kwargs):
        try:
            proof = proof_from_bytes(zkproof.data)
        except Exception:
            return False
        return verify_proof(rt.zk_system.confidential_vk, proof, pub)

    rt.zk_system.verify_confidential_proof = gate
    ea = rt.encrypted_assets
    alice = _addr(b"real alice")
    total_l, rand_r = _ct_parts(40, 21, b"real alice")

    aid = ea.issue(_RVK, ProofBytes(proof_bytes), alice, total_l,
                   total_l, total_l, rand_r, _nonce(0))
    assert (aid, alice.data) in ea.encrypted_balance

    bad = bytearray(proof_bytes)
    bad[5] ^= 0x40  # corrupt a coordinate bit (stays decodable or not —
    # either way the gate must reject)
    with pytest.raises(DispatchError):
        ea.issue(_RVK, ProofBytes(bytes(bad)), alice, total_l, total_l,
                 total_l, rand_r, _nonce(1))
    assert ea.next_asset_id == aid + 1  # no second mint


# ------------------------------------------- against the JAX package's bytes
def _typed_args(prim, names, kinds, rng):
    """Seeded call arguments wrapped in the primitives of one package."""
    h256 = {
        "address_sender": prim.EncKey, "address_recipient": prim.EncKey,
        "issuer": prim.EncKey, "owner": prim.EncKey,
        "randomness": prim.RightCiphertext,
        "right_ciphertext": prim.RightCiphertext, "nonce": prim.Nonce,
    }
    out = {}
    for name, kind in zip(names, kinds):
        if kind == "h256":
            out[name] = h256.get(name, prim.LeftCiphertext)(rng.bytes(32))
        elif kind == "vecu8":
            out[name] = (prim.ProofBytes(rng.bytes(192)) if name == "zkproof"
                         else prim.CiphertextBytes(rng.bytes(64)))
        elif kind == "vec_h256":
            wrap = prim.EncKey if name == "enc_keys" else prim.LeftCiphertext
            out[name] = [wrap(rng.bytes(32)) for _ in range(12)]
        else:
            out[name] = int(rng.integers(0, 1 << 32))
    return out


def _pair(call, seed):
    """The same signed extrinsic built by each package: (port, JAX)."""
    import numpy as np

    from zerochain_tpu.runtime import chain as jchain
    from zerochain_tpu.runtime import primitives as jprim
    from zerochain_tpu_torch.runtime import primitives as tprim

    _, names, kinds = scale.CALL_SPECS[call]
    rsk = 0xC0FFEE + seed
    rvk = jj.to_bytes(jj.mul(jj.generator(jj.NOTE_COMMITMENT_RANDOMNESS), rsk))
    t = bytes(np.random.default_rng(seed).integers(0, 256, 80, dtype=np.uint8))
    xts = []
    for prim, cls in ((tprim, Extrinsic), (jprim, jchain.Extrinsic)):
        args = _typed_args(prim, names, kinds, np.random.default_rng(seed))
        xts.append(cls(*call, args, prim.SigVerificationKey(rvk),
                       nonce_index=seed).sign(rsk, t=t))
    return xts


@pytest.mark.parametrize("call", sorted(scale.CALL_SPECS))
def test_extrinsic_bytes_equal_jax(call):
    from zerochain_tpu.runtime import chain as jchain

    port, ref = _pair(call, seed=7 + sorted(scale.CALL_SPECS).index(call))
    wire = port.encode()
    assert wire == ref.encode()
    assert port.payload() == ref.payload()
    # each side decodes the other's bytes and re-encodes them unchanged
    from_ref = Extrinsic.decode(ref.encode())
    from_port = jchain.Extrinsic.decode(wire)
    assert from_ref.encode() == wire and from_port.encode() == wire
    assert (from_ref.module, from_ref.method) == call
    assert from_port.payload() == port.payload()
    assert from_ref.signature.rbar + from_ref.signature.sbar == (
        ref.signature.rbar + ref.signature.sbar)
