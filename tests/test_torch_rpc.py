"""The port's JSON-RPC boundary: tests/test_rpc.py's client/server round
trip over the port's runtime, driven by the port's RpcClient and by the JAX
package's (the wire format is shared)."""

import pytest

from zerochain_tpu_torch.mirror import jubjub as jj
from zerochain_tpu_torch.protocol.elgamal import Ciphertext
from zerochain_tpu_torch.protocol.keys import (
    EncryptionKey,
    ProofGenerationKey,
    SpendingKey,
)
from zerochain_tpu_torch.rpc import RpcClient, RpcServer
from zerochain_tpu_torch.runtime import Runtime
from zerochain_tpu_torch.runtime.chain import Extrinsic
from zerochain_tpu_torch.runtime.primitives import (
    CiphertextBytes,
    EncKey,
    LeftCiphertext,
    Nonce,
    ProofBytes,
    RightCiphertext,
    SigVerificationKey,
)


@pytest.fixture(params=["port", "jax"])
def rpc(request):
    if request.param == "jax":
        from zerochain_tpu.rpc import RpcClient as Client
    else:
        Client = RpcClient
    rt = Runtime(confidential_vk=None, epoch_length=7)
    rt.zk_system.verify_confidential_proof = lambda *a, **k: True
    rt.set_block(10)
    server = RpcServer(rt).start()
    client = Client(f"http://127.0.0.1:{server.port}")
    yield rt, client
    server.stop()


def test_rpc_flow(rpc):
    rt, api = rpc
    assert api.get_block_number() == 10
    assert api.get_genesis_blockhash() == bytes(32)

    sk = SpendingKey.from_seed(b"rpc alice")
    pgk = ProofGenerationKey.from_spending_key(sk)
    dk = pgk.into_decryption_key()
    ek = EncryptionKey.from_decryption_key(dk)
    alice = EncKey.from_point(ek.point)
    bob = EncKey.from_point(EncryptionKey.from_seed(b"rpc bob").point)

    ct = Ciphertext.encrypt(50, 3, ek)
    rt.encrypted_balances.encrypted_balance[alice.data] = CiphertextBytes(
        jj.to_bytes(ct.left) + jj.to_bytes(ct.right)
    )

    # storage read over RPC
    stored = api.get_storage("encrypted_balances", "encrypted_balance",
                             key=alice.data)
    assert bytes.fromhex(stored) == (
        jj.to_bytes(ct.left) + jj.to_bytes(ct.right)
    )

    alpha = 5
    rvk = SigVerificationKey.from_point(pgk.into_rvk(alpha))
    assert api.get_nonce(rvk.data) == 0

    amt = Ciphertext.encrypt(7, 99, ek)
    amt_r = Ciphertext.encrypt(7, 99, EncryptionKey.from_seed(b"rpc bob"))
    fee = Ciphertext.encrypt(1, 99, ek)
    nonce_pt = jj.mul(jj.find_group_hash(b"\x01\x00\x00\x00", b"zcgepoch"),
                      dk.fs)
    xt = Extrinsic(
        module="encrypted_balances",
        method="confidential_transfer",
        args=dict(
            zkproof=ProofBytes(b"\x80" + bytes(47) + b"\x80" + bytes(95)
                               + b"\x80" + bytes(47)),
            address_sender=alice,
            address_recipient=bob,
            amount_sender=LeftCiphertext.from_point(amt.left),
            amount_recipient=LeftCiphertext.from_point(amt_r.left),
            fee_sender=LeftCiphertext.from_point(fee.left),
            randomness=RightCiphertext.from_point(amt.right),
            nonce=Nonce.from_point(nonce_pt),
        ),
        rvk=rvk,
    ).sign(sk.into_rsk(alpha))

    assert api.submit_extrinsic(xt) == "ok"
    assert api.get_nonce(rvk.data) == 1
    bal = api.get_storage("encrypted_balances", "pending_transfer",
                          key=bob.data)
    assert bal is not None  # bob has a pending transfer

    # a bad signature is rejected server-side
    xt2 = Extrinsic(
        module="encrypted_balances", method="confidential_transfer",
        args=xt.args, rvk=rvk, nonce_index=1,
    )
    xt2.signature = xt.signature
    with pytest.raises(RuntimeError):
        api.submit_extrinsic(xt2)
