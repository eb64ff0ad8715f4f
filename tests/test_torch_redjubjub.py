"""RedJubjub in the port: the batch verifier's device path on the CPU (the
var_chain kernel's plain version, then the tree of adds) against the host
loop and the mirror, and the host API against the JAX package's bytes."""

import pytest
import torch

from zerochain_tpu_torch.ec import jubjub as ej
from zerochain_tpu_torch.mirror import jubjub as jj
from zerochain_tpu_torch.mirror.field import S
from zerochain_tpu_torch.protocol import redjubjub as rj
from zerochain_tpu_torch.protocol import redjubjub_device as rjd
from zerochain_tpu_torch.protocol.redjubjub import (
    PrivateKey, PublicKey, Signature, batch_verify,
)
from zerochain_tpu_torch.protocol.redjubjub_device import batch_verify_device


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the plain field ops run many small tensor ops: OpenMP threads only
    # contend for the cores (and with the other test workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sigs(n, tamper_at=None, key=PrivateKey):
    entries = []
    for i in range(n):
        sk = key(int.from_bytes(f"batch-sk-{i}".encode().ljust(16, b"\0"), "little"))
        msg = f"message-{i}".encode()
        sig = sk.sign(msg, t=bytes(((i + j) % 251 for j in range(80))))
        if tamper_at == i:
            msg = b"tampered"
        entries.append((sk.public_key(), msg, sig))
    return entries


def test_batch_verify_device_128():
    n = 128
    entries = _sigs(n)
    zs = [3 + 11 * i for i in range(n)]
    assert batch_verify(entries, rand_scalars=zs)
    assert batch_verify_device(entries, rand_scalars=zs, device="cpu")


def test_batch_verify_device_rejects_tampered():
    n = 16
    entries = _sigs(n, tamper_at=7)
    zs = [5 + 7 * i for i in range(n)]
    assert not batch_verify(entries, rand_scalars=zs)
    assert not batch_verify_device(entries, rand_scalars=zs, device="cpu")


def test_batch_verify_device_rejects_bad_s():
    entries = _sigs(2)
    pk, msg, sig = entries[1]
    bad = Signature(sig.rbar, (S + 1).to_bytes(32, "little"))
    assert not batch_verify([entries[0], (pk, msg, bad)], rand_scalars=[1, 2])
    assert not batch_verify_device([entries[0], (pk, msg, bad)], device="cpu")


def test_batch_verify_device_rejects_undecodable_r():
    entries = _sigs(3)
    pk, msg, sig = entries[2]
    bad = Signature((2).to_bytes(32, "little"), sig.sbar)  # y = 2: no x
    with pytest.raises(jj.DecodeError):
        jj.from_bytes(bad.rbar)
    assert not batch_verify_device(entries[:2] + [(pk, msg, bad)], device="cpu")


def test_empty_batch_is_accepted():
    assert batch_verify_device([], device="cpu")


@pytest.mark.parametrize("tamper_at", [None, 7])
def test_device_total_is_the_mirror_sum(tamper_at):
    """The sum before the cofactor, as a point: the 48 terms of 16
    signatures (valid, or one tampered: then the sum is not the identity)."""
    n = 16
    entries = _sigs(n, tamper_at=tamper_at)
    zs = [5 + 7 * i for i in range(n)]
    pts, scalars = rjd._terms(entries, rj.DEFAULT_BASE, zs)
    assert len(pts) == 3 * n
    total = rjd._device_total(*rjd._chain_inputs(pts, scalars, "cpu"))
    want = jj.ZERO
    for p, s in zip(pts, scalars):
        want = jj.add(want, jj.mul(p, s))
    got = ej.to_affine_host(tuple(a[:, None] for a in total))[0]
    assert got == want
    assert (jj.mul_by_cofactor(want) == jj.ZERO) == (tamper_at is None)


def test_chain_bits_are_the_scalars():
    scalars = [0, 1, S - 1, 0x123456789ABCDEF << 180]
    pts = [jj.generator(rj.DEFAULT_BASE)] * 4
    _, bits = rjd._chain_inputs(pts, scalars, "cpu")
    assert tuple(bits.shape) == (rjd.N_BITS, 4)
    for j, v in enumerate(scalars):
        assert sum(int(b) << k for k, b in enumerate(bits[:, j].tolist())) == v


def test_host_api_matches_jax():
    """h_star, sign with a fixed t, public_key, randomize and the byte codecs
    give the JAX package's bytes and points on 8 keys."""
    from zerochain_tpu.protocol import redjubjub as jrj

    for i in range(8):
        x = (0xC0FFEE + 977 * i) ** 5 % S
        msg = f"extrinsic-{i}".encode()
        t = bytes((7 * i + j) % 256 for j in range(80))
        alpha = (i + 1) * 0x1234567 % S
        sk, jsk = PrivateKey(x), jrj.PrivateKey(x)
        assert rj.h_star(msg, t) == jrj.h_star(msg, t)
        for base in (rj.DEFAULT_BASE, jj.NOTE_COMMITMENT_RANDOMNESS):
            sig = sk.sign(msg, base_index=base, t=t)
            jsig = jsk.sign(msg, base_index=base, t=t)
            assert sig.to_bytes() == jsig.to_bytes()
            vk = sk.public_key(base)
            assert vk.point == jsk.public_key(base).point
            assert vk.to_bytes() == jsk.public_key(base).to_bytes()
            assert vk.verify(msg, sig, base_index=base)
            rvk = vk.randomize(alpha, base)
            assert rvk.point == jsk.public_key(base).randomize(alpha, base).point
            rsk = sk.randomize(alpha)
            assert rsk.fs == jsk.randomize(alpha).fs
            assert rsk.public_key(base).point == rvk.point
        assert Signature.from_bytes(sig.to_bytes()) == sig
        assert PrivateKey.from_bytes(sk.to_bytes()) == sk
        assert sk.to_bytes() == jsk.to_bytes()
        assert PublicKey.from_bytes(vk.to_bytes()).point == vk.point
