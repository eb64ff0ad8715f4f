"""The port's batch RedJubjub verification against the JAX package's
(``zerochain_tpu.protocol.redjubjub.batch_verify_device``) at N = 16: the
same verdicts, and the 48 terms' scalar multiplies of the port's var chain
(its plain version, on the CPU) equal to the JAX ``scalar_mul_bits``."""

import numpy as np
import pytest
import torch

from zerochain_tpu.ec import jubjub as jej
from zerochain_tpu.protocol import redjubjub as jrj
from zerochain_tpu_torch.ec import cuda_jubjub
from zerochain_tpu_torch.ec import jubjub as ej
from zerochain_tpu_torch.ff import limbs as L
from zerochain_tpu_torch.mirror.field import S
from zerochain_tpu_torch.protocol import redjubjub as rj
from zerochain_tpu_torch.protocol import redjubjub_device as rjd

N = 16
ZS = [5 + 7 * i for i in range(N)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sigs(mod, n, tamper_at=None):
    entries = []
    for i in range(n):
        sk = mod.PrivateKey(
            int.from_bytes(f"batch-sk-{i}".encode().ljust(16, b"\0"), "little"))
        msg = f"message-{i}".encode()
        sig = sk.sign(msg, t=bytes(((i + j) % 251 for j in range(80))))
        entries.append((sk.public_key(), b"tampered" if i == tamper_at else msg,
                        sig))
    return entries


def _bad_s(mod):
    entries = _sigs(mod, N)
    pk, msg, sig = entries[3]
    entries[3] = (pk, msg, mod.Signature(sig.rbar, (S + 1).to_bytes(32, "little")))
    return entries


CASES = {
    "valid": (lambda mod: _sigs(mod, N), True),
    "tampered": (lambda mod: _sigs(mod, N, tamper_at=7), False),
    "bad_s": (_bad_s, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_verdict_matches_jax(case):
    make, want = CASES[case]
    got = rjd.batch_verify_device(make(rj), rand_scalars=ZS, device="cpu")
    jgot = jrj.batch_verify_device(make(jrj), rand_scalars=ZS)
    assert got == jgot == want


def test_term_multiplies_match_jax_scalar_mul_bits():
    """Every term z R_i, c z vk_i, -s z P_G of the tampered batch: the port's
    var chain (last step, projective) and the JAX 252-step double-and-add
    (extended) name the same affine points."""
    pts, scalars = rjd._terms(_sigs(rj, N, tamper_at=7), rj.DEFAULT_BASE, ZS)
    m = len(pts)
    bases, bits = rjd._chain_inputs(pts, scalars, "cpu")
    _, res = cuda_jubjub.var_chain(bases, bits)
    X, Y, Z = res[:, :, -1]
    zi = L.FR.to_ints(Z, mont=True)
    got = [(x * pow(z, -1, L.FR.p) % L.FR.p, y * pow(z, -1, L.FR.p) % L.FR.p)
           for x, y, z in zip(L.FR.to_ints(X, mont=True), L.FR.to_ints(Y, mont=True), zi)]
    jbits = np.ascontiguousarray(bits.numpy().astype(np.int32))
    jmul = jej.scalar_mul_bits(jej.to_extended(pts, batch_shape=(m,)), jbits)
    assert got == jej.to_affine_host(jmul)
    # and the port's extended form of them, as the tree takes it
    ext = ej.to_affine_host(tuple(ej.mul(torch.stack([X, Y, Z, X], 1),
                                         torch.stack([Z, Z, Z, Y], 1)).unbind(1)))
    assert ext == got
