"""The port's tower and pairing (ec/tower.py, ec/pairing.py) on the CPU,
where every field op is its kernel's plain version, against the port's
mirror, which tests/test_mirror_pairing.py pins to RELIC's golden vector."""

import numpy as np
import pytest
import torch

from tests.test_mirror_pairing import RELIC
from zerochain_tpu_torch.ec import pairing as DP
from zerochain_tpu_torch.ec import tower as T
from zerochain_tpu_torch.mirror import curves as C
from zerochain_tpu_torch.mirror import field as mf
from zerochain_tpu_torch.mirror import pairing as P

BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the plain field ops run many small tensor ops: OpenMP threads only
    # contend for the cores (and with the other test workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fq(rng, k):
    """k elements of Fq from 64-bit draws (uniform enough, exact ints)."""
    words = rng.integers(0, 1 << 63, size=(k, 6), dtype=np.int64)
    return [sum(int(w) << (64 * i) for i, w in enumerate(row)) % mf.Q for row in words]


def _fq12s(rng, n):
    v = iter(_fq(rng, 12 * n))
    return [tuple(tuple((next(v), next(v)) for _ in range(3)) for _ in range(2))
            for _ in range(n)]


@pytest.fixture(scope="module")
def elems():
    rng = np.random.default_rng(20261018)
    a, b = _fq12s(rng, BATCH), _fq12s(rng, BATCH)
    a[0] = mf.FQ12_ONE
    return a, b, T.fq12_from_ints(a, "cpu"), T.fq12_from_ints(b, "cpu")


def test_fq12_codec_round_trip(elems):
    a, _, ta, _ = elems
    assert tuple(ta.shape) == (12, 2, 3, 2, BATCH)
    assert T.fq12_to_ints(ta) == a


@pytest.mark.parametrize("op", ["mul", "sqr", "inv", "conj"])
def test_fq12_ops_match_mirror(elems, op):
    a, b, ta, tb = elems
    if op == "mul":
        got, want = T.fq12_mul(ta, tb), [mf.fq12_mul(x, y) for x, y in zip(a, b)]
    else:
        got = getattr(T, "fq12_" + op)(ta)
        want = [getattr(mf, "fq12_" + op)(x) for x in a]
    assert T.fq12_to_ints(got) == want


@pytest.mark.parametrize("power", [1, 2, 3])
def test_fq12_frobenius_matches_mirror(elems, power):
    a, _, ta, _ = elems
    assert T.fq12_to_ints(T.fq12_frobenius(ta, power)) == [
        mf.fq12_frobenius(x, power) for x in a]


def test_fq12_mul_by_014_matches_mirror(elems):
    a, b, ta, tb = elems
    c0, c1, c4 = (tb[:, :, i, 0] for i in range(3))  # any three Fq2 batches
    want = [mf.fq12_mul_by_014(x, y[0][0], y[0][1], y[0][2]) for x, y in zip(a, b)]
    assert T.fq12_to_ints(T.fq12_mul_by_014(ta, c0, c1, c4)) == want


def test_pairing_relic():
    assert DP.pairing_host(C.G1_GEN, C.G2_GEN, device="cpu") == RELIC


def test_pairing_bilinearity():
    """e(aP, bQ) == e(abP, Q), both pairs in one batched call, and equal to
    the mirror on the non-generator pair."""
    a, b = 0x1234567, 0x89ABCDE
    pa = C.g1_mul(C.G1_GEN, a)
    qb = C.g2_mul(C.G2_GEN, b)
    pab = C.g1_mul(C.G1_GEN, a * b)
    got = DP.pairing_host_batch([pa, pab], [qb, C.G2_GEN], device="cpu")
    assert got[0] == got[1]
    assert got[0] == P.pairing(pa, qb)


def test_three_pair_miller_loop_then_final_exponentiation():
    """One multi-pair Miller loop over three (P, Q), then one final
    exponentiation: the mirror's product of three pairings' Miller values."""
    ps = [C.g1_mul(C.G1_GEN, k) for k in (3, 0x10001, 0xDEADBEEF)]
    qs = [C.g2_mul(C.G2_GEN, k) for k in (5, 0xABCDEF, 77)]
    pairs = []
    for p, q in zip(ps, qs):
        px, py = DP.g1_tensors([p], "cpu")
        qx, qy = DP.g2_tensors([q], "cpu")
        pairs.append(((px, py), DP.g2_prepare(qx, qy)))
    f = DP.miller_loop(pairs)
    want = P.miller_loop(list(zip(ps, qs)))
    assert T.fq12_to_ints(f) == [want]
    assert T.fq12_to_ints(DP.final_exponentiation(f)) == [P.final_exponentiation(want)]


def test_schedule():
    assert len(DP._SCHED) == 62 and sum(DP._SCHED) == 5
    assert bin(mf.BLS_X).count("1") == 6
