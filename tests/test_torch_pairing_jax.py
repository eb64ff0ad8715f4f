"""The port's tower and pairing against the JAX package's
(``zerochain_tpu.ec.tower``, ``zerochain_tpu.ec.pairing``): the Fq12 ops at
batch 4 on the same elements (the JAX limb arrays carried over by
``convert.fq12_from_ref``), and the Miller loop and the whole pairing on one
non-generator pair, compared as canonical integers.

The JAX Miller loop and final exponentiation compile for many minutes on a
CPU (the loop's scan over the line products; the per-op jits and power
scans), and the JAX tower runs eagerly, op by op, at 20-150 s an Fq12
operation; so what runs always is the Fq12 multiply, conjugation and
Frobenius map and the G2 preparation (its scan compiles in under a minute),
coefficient for coefficient.  The other tower ops, one doubling and one
addition step, the Miller loop and the whole pairing wait behind
ZEROCHAIN_PAIRING=1."""

import os

import numpy as np
import pytest
import torch

from zerochain_tpu.ec import fields as JF
from zerochain_tpu.ec import pairing as JP
from zerochain_tpu.ec import tower as JT
from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ec import pairing as DP
from zerochain_tpu_torch.ec import tower as T
from zerochain_tpu_torch.ff import limbs as L
from zerochain_tpu_torch.mirror import curves as C
from zerochain_tpu_torch.mirror import field as mf

BATCH = 4
A, B = 0x1234567, 0x89ABCDE


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_fq12(vals):
    """Host Fq12 values -> the JAX package's nested limb arrays (32, len)."""
    return tuple(tuple(tuple(JF.FqOps.from_ints([v[h][i][c] for v in vals])
                             for c in range(2)) for i in range(3))
                 for h in range(2))


def _jax_ints(a, n):
    return [JT.fq12_to_ints(a, k) for k in range(n)]


@pytest.fixture(scope="module")
def elems():
    rng = np.random.default_rng(8)
    words = rng.integers(0, 1 << 63, size=(2 * BATCH * 12, 6), dtype=np.int64)
    v = iter([sum(int(w) << (64 * i) for i, w in enumerate(row)) % mf.Q
              for row in words])
    vals = [tuple(tuple((next(v), next(v)) for _ in range(3)) for _ in range(2))
            for _ in range(2 * BATCH)]
    ja, jb = _jax_fq12(vals[:BATCH]), _jax_fq12(vals[BATCH:])
    return ja, jb, convert.fq12_from_ref(ja), convert.fq12_from_ref(jb)


def test_fq12_from_ref_is_the_values(elems):
    ja, _, ta, _ = elems
    assert T.fq12_to_ints(ta) == _jax_ints(ja, BATCH)


def _tower_case(elems, op):
    ja, jb, ta, tb = elems
    if op == "mul":
        got, want = T.fq12_mul(ta, tb), JT.fq12_mul(ja, jb)
    elif op.startswith("frobenius"):
        k = int(op[-1])
        got, want = T.fq12_frobenius(ta, k), JT.fq12_frobenius(ja, k)
    elif op == "mul_by_014":
        got = T.fq12_mul_by_014(ta, tb[:, :, 0, 0], tb[:, :, 1, 0], tb[:, :, 2, 1])
        want = JT.fq12_mul_by_014(ja, jb[0][0], jb[0][1], jb[1][2])
    else:
        got, want = getattr(T, "fq12_" + op)(ta), getattr(JT, "fq12_" + op)(ja)
    assert T.fq12_to_ints(got) == _jax_ints(want, BATCH)


@pytest.mark.parametrize("op", ["mul", "conj", "frobenius1"])
def test_tower_op_matches_jax(elems, op):
    _tower_case(elems, op)


@pytest.mark.parametrize("op", ["sqr", "inv", "frobenius2", "frobenius3",
                                "mul_by_014"])
def test_tower_op_matches_jax_gated(elems, op):
    """The JAX package runs these eagerly here, op by op: 20-150 s each on
    a CPU, so they wait behind ZEROCHAIN_PAIRING=1 (the port's side of every
    one is held against the mirror in tests/test_torch_pairing.py)."""
    _gated()
    _tower_case(elems, op)


def _pair():
    return C.g1_mul(C.G1_GEN, A), C.g2_mul(C.G2_GEN, B)


def _gated():
    if not os.environ.get("ZEROCHAIN_PAIRING"):
        pytest.skip("set ZEROCHAIN_PAIRING=1 to compile the JAX Miller loop and "
                    "final exponentiation (many minutes on a CPU)")


def _fq2_ints(x, k=None):
    """A JAX Fq2 (pair of limb arrays, step axis first when k is given) ->
    [(c0, c1), ...] over the batch."""
    c0, c1 = (np.asarray(c if k is None else c[k]) for c in x)
    return T.fq2_to_ints(torch.stack([convert.from_ref_limbs(L.FQ, c0, True),
                                      convert.from_ref_limbs(L.FQ, c1, True)], 1))


def _coeff_ints(t):
    """The port's (12, 2, 3, *batch) coefficients -> three Fq2 int lists."""
    return [T.fq2_to_ints(t[:, :, j]) for j in range(3)]


def test_g2_prepare_matches_jax():
    """All 62 doubling steps' line coefficients, the 5 addition steps' and the
    last doubling's equal the JAX scan's."""
    _, q = _pair()
    jd, ja, jf = JP._g2_prepare_j(JF.Fq2Ops.from_ints([q[0]]), JF.Fq2Ops.from_ints([q[1]]))
    dbl, add, final = DP.g2_prepare(*DP.g2_tensors([q], "cpu"))
    assert len(dbl) == len(add) == 62
    for k, bit in enumerate(DP._SCHED):
        assert _coeff_ints(dbl[k]) == [_fq2_ints(c, k) for c in jd]
        if bit:
            assert _coeff_ints(add[k]) == [_fq2_ints(c, k) for c in ja]
        else:
            assert add[k] is None
    assert _coeff_ints(final) == [_fq2_ints(c) for c in jf]


def test_miller_steps_match_jax():
    """One doubling and one addition step on random R, Q at batch 4 (the JAX
    steps eagerly: about 90 s on a CPU)."""
    _gated()
    rng = np.random.default_rng(81)
    words = rng.integers(0, 1 << 63, size=(5 * 2 * BATCH, 6), dtype=np.int64)
    vals = [sum(int(w) << (64 * i) for i, w in enumerate(row)) % mf.Q for row in words]
    fq2s = [list(zip(vals[2 * k * BATCH:(2 * k + 1) * BATCH],
                     vals[(2 * k + 1) * BATCH:(2 * k + 2) * BATCH])) for k in range(5)]
    jr = [JF.Fq2Ops.from_ints(v) for v in fq2s]
    tr = [T.fq2_from_ints(v, "cpu") for v in fq2s]
    r = torch.stack(tr[:3], 2)
    (jnr, jc) = JP._doubling_step(*jr[:3])
    nr, c = DP._doubling_step(r)
    assert _coeff_ints(nr) == [_fq2_ints(x) for x in jnr]
    assert _coeff_ints(c) == [_fq2_ints(x) for x in jc]
    (jnr, jc) = JP._addition_step(*jr)
    nr, c = DP._addition_step(r, tr[3], tr[4])
    assert _coeff_ints(nr) == [_fq2_ints(x) for x in jnr]
    assert _coeff_ints(c) == [_fq2_ints(x) for x in jc]


def test_miller_loop_matches_jax():
    _gated()
    p, q = _pair()
    coeffs = JP._g2_prepare_j(JF.Fq2Ops.from_ints([q[0]]), JF.Fq2Ops.from_ints([q[1]]))
    want = JP._miller_one_j(JF.FqOps.from_ints([p[0]]), JF.FqOps.from_ints([p[1]]),
                            coeffs)
    px, py = DP.g1_tensors([p], "cpu")
    qx, qy = DP.g2_tensors([q], "cpu")
    got = DP.miller_loop([((px, py), DP.g2_prepare(qx, qy))])
    assert T.fq12_to_ints(got) == _jax_ints(want, 1)


def test_pairing_host_matches_jax():
    _gated()
    p, q = _pair()
    assert DP.pairing_host(p, q, device="cpu") == JP.pairing_host(p, q)
