"""The pairing's program sets (ec/cuda_pairing.py, the programs that
csrc/pairing_kernel.cu runs) on the CPU, where ``execute`` runs their plain
interpreter: against the tower chain of field kernels (ec/pairing.py:
*_tower, their plain versions here) and the mirror, which
tests/test_mirror_pairing.py pins to RELIC's golden vector; the G2
preparation against the JAX package's; and the sets' own checks.  All
comparisons are exact (field words, tolerance 0).

The JAX Miller loop and pairing compile for many minutes on a CPU: their
comparisons with the tower chain wait behind ZEROCHAIN_PAIRING=1, as in
tests/test_torch_pairing_jax.py (whose gated tests hold the JAX package
against the program sets)."""

import os

import numpy as np
import pytest
import torch

from tests.test_mirror_pairing import RELIC
from zerochain_tpu.ec import fields as JF
from zerochain_tpu.ec import pairing as JP
from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ec import cuda_pairing as CP
from zerochain_tpu_torch.ec import pairing as DP
from zerochain_tpu_torch.ec import tower as T
from zerochain_tpu_torch.ff import limbs as L
from zerochain_tpu_torch.mirror import curves as C
from zerochain_tpu_torch.mirror import pairing as P


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scalars(seed, n):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(2, 1 << 62, size=n)]


def _both(ps, qs):
    """e(P_i, Q_i) through the program sets and through the tower chain."""
    (px, py), (qx, qy) = DP.g1_tensors(ps, "cpu"), DP.g2_tensors(qs, "cpu")
    return (T.fq12_to_ints(DP.pairing(px, py, qx, qy)),
            T.fq12_to_ints(DP.pairing_tower(px, py, qx, qy)))


def test_relic():
    got, tower = _both([C.G1_GEN], [C.G2_GEN])
    assert got == tower == [RELIC]


def test_bilinearity():
    """e(aP, bQ) == e(abP, Q) == e(P, Q)^(ab), both pairs in one call."""
    a, b = _scalars(11, 2)
    pa, qb = C.g1_mul(C.G1_GEN, a), C.g2_mul(C.G2_GEN, b)
    got, tower = _both([pa, C.g1_mul(C.G1_GEN, a * b)], [qb, C.G2_GEN])
    assert got == tower
    assert got[0] == got[1] == P.pairing(pa, qb)


def test_four_non_generator_pairs():
    ks = _scalars(14, 8)
    ps = [C.g1_mul(C.G1_GEN, k) for k in ks[:4]]
    qs = [C.g2_mul(C.G2_GEN, k) for k in ks[4:]]
    got, tower = _both(ps, qs)
    assert got == tower == [P.pairing(p, q) for p, q in zip(ps, qs)]


def test_three_pair_miller_loop_then_final_exponentiation():
    """g2_prepare of each Q, one Miller loop over the three pairs (one
    launch of the "loop" set), one final exponentiation; the tower chain's
    and the mirror's values at each step."""
    ps = [C.g1_mul(C.G1_GEN, k) for k in (3, 0x10001, 0xDEADBEEF)]
    qs = [C.g2_mul(C.G2_GEN, k) for k in (5, 0xABCDEF, 77)]
    g1 = [DP.g1_tensors([p], "cpu") for p in ps]
    g2 = [DP.g2_tensors([q], "cpu") for q in qs]
    prep = [DP.g2_prepare(*q) for q in g2]
    prep_tower = [DP.g2_prepare_tower(*q) for q in g2]
    for (dbl, add, final), (dt, at, ft) in zip(prep, prep_tower):
        assert all(torch.equal(x, y) for x, y in zip(dbl, dt))
        assert all((x is None and y is None) or torch.equal(x, y) for x, y in zip(add, at))
        assert torch.equal(final, ft)
    f = DP.miller_loop(list(zip(g1, prep)))
    f_tower = DP.miller_loop_tower(list(zip(g1, prep_tower)))
    want = P.miller_loop(list(zip(ps, qs)))
    assert T.fq12_to_ints(f) == T.fq12_to_ints(f_tower) == [want]
    r = DP.final_exponentiation(f)
    assert T.fq12_to_ints(r) == [P.final_exponentiation(want)]
    assert torch.equal(r, DP.final_exponentiation_tower(f))


def _fq2_ints(x, k=None):
    c0, c1 = (np.asarray(c if k is None else c[k]) for c in x)
    return T.fq2_to_ints(torch.stack([convert.from_ref_limbs(L.FQ, c0, True),
                                      convert.from_ref_limbs(L.FQ, c1, True)], 1))


def test_g2_prepare_matches_jax():
    """The "prepare" set's coefficients of two non-generator bases in one
    call equal the JAX scan's, coefficient for coefficient."""
    qs = [C.g2_mul(C.G2_GEN, k) for k in _scalars(21, 2)]
    jd, ja, jf = JP._g2_prepare_j(JF.Fq2Ops.from_ints([q[0] for q in qs]),
                                  JF.Fq2Ops.from_ints([q[1] for q in qs]))
    dbl, add, final = DP.g2_prepare(*DP.g2_tensors(qs, "cpu"))
    coeffs = lambda t: [T.fq2_to_ints(t[:, :, j]) for j in range(3)]  # noqa: E731
    for k, bit in enumerate(DP._SCHED):
        assert coeffs(dbl[k]) == [_fq2_ints(c, k) for c in jd]
        if bit:
            assert coeffs(add[k]) == [_fq2_ints(c, k) for c in ja]
    assert coeffs(final) == [_fq2_ints(c) for c in jf]


def _gated():
    if not os.environ.get("ZEROCHAIN_PAIRING"):
        pytest.skip("set ZEROCHAIN_PAIRING=1 to compile the JAX Miller loop and "
                    "final exponentiation (many minutes on a CPU)")


def test_jax_miller_loop_matches_tower():
    _gated()
    p, q = C.g1_mul(C.G1_GEN, 0x1234567), C.g2_mul(C.G2_GEN, 0x89ABCDE)
    coeffs = JP._g2_prepare_j(JF.Fq2Ops.from_ints([q[0]]), JF.Fq2Ops.from_ints([q[1]]))
    want = JP._miller_one_j(JF.FqOps.from_ints([p[0]]), JF.FqOps.from_ints([p[1]]), coeffs)
    (px, py), (qx, qy) = DP.g1_tensors([p], "cpu"), DP.g2_tensors([q], "cpu")
    got = DP.miller_loop_tower([((px, py), DP.g2_prepare_tower(qx, qy))])
    assert T.fq12_to_ints(got) == T.fq12_to_ints(
        DP.miller_loop([((px, py), DP.g2_prepare(qx, qy))]))
    from tests.test_torch_pairing_jax import _jax_ints
    assert T.fq12_to_ints(got) == _jax_ints(want, 1)


def test_jax_pairing_matches_tower():
    _gated()
    p, q = C.g1_mul(C.G1_GEN, 0x1234567), C.g2_mul(C.G2_GEN, 0x89ABCDE)
    (px, py), (qx, qy) = DP.g1_tensors([p], "cpu"), DP.g2_tensors([q], "cpu")
    assert T.fq12_to_ints(DP.pairing_tower(px, py, qx, qy)) == [JP.pairing_host(p, q)]


# ---------------------------------------------------------------- the sets
def test_sets_walk_the_schedule():
    """The Miller sets walk the 62 scheduled steps and the final doubling
    (pairing: a prologue, the R chain of step 0, 63 steps, the epilogue),
    the final exponentiation has one Fermat power, and every set passes
    check_stages."""
    assert len(CP.SCHED) == 62 and sum(CP.SCHED) == 5
    pairing = CP.miller_set("pairing")
    assert len(pairing.seq) == 1 + 1 + CP.N_STEPS + 1
    assert CP.miller_set("prepare").seq[:, 1].tolist() == [0] + [
        CP.STEP_ROWS * k for k in range(CP.N_STEPS)]
    assert CP.miller_set("loop", 3).seq[1:-1, 1].tolist() == [
        CP.STEP_ROWS * k for k in range(CP.N_STEPS)]
    fe = CP.final_exp_set()
    assert fe.counts["inv"] == 1 and pairing.counts["inv"] == 0
    for s in (pairing, CP.miller_set("prepare"), CP.miller_set("loop", 3), fe):
        CP.check_stages(s)
        assert s.n_slots <= CP.MAX_SLOTS


def _corrupt(pset, fn):
    ops = pset.ops.copy()
    fn(ops)
    return pset._replace(ops=ops)


def test_check_stages_raises():
    """Two writers of one slot in a stage, or a read of a slot another
    operation of the stage writes, or a slot past n_slots: check_stages
    raises."""
    fe = CP.final_exp_set()
    st = int(np.argmax(np.diff(np.concatenate([[0], fe.stage_end])) >= 2))
    beg = int(fe.stage_end[st - 1]) if st else 0

    def two_writers(ops):
        ops[beg + 1, 1] = ops[beg, 1]

    def read_written(ops):
        ops[beg + 1, 0], ops[beg + 1, 2] = CP.OP_MOV, ops[beg, 1]

    def past(ops):
        ops[beg, 1] = fe.n_slots

    for fn in (two_writers, read_written, past):
        with pytest.raises(ValueError):
            CP.check_stages(_corrupt(fe, fn))


def test_limits_raise(monkeypatch):
    """A set over its slot limit raises (it is never cut short); so does a
    program that loads or stores past its rows or leaves an output row
    unwritten."""
    need = CP.miller_set("loop", 3).n_slots
    monkeypatch.setattr(CP, "MAX_SLOTS", need - 1)
    with pytest.raises(OverflowError):
        CP.miller_set.__wrapped__("loop", 3)
    monkeypatch.setattr(CP, "MAX_SLOTS", need)
    assert CP.miller_set.__wrapped__("loop", 3).n_slots == need
    p = CP.Program("p")
    p.store(p.add(p.load(0), p.load(1)), 0)
    with pytest.raises(ValueError, match="past the input"):
        CP.build_set("t", [p], [(0, 0)], 1, 1, 1)
    with pytest.raises(ValueError, match="never stored"):
        CP.build_set("t", [p], [(0, 0)], 1, 2, 2)
    with pytest.raises(ValueError, match="past the output"):
        CP.build_set("t", [p], [(0, 1)], 1, 3, 1)


def test_compile_in_place_outputs():
    """A program whose outputs overwrite its inputs (f <- f^2 style, and a
    swap) compiles to stages that check_stages and the symbolic run accept,
    and runs to the right values."""
    p = CP.Program("swap")
    a, b = p.pin(0), p.pin(1)
    p.out(b, 0)
    p.out(a, 1)
    p.out(p.mul(a, b), 2)
    q = CP.Program("load")
    for k in range(3):
        q.out(q.load(k), k)
    r = CP.Program("store")
    for k in range(3):
        r.store(r.pin(k), k)
    pset = CP.build_set("t", [q, p, r], [(0, 0), (1, 0), (2, 0)], 3, 3, 3)
    ins = L.FQ.array([5, 7, 0], "cpu", mont=True).reshape(12, 3, 1)
    out = CP.execute(pset, ins)
    assert L.FQ.to_ints(out.reshape(12, 3), mont=True) == [7, 5, 35]


def test_cyclotomic_square():
    """The final exponentiation's squarings (Granger-Scott) equal the
    mirror's square on an element of the cyclotomic subgroup (the easy
    part's image, where every value of the hard part lies), and differ from
    it on a generic element (so the check is not vacuous)."""
    from zerochain_tpu_torch.mirror import field as mf
    rng = np.random.default_rng(31)
    v = iter(int(x) % mf.Q for x in rng.integers(1, 1 << 62, size=24))
    f = tuple(tuple((next(v), next(v)) for _ in range(3)) for _ in range(2))
    easy = mf.fq12_mul(mf.fq12_conj(f), mf.fq12_inv(f))
    easy = mf.fq12_mul(mf.fq12_frobenius(easy, 2), easy)
    p = CP.Program("cyc")
    x = CP._load12(p)
    CP._store12(p, CP._Tower(p).cyc_sqr12(x))
    pset = CP.build_set("t", [p], [(0, 0)], 1, 12, 12)
    ins = T.fq12_from_ints([easy, f], "cpu").reshape(12, 12, 2)
    got = T.fq12_to_ints(CP.execute(pset, ins).reshape(12, 2, 3, 2, 2))
    assert got[0] == mf.fq12_sqr(easy)
    assert got[1] != mf.fq12_sqr(f)
