"""Port curve ops (zerochain_tpu_torch.ec) against the JAX package and the
bigint mirror: G1 and G2 add / double / add_mixed / scalar_mul_bits with
the degenerate cases, Jubjub add / double / scalar_mul_bits.

Jacobian coordinates are not unique, so points are compared after
``normalize`` (affine coordinates and the infinity flag); the comparison is
exact (tolerance 0).  Where both sides run the same formula (add, double)
the raw Jacobian words are compared too."""

import numpy as np
import pytest
import torch

from zerochain_tpu.ec import g1 as jg1
from zerochain_tpu.ec import g2 as jg2
from zerochain_tpu.ec import jubjub as jej
from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ec import cuda_ec
from zerochain_tpu_torch.ec import g1 as tg1
from zerochain_tpu_torch.ec import g2 as tg2
from zerochain_tpu_torch.ec import jubjub as tej
from zerochain_tpu_torch.ec import weierstrass as W
from zerochain_tpu_torch.mirror import curves as cv
from zerochain_tpu_torch.mirror import jubjub as mjj
from zerochain_tpu_torch.mirror.field import S
from zerochain_tpu_torch.msm.pippenger import scalars_to_bits_np

torch.set_num_threads(2)  # several test workers share the cores

GROUPS = {
    "g1": (tg1, jg1, cv.G1_GEN, cv.g1_mul, cv.g1_add, cv.g1_neg),
    "g2": (tg2, jg2, cv.G2_GEN, cv.g2_mul, cv.g2_add, cv.g2_neg),
}


def _leaves(pt):
    out = []
    for c in pt:
        out.extend(c if isinstance(c, tuple) else (c,))
    return out


@pytest.fixture(scope="module", params=sorted(GROUPS))
def case(request):
    tg, jg, gen, mul, add, neg = GROUPS[request.param]
    rng = np.random.RandomState(5)
    pts = [mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(5)]
    # generic, P = Q, P = -Q, P = inf, Q = inf, both inf
    ps = [pts[0], pts[1], pts[2], None, pts[3], None]
    qs = [pts[4], pts[1], neg(pts[2]), pts[0], None, None]
    return dict(tg=tg, jg=jg, add=add, mul=mul, ps=ps, qs=qs,
                tp=tg.from_affine_host(ps, device="cpu"),
                tq=tg.from_affine_host(qs, device="cpu"),
                jp=jg.from_affine_host(ps), jq=jg.from_affine_host(qs))


def _same_words(t_pt, j_pt):
    want = convert.points_from_ref(
        tuple(tuple(np.asarray(x) for x in c) if isinstance(c, tuple)
              else np.asarray(c) for c in j_pt))
    for a, b in zip(_leaves(t_pt), _leaves(want)):
        assert torch.equal(a, b)


def test_add_with_degenerate_cases(case):
    c = case
    got = c["tg"].add(c["tp"], c["tq"])
    want = [c["add"](p, q) for p, q in zip(c["ps"], c["qs"])]
    assert c["tg"].to_affine_host(got) == want
    assert c["jg"].to_affine_host(c["jg"].add(c["jp"], c["jq"])) == want
    _same_words(got, c["jg"].add(c["jp"], c["jq"]))


def test_double_and_jacobian_operands(case):
    c = case
    d = c["tg"].double(c["tp"])
    assert c["tg"].to_affine_host(d) == [c["add"](p, p) for p in c["ps"]]
    _same_words(d, c["jg"].double(c["jp"]))
    # Z != 1 on the left: 2P + Q
    got = c["tg"].add(d, c["tq"])
    want = [c["add"](c["add"](p, p), q) for p, q in zip(c["ps"], c["qs"])]
    assert c["tg"].to_affine_host(got) == want
    _same_words(got, c["jg"].add(c["jg"].double(c["jp"]), c["jq"]))


def test_add_mixed(case):
    c = case
    F = c["tg"].F
    q_inf = W.is_identity(F, c["tq"])
    got = c["tg"].add_mixed(c["tp"], (c["tq"][0], c["tq"][1]), q_inf)
    want = [c["add"](p, q) for p, q in zip(c["ps"], c["qs"])]
    assert c["tg"].to_affine_host(got) == want
    j_inf = np.asarray([q is None for q in c["qs"]])
    j_got = c["jg"].add_mixed(c["jp"], (c["jq"][0], c["jq"][1]), j_inf)
    assert c["jg"].to_affine_host(j_got) == want


def test_scalar_mul_bits(case):
    c = case
    rng = np.random.RandomState(9)
    bases = [p for p in c["ps"] if p is not None][:3]
    scalars = [int.from_bytes(rng.bytes(4), "little") for _ in bases]
    scalars[0] = 0
    bits = scalars_to_bits_np(scalars, 32)
    base = c["tg"].from_affine_host(bases, device="cpu")
    got = c["tg"].scalar_mul_bits((base[0], base[1]), torch.from_numpy(bits))
    want = [c["mul"](p, s) if s else None for p, s in zip(bases, scalars)]
    assert c["tg"].to_affine_host(got) == want
    jbase = c["jg"].from_affine_host(bases)
    j_got = c["jg"].scalar_mul_bits((jbase[0], jbase[1]), bits)
    assert c["jg"].to_affine_host(j_got) == want


def test_wrapper_rejects_bad_input(case):
    c = case
    F = c["tg"].F
    bad = tuple(F.map(lambda t: t.to(torch.int64), x) for x in c["tp"])
    with pytest.raises(TypeError):
        cuda_ec._prepare(cuda_ec._planes(F, bad))


# ---------------------------------------------------------------- Jubjub
@pytest.fixture(scope="module")
def jub():
    rng = np.random.RandomState(21)
    gen = mjj.generator(mjj.NOTE_COMMITMENT_RANDOMNESS)
    pts = [mjj.mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(4)]
    qts = [pts[1], pts[1], mjj.neg(pts[2]), mjj.ZERO]
    return pts, qts


def test_jubjub_add_double(jub):
    pts, qts = jub
    tp, tq = tej.to_extended(pts, device="cpu"), tej.to_extended(qts, device="cpu")
    jp, jq = jej.to_extended(pts), jej.to_extended(qts)
    want = [mjj.add(p, q) for p, q in zip(pts, qts)]
    assert tej.to_affine_host(tej.add(tp, tq)) == want
    assert jej.to_affine_host(jej.add(jp, jq)) == want
    want_d = [mjj.double(p) for p in pts]
    assert tej.to_affine_host(tej.double(tp)) == want_d
    assert jej.to_affine_host(jej.double(jp)) == want_d
    assert tej.is_identity(tej.add(tp, tej.neg(tp))).tolist() == [True] * 4


def test_jubjub_scalar_mul_bits(jub):
    pts, _ = jub
    rng = np.random.RandomState(22)
    scalars = [int.from_bytes(rng.bytes(6), "little") % S for _ in pts]
    bits = scalars_to_bits_np(scalars, 48)
    want = [mjj.mul(p, s) for p, s in zip(pts, scalars)]
    got = tej.scalar_mul_bits(tej.to_extended(pts, device="cpu"),
                              torch.from_numpy(bits))
    assert tej.to_affine_host(got) == want
    j_got = jej.scalar_mul_bits(jej.to_extended(pts), bits)
    assert jej.to_affine_host(j_got) == want
