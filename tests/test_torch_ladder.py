"""The chain kernels' plain versions (cuda_ec.ladder_plain, horner_plain)
against the bigint mirror and the JAX package, and the CPU routing of their
wrappers.

The ladder is the little-endian double-and-add of
``zerochain_tpu.ec.weierstrass.scalar_mul_bits_jac``, compared with it after
``normalize`` (exact, tolerance 0 on the affine coordinates and the infinity
flag) and with the mirror's scalar multiply; the Horner combine is the
MSB-first ``res = 2^c * res + T_w`` of the MSMs' window combine, compared
word for word with the loop it replaces and with the mirror."""

import numpy as np
import pytest
import torch

from zerochain_tpu.ec import g1 as jg1
from zerochain_tpu.ec import g2 as jg2
from zerochain_tpu.ec import weierstrass as JW
from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ec import cuda_ec
from zerochain_tpu_torch.ec import g1 as tg1
from zerochain_tpu_torch.ec import g2 as tg2
from zerochain_tpu_torch.ec import weierstrass as W
from zerochain_tpu_torch.ff import limbs as TL
from zerochain_tpu_torch.mirror import curves as cv
from zerochain_tpu_torch.msm.pippenger import scalars_to_bits_np

torch.set_num_threads(2)  # several test workers share the cores

GROUPS = {"g1": (tg1, jg1, cv.G1_GEN, cv.g1_mul, cv.g1_add),
          "g2": (tg2, jg2, cv.G2_GEN, cv.g2_mul, cv.g2_add)}
N_BITS, COUNT, NW, C = 8, 4, 4, 3


def _to_ref(pt):
    """This port's point -> the JAX package's limb arrays."""
    def conv(c):
        if isinstance(c, tuple):
            return tuple(convert.to_ref_limbs(TL.FQ, x, mont=True) for x in c)
        return convert.to_ref_limbs(TL.FQ, c, mont=True)
    return tuple(conv(c) for c in pt)


@pytest.fixture(scope="module", params=sorted(GROUPS))
def grp(request):
    tg, jg, gen, mul, add = GROUPS[request.param]
    rng = np.random.RandomState(71)
    ks = [int(rng.randint(2, 1 << 20)) for _ in range(NW * COUNT)]
    pts = [mul(gen, k) for k in ks]
    pts[1] = None                                    # an identity base
    # bases with Z != 1: 2 * P
    jac = tg.double(tg.from_affine_host(pts, device="cpu"))
    return dict(tg=tg, jg=jg, mul=mul, add=add, pts=pts, jac=jac)


def _bits(rng):
    scalars = [int(rng.randint(1, 1 << N_BITS)) for _ in range(COUNT)]
    scalars[2] = 0                                   # all-zero bits
    scalars[3] = (1 << N_BITS) - 1                   # all-one bits
    return scalars, scalars_to_bits_np(scalars, N_BITS)


def test_ladder_plain_against_mirror_and_jax(grp):
    tg, jg = grp["tg"], grp["jg"]
    F = tg.F
    scalars, bits = _bits(np.random.RandomState(73))
    base = tuple(F.map(lambda a: a[:, :COUNT].contiguous(), c) for c in grp["jac"])
    got = cuda_ec.ladder_plain(F, base, torch.from_numpy(bits))
    doubled = [grp["add"](p, p) if p is not None else None
               for p in grp["pts"][:COUNT]]
    want = [grp["mul"](p, s) if p is not None and s else None
            for p, s in zip(doubled, scalars)]
    assert tg.to_affine_host(got) == want
    j_got = JW.scalar_mul_bits_jac(jg.F, _to_ref(base), bits)
    assert jg.to_affine_host(j_got) == want


def test_horner_plain_against_loop_and_mirror(grp):
    tg = grp["tg"]
    F = tg.F
    tot = tuple(F.map(lambda a: a.reshape(12, NW, COUNT), c) for c in grp["jac"])
    got = cuda_ec.horner_plain(F, tot, C)
    # the loop it replaces, through the wrappers (plain on the CPU)
    res = tuple(F.map(lambda a: a[:, NW - 1], c) for c in tot)
    for w in range(NW - 2, -1, -1):
        for _ in range(C):
            res = W.double(F, res)
        res = W.add(F, res, tuple(F.map(lambda a, w=w: a[:, w], c) for c in tot))
    for a, b in zip(cuda_ec._planes(F, got), cuda_ec._planes(F, res)):
        assert torch.equal(a, b)
    # sum_w 2^(c w) * 2 * P[w, i] by the mirror
    add = grp["add"]
    want = []
    for i in range(COUNT):
        acc = None
        for w in range(NW):
            p = grp["pts"][w * COUNT + i]
            if p is not None:
                acc = add(acc, grp["mul"](p, 2 << (C * w)))
        want.append(acc)
    assert tg.to_affine_host(got) == want


def test_wrappers_route_cpu_tensors_to_the_plain_versions(grp):
    tg = grp["tg"]
    F = tg.F
    scalars, bits = _bits(np.random.RandomState(79))
    base = tuple(F.map(lambda a: a[:, :COUNT].contiguous(), c) for c in grp["jac"])
    tbits = torch.from_numpy(bits)
    for a, b in zip(cuda_ec._planes(F, cuda_ec.ladder(F, base, tbits)),
                    cuda_ec._planes(F, cuda_ec.ladder_plain(F, base, tbits))):
        assert torch.equal(a, b)
    # W.scalar_mul_bits_jac is the ladder wrapper
    for a, b in zip(cuda_ec._planes(F, W.scalar_mul_bits_jac(F, base, tbits)),
                    cuda_ec._planes(F, cuda_ec.ladder_plain(F, base, tbits))):
        assert torch.equal(a, b)
    tot = tuple(F.map(lambda a: a.reshape(12, NW, COUNT), c) for c in grp["jac"])
    for a, b in zip(cuda_ec._planes(F, cuda_ec.horner(F, tot, C)),
                    cuda_ec._planes(F, cuda_ec.horner_plain(F, tot, C))):
        assert torch.equal(a, b)
    meta = tuple(F.map(lambda a: a.to("meta"), c) for c in base)
    with pytest.raises(ValueError):
        cuda_ec.ladder(F, meta, tbits.to("meta"))
    with pytest.raises(ValueError):
        cuda_ec.horner(F, tuple(F.map(lambda a: a.to("meta"), c) for c in tot), C)
