"""Port MSM (zerochain_tpu_torch.msm) against the JAX SuffixMsm (its
composed, non-Pallas branch, which is what runs on a CPU) and the bigint
mirror's sum of scalar multiples.

Scalars and points come from a numpy seed and go to both sides.  The two
packages add points in different orders, so results are compared after
``normalize`` (affine coordinates + infinity flag), exactly (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zerochain_tpu.ec import g1 as jg1
from zerochain_tpu.ec import g2 as jg2
from zerochain_tpu.ec.fields import FqOps as JFq, Fq2Ops as JFq2
from zerochain_tpu.ff import limbs as JL
from zerochain_tpu.msm.suffix import SuffixMsm as JSuffixMsm
from zerochain_tpu_torch.ec import g1 as tg1
from zerochain_tpu_torch.ec import g2 as tg2
from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
from zerochain_tpu_torch.ff import limbs as TL
from zerochain_tpu_torch.mirror import curves as cv
from zerochain_tpu_torch.mirror.field import R
from zerochain_tpu_torch.msm import cuda_scan
from zerochain_tpu_torch.msm import pippenger as pip
from zerochain_tpu_torch.msm.suffix import (
    SuffixMsm, digits_from_limbs, signed_digits_from_limbs)

torch.set_num_threads(2)  # several test workers share the cores

N = 256
B = 2
C = 8
NBITS = 24  # scalars of 24 bits keep the window count (and the JAX compile) small

GROUPS = {
    "g1": (tg1, jg1, FqOps, JFq, cv.G1_GEN, cv.g1_mul, cv.g1_add, cv.g1_neg),
    "g2": (tg2, jg2, Fq2Ops, JFq2, cv.G2_GEN, cv.g2_mul, cv.g2_add, cv.g2_neg),
}


def _scalars(rng, dist):
    if dist == "uniform":
        return [[int(rng.randint(0, 1 << NBITS)) for _ in range(N)]
                for _ in range(B)]
    # zero-heavy: what a witness looks like (mostly 0 and 1)
    out = []
    for _ in range(B):
        kinds = rng.randint(0, 10, size=N)
        out.append([0 if k < 5 else 1 if k < 9 else int(rng.randint(0, 1 << NBITS))
                    for k in kinds])
    return out


def test_signed_digits_reconstruct_the_scalar():
    rng = np.random.RandomState(1)
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(64)]
    vals += [0, 1, R - 1, (1 << 255) % R, 128, 129, 255, 256]
    words = TL.FR.array(vals, "cpu")
    d = signed_digits_from_limbs(words, 8, 32)
    assert int(d.abs().max()) <= 128
    got = [sum(int(d[w, i]) << (8 * w) for w in range(32))
           for i in range(len(vals))]
    assert got == vals
    u = digits_from_limbs(words, 8, 32)
    assert [sum(int(u[w, i]) << (8 * w) for w in range(32))
            for i in range(len(vals))] == vals
    for c in (4, 5, 12):
        nw = -(-255 // c)
        dc = digits_from_limbs(words, c, nw)
        assert [sum(int(dc[w, i]) << (c * w) for w in range(nw))
                for i in range(len(vals))] == vals


@pytest.fixture(scope="module", params=sorted(GROUPS))
def group(request):
    tg, jg, F, JF, gen, mul, add, neg = GROUPS[request.param]
    rng = np.random.RandomState(17)
    base = [mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(12)]
    pts = [base[int(rng.randint(0, 12))] for _ in range(N)]
    pts[3] = None                  # zero padding inside a run
    pts[200] = None
    pts[10] = pts[11]              # P = Q neighbours
    pts[20] = neg(pts[21])         # P = -Q neighbours
    msm = SuffixMsm(F, c=C, n_bits=NBITS, signed=True)
    jmsm = JSuffixMsm(JF, c=C, n_bits=NBITS, signed=True)
    assert msm.n_windows == jmsm.n_windows and msm.nb == jmsm.nb == 129
    return dict(tg=tg, jg=jg, F=F, mul=mul, add=add, pts=pts, msm=msm,
                jmsm=jmsm, tp=tg.from_affine_host(pts, device="cpu"),
                jp=jg.from_affine_host(pts))


def _mirror_msm(g, scalars):
    acc = None
    for p, s in zip(g["pts"], scalars):
        if p is not None and s:
            acc = g["add"](acc, g["mul"](p, s))
    return acc


@pytest.mark.parametrize("dist", ["uniform", "zero_heavy"])
def test_window_partials_and_combine(group, dist):
    g = group
    rng = np.random.RandomState(23 if dist == "uniform" else 29)
    scal = _scalars(rng, dist)
    scal[0][10] = scal[0][11] = 5      # equal digits on the equal points
    scal[0][20] = scal[0][21] = 7
    words = torch.stack([TL.FR.array(s, "cpu") for s in scal], dim=-1)
    digits = g["msm"].digits(words)                      # (nw, N, B)
    prep = g["msm"].prep(digits)
    sd, od = prep
    assert bool((sd.abs()[..., :-1] >= sd.abs()[..., 1:]).all())
    assert torch.equal(torch.gather(digits.movedim(1, -1), -1, od.long()), sd)
    totals = g["msm"].window_partials(g["tp"], prep=prep)
    got = g["tg"].to_affine_host(g["msm"].combine(totals))
    assert got == [_mirror_msm(g, s) for s in scal]
    # a second MSM over the same scalars shares the prep
    again = g["msm"].window_partials(g["tp"], prep=prep)
    assert all(torch.equal(a, b) for a, b in zip(
        cuda_scan_leaves(again), cuda_scan_leaves(totals)))

    jwords = jnp.asarray(np.stack(
        [np.stack([JL._int_to_limbs(v, JL.FR.n) for v in s], 1) for s in scal],
        -1))
    jdig = g["jmsm"].digits(jwords)
    assert np.array_equal(np.asarray(jdig), digits.numpy())
    jtot = g["jmsm"].window_partials(g["jp"], jdig)
    nw = g["msm"].n_windows
    j_aff = g["jg"].to_affine_host(
        pip.tmap(lambda a: np.asarray(a).reshape(a.shape[0], -1), jtot))
    t_aff = g["tg"].to_affine_host(totals)
    assert len(t_aff) == nw * B and t_aff == j_aff
    assert g["jg"].to_affine_host(g["jmsm"].combine(jtot)) == got


def cuda_scan_leaves(pt):
    out = []
    for c in pt:
        out.extend(c if isinstance(c, tuple) else (c,))
    return out


def test_full_call_and_unsigned(group):
    g = group
    rng = np.random.RandomState(31)
    scal = [[int(rng.randint(0, 1 << NBITS)) for _ in range(N)]]
    words = torch.stack([TL.FR.array(s, "cpu") for s in scal], dim=-1)
    msm_u = SuffixMsm(g["F"], c=4, n_bits=NBITS, signed=False)
    got = g["tg"].to_affine_host(msm_u(g["tp"], msm_u.digits(words)))
    assert got == [_mirror_msm(g, scal[0])]


def test_window_totals_checks_its_input(group):
    g = group
    sd = torch.zeros((1, N), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_scan.window_totals(g["F"], g["tp"], sd.long(), sd, 129)
    with pytest.raises(ValueError):
        cuda_scan.window_totals(g["F"], g["tp"], sd[:, :8], sd, 129)
    out = cuda_scan.window_totals(g["F"], g["tp"], sd, sd, 129)
    assert g["tg"].to_affine_host(out) == [None]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_fixed_base_msm(name):
    tg, _, F, _, gen, mul, _, _ = GROUPS[name]
    rng = np.random.RandomState(37)
    scalars = [0, 1, R - 1] + [int.from_bytes(rng.bytes(32), "little") % R
                               for _ in range(5)]
    fb = pip.FixedBaseMsm(F, gen, device="cpu")
    got = tg.to_affine_host(fb(pip.scalars_to_bits(scalars, 255, "cpu")))
    assert got == [mul(gen, s) if s else None for s in scalars]
    bits = pip.scalars_to_bits(scalars, 255, "cpu")
    d = pip.digits_from_bits(bits, 8, 32)
    assert [sum(int(d[w, i]) << (8 * w) for w in range(32))
            for i in range(len(scalars))] == scalars
