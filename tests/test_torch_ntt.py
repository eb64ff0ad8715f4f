"""Port NTT (zerochain_tpu_torch.ntt) against the JAX NttPlan and the
host domain oracle, at d = 8, 64, 256.  Inputs come from a numpy seed and
go to both sides; comparisons are exact (tolerance 0)."""

import jax
import numpy as np
import pytest
import torch

from zerochain_tpu.ff import limbs as JL
from zerochain_tpu.ntt import plan_for as j_plan_for
from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ff import limbs as TL
from zerochain_tpu_torch.groth16 import domain as dom
from zerochain_tpu_torch.mirror.field import R
from zerochain_tpu_torch.ntt import plan_for, quotient
from zerochain_tpu_torch.ntt.ntt import schedule

torch.set_num_threads(2)  # several test workers share the cores

BATCH = 2


@pytest.fixture(scope="module", params=[8, 64, 256])
def case(request):
    d = request.param
    rng = np.random.RandomState(d)
    vals = [int.from_bytes(rng.bytes(40), "little") % R
            for _ in range(BATCH * d)]
    t = TL.FR.array(vals, "cpu", mont=True).reshape(TL.FR.n, BATCH, d)
    j = JL.to_limbs(JL.FR, vals, mont=True).reshape(JL.FR.n, BATCH, d)
    return d, vals, t, j, plan_for(d, "cpu"), j_plan_for(d)


@pytest.mark.parametrize(
    "name", ["ntt", "intt", "coset_ntt", "icoset_ntt", "divide_by_z_on_coset"])
def test_transform_matches_jax(case, name):
    d, vals, t, j, plan, jplan = case
    got = getattr(plan, name)(t)
    want = convert.from_ref_limbs(
        TL.FR, np.asarray(getattr(jplan, name)(j)), mont=True)
    assert torch.equal(got, want)


def test_transform_matches_oracle(case):
    d, vals, t, _, plan, _ = case
    omega = dom.omega_for(d)
    rows = [vals[:d], vals[d:]]
    assert TL.FR.to_ints(plan.ntt(t), mont=True) == sum(
        (dom.ntt(r, omega) for r in rows), [])
    assert TL.FR.to_ints(plan.icoset_ntt(plan.coset_ntt(t)), mont=True) == vals
    assert TL.FR.to_ints(plan.intt(t), mont=True) == sum(
        (dom.intt(r, omega) for r in rows), [])


def test_quotient_matches_jax():
    """ntt.quotient at d = 256 against the JAX plan's chain intt ->
    coset_ntt -> a * b - c -> divide_by_z_on_coset -> icoset_ntt, on the
    same seeded evaluations (tolerance 0)."""
    d = 256
    rng = np.random.RandomState(2024)
    ts, js = [], []
    for _ in range(3):
        vals = [int.from_bytes(rng.bytes(40), "little") % R
                for _ in range(BATCH * d)]
        ts.append(TL.FR.array(vals, "cpu", mont=True).reshape(TL.FR.n, BATCH, d))
        js.append(JL.to_limbs(JL.FR, vals, mont=True).reshape(JL.FR.n, BATCH, d))
    jplan = j_plan_for(d)
    pointwise = jax.jit(lambda a, b, c: JL.sub(JL.FR, JL.mont_mul(JL.FR, a, b), c))
    a_c, b_c, c_c = (jplan.coset_ntt(jplan.intt(j)) for j in js)
    want = jplan.icoset_ntt(jplan.divide_by_z_on_coset(pointwise(a_c, b_c, c_c)))
    got = quotient(plan_for(d, "cpu"), *ts)
    assert torch.equal(got, convert.from_ref_limbs(TL.FR, np.asarray(want), mont=True))


@pytest.mark.parametrize("tile_lg", [3, 4, 11])
def test_schedule_covers_every_size(tile_lg):
    """The kernel's passes of every d the plan takes (2^0 .. 2^32):
    ceil(lg / tile_lg) of them (one at d = 1), consecutive, each at most
    tile_lg stages."""
    for lg in range(33):
        passes = schedule(lg, tile_lg)
        assert len(passes) == max(1, -(-lg // tile_lg))
        assert [s0 for s0, _ in passes] == [sum(k for _, k in passes[:i])
                                            for i in range(len(passes))]
        assert sum(k for _, k in passes) == lg
        assert all(k <= tile_lg for _, k in passes)
