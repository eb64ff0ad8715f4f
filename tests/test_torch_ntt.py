"""Port NTT (zerochain_tpu_torch.ntt) against the JAX NttPlan and the
host domain oracle, at d = 8, 64, 256.  Inputs come from a numpy seed and
go to both sides; comparisons are exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from zerochain_tpu.ff import limbs as JL
from zerochain_tpu.ntt import plan_for as j_plan_for
from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ff import limbs as TL
from zerochain_tpu_torch.groth16 import domain as dom
from zerochain_tpu_torch.mirror.field import R
from zerochain_tpu_torch.ntt import plan_for

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
