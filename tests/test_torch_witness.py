"""Port constraint evaluation and witness synthesis
(zerochain_tpu_torch.prover) against the JAX package.

The same assignments go to both sides; word arrays are compared through
``convert`` exactly (tolerance 0), and a o b = c is checked row by row."""

import os

import numpy as np
import pytest
import torch

from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ff import limbs as TL
from zerochain_tpu_torch.groth16.core import _pad_input_constraints
from zerochain_tpu_torch.mirror.field import R
from zerochain_tpu_torch.models.mini import MiniCommit
from zerochain_tpu_torch.prover import witness as twit
from zerochain_tpu_torch.prover import witness_mini as twm
from zerochain_tpu_torch.prover.matvec import ConstraintMatrices
from zerochain_tpu_torch.r1cs.system import ConstraintSystem

torch.set_num_threads(2)  # several test workers share the cores

AMOUNTS = [10, 0xFFFF0001, 0]


@pytest.fixture(scope="module")
def mini():
    cs = ConstraintSystem(track_names=False)
    MiniCommit().synthesize(cs)
    _pad_input_constraints(cs)
    mats = ConstraintMatrices(cs, cs.num_inputs, device="cpu")
    asg = [dict(amount=a) for a in AMOUNTS]
    aux, public = twm.mini_witness(**twm.witness_inputs_host(asg, "cpu"))
    return cs, mats, asg, aux, public


def test_mini_witness_matches_jax(mini):
    from zerochain_tpu.prover_tpu import witness_mini as jwm

    _, _, asg, aux, public = mini
    jaux, jpub = jwm.mini_witness_jit(**jwm.witness_inputs_host(asg))
    assert torch.equal(aux, convert.from_ref_limbs(TL.FR, np.asarray(jaux), mont=True))
    assert torch.equal(public, convert.from_ref_limbs(TL.FR, np.asarray(jpub), mont=True))


def test_mini_witness_matches_python_synthesis(mini):
    cs0, _, asg, aux, public = mini
    for b, a in enumerate(asg):
        cs = ConstraintSystem(track_names=False)
        MiniCommit(amount=a["amount"]).synthesize(cs)
        assert cs.is_satisfied()
        assert TL.FR.to_ints(aux[:, :, b], mont=True) == [v % R for v in cs.aux]
        assert TL.FR.to_ints(public[:, :, b], mont=True) == [
            v % R for v in cs.inputs]


def test_matvec_matches_jax_and_satisfies(mini):
    from zerochain_tpu.prover_tpu.matvec import ConstraintMatrices as JMats
    from zerochain_tpu.models.mini import MiniCommit as JMini
    from zerochain_tpu.groth16.core import _pad_input_constraints as jpad
    from zerochain_tpu.r1cs.system import ConstraintSystem as JCS

    _, mats, _, aux, public = mini
    witness = torch.cat([public, aux], dim=1)
    a_v, b_v, c_v = mats.eval(witness)
    assert a_v.shape == (8, mats.num_constraints, len(AMOUNTS))
    assert torch.equal(TL.mont_mul(TL.FR, a_v, b_v), c_v)     # a o b = c

    jcs = JCS(track_names=False)
    JMini().synthesize(jcs)
    jpad(jcs)
    jm = JMats(jcs, jcs.num_inputs)
    jw = convert.to_ref_limbs(TL.FR, witness, mont=True)
    for got, want in zip((a_v, b_v, c_v), jm.eval(jw)):
        assert torch.equal(
            got, convert.from_ref_limbs(TL.FR, np.asarray(want), mont=True))


def test_matvec_sums_many_terms():
    """A row of 300 terms of p - 1: the sum needs the ninth word."""
    cs = ConstraintSystem(track_names=False)
    xs = [cs.alloc(f"x{i}", R - 1) for i in range(300)]
    cs.enforce("row", [(x, R - 1) for x in xs], [(xs[0], 1)], [(xs[1], 1)])
    mats = ConstraintMatrices(cs, cs.num_inputs, device="cpu")
    wit_vals = [v % R for v in cs.inputs] + [v % R for v in cs.aux]
    w = TL.FR.array(wit_vals, "cpu", mont=True)[:, :, None]
    a_v, _, _ = mats.eval(w)
    assert TL.FR.to_ints(a_v[:, -1], mont=True) == [300 * (R - 1) * (R - 1) % R]


def test_emitter_helpers():
    v = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000000], dtype=torch.int64)
    assert TL.FR.to_ints(twit.u32_to_mont(v), mont=True) == v.tolist()
    bits = torch.tensor([[0, 1], [1, 1]])
    assert TL.FR.to_ints(twit.bit_mont(bits), mont=True) == [0, 1, 1, 1]
    em = twit.Emitter(torch.zeros((8, 63, 4), dtype=torch.int32))
    le = twit.emit_u32_range(em, v)
    assert le.shape == (32, 4) and em.off == 63
    assert [int(sum(int(le[i, b]) << i for i in range(32))) for b in range(4)] == v.tolist()


@pytest.mark.skipif(
    not os.environ.get("ZEROCHAIN_WITNESS"),
    reason="set ZEROCHAIN_WITNESS=1 (the JAX witness module compiles for many minutes on a CPU)",
)
def test_confidential_witness_matches_jax():
    from zerochain_tpu.prover_tpu import witness as jwit

    from test_torch_pipeline import confidential_assignments

    asg = confidential_assignments(2)
    aux, public = twit.confidential_witness(**twit.witness_inputs_host(asg, "cpu"))
    jaux, jpub = jwit.confidential_witness_jit(**jwit.witness_inputs_host(asg))
    assert torch.equal(aux, convert.from_ref_limbs(TL.FR, np.asarray(jaux), mont=True))
    assert torch.equal(public, convert.from_ref_limbs(TL.FR, np.asarray(jpub), mont=True))
