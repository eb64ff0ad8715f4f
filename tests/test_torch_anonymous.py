"""The AnonymousTransfer slice of the port: its circuit, its batched witness
and the folds' chain kernel, against the JAX package's model, the Python
synthesis (the oracle) and the mirror.

Everything here is exact (tolerance 0): canonical integers, or word arrays
through ``convert``.  The witness runs on the CPU at B = 2 through the
plain versions of the kernels; the JAX witness graph takes many minutes to
compile on a CPU, so its comparison waits behind ZEROCHAIN_WITNESS=1."""

import functools
import os

import numpy as np
import pytest
import torch

from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ec import cuda_jubjub
from zerochain_tpu_torch.ec import jubjub as ej
from zerochain_tpu_torch.ff import limbs as TL
from zerochain_tpu_torch.groth16.core import _pad_input_constraints
from zerochain_tpu_torch.mirror import jubjub as jj
from zerochain_tpu_torch.mirror.field import R
from zerochain_tpu_torch.models.anonymous import ANONIMITY_SIZE, AnonymousTransfer
from zerochain_tpu_torch.prover import AnonymousProver
from zerochain_tpu_torch.prover import witness_anon as wa
from zerochain_tpu_torch.prover.matvec import ConstraintMatrices
from zerochain_tpu_torch.r1cs.system import ConstraintSystem

torch.set_num_threads(2)  # several test workers share the cores

FR = TL.FR


@functools.lru_cache(maxsize=None)
def _assignment(seed: bytes, amount=10, remaining=90, current=100,
                s_index=3, t_index=7):
    return wa.anon_assignment(seed, amount, remaining, current, s_index,
                              t_index)


def test_bench_assignments_match_jax():
    """The port's benchmark batch is the JAX package's, dict for dict (k = 2
    is the first whose selectors collide and move t)."""
    from zerochain_tpu.prover_tpu.witness_anon import bench_assignments

    assert wa.bench_assignments(3) == bench_assignments(3)


def two_assignments():
    return [_assignment(b"anon-A"),
            _assignment(b"anon-B", amount=3, current=9, remaining=6,
                        s_index=0, t_index=11)]


@pytest.fixture(scope="module")
def batch():
    """Two assignments with different selectors, the port's witness of both
    on the CPU, and the constraint system in setup mode."""
    asg = two_assignments()
    aux, public = wa.anonymous_witness(**wa.witness_inputs_host(asg, "cpu"))
    cs = ConstraintSystem(track_names=False)
    AnonymousTransfer().synthesize(cs)
    return asg, aux, public, cs


def test_structure_matches_jax_model(batch):
    from zerochain_tpu.models.anonymous import AnonymousTransfer as JAnon
    from zerochain_tpu.r1cs.system import ConstraintSystem as JCS

    *_, cs = batch
    jcs = JCS(track_names=False)
    JAnon().synthesize(jcs)
    assert cs.num_constraints == jcs.num_constraints == 50514
    assert cs.num_inputs == jcs.num_inputs == 105
    assert len(cs.aux) == len(jcs.aux) == 50429
    assert cs.hash() == jcs.hash()


def test_namespace_breakdown_matches_the_reference_walk():
    import collections

    from test_anonymous_circuit import GOLDEN_NAMESPACE_COUNTS

    cs = ConstraintSystem()
    AnonymousProver.circuit_for(_assignment(b"anon-A")).synthesize(cs)
    assert dict(collections.Counter(
        n.split("/")[0] for n in cs.constraint_names)) == GOLDEN_NAMESPACE_COUNTS


@pytest.mark.parametrize("amount, satisfied", [(10, True), (11, False)])
def test_valid_amount_satisfies_invalid_does_not(amount, satisfied):
    """Balance 100 = 90 + 10 holds; 100 != 90 + 11 does not."""
    cs = ConstraintSystem(track_names=False)
    AnonymousProver.circuit_for(
        _assignment(b"anon-A", amount=amount)).synthesize(cs)
    assert cs.is_satisfied() is satisfied


@pytest.mark.parametrize("model", ["port", "jax"])
@pytest.mark.parametrize("b", [0, 1])
def test_witness_matches_python_synthesis(batch, model, b):
    """Aux and public columns of proof b equal the synthesis of the port's
    model and of the JAX package's (a JAX-free Python module)."""
    asg, aux, public, _ = batch
    circuit = AnonymousProver.circuit_for(asg[b])
    if model == "jax":
        from zerochain_tpu.models.anonymous import AnonymousTransfer as JAnon
        from zerochain_tpu.r1cs.system import ConstraintSystem as JCS

        circuit, cs = JAnon(**vars(circuit)), JCS(track_names=False)
    else:
        cs = ConstraintSystem(track_names=False)
    circuit.synthesize(cs)
    assert cs.is_satisfied()
    assert FR.to_ints(public[:, :, b], mont=True) == [v % R for v in cs.inputs]
    got = FR.to_ints(aux[:, :, b], mont=True)
    want = [v % R for v in cs.aux]
    assert len(got) == len(want) == 50429
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert not bad, f"{len(bad)} aux values differ, first at {bad[:5]}"


def test_circuit_for_supplies_the_right_ciphertext(batch):
    """circuit_for supplies the right ciphertext r * G that the assignment
    leaves out, and it is the public column's entry the witness recomputes
    (the circuit's synthesis against that column is
    test_witness_matches_python_synthesis[port])."""
    asg, _, public, _ = batch
    at = 1 + 8 * ANONIMITY_SIZE
    for b, a in enumerate(asg):
        right = AnonymousProver.circuit_for(a).right_ciphertext
        assert right == jj.mul(jj.generator(jj.NOTE_COMMITMENT_RANDOMNESS),
                               a["randomness"])
        assert tuple(FR.to_ints(public[:, at: at + 2, b], mont=True)) == right


def test_matvec_satisfies_a_b_c(batch):
    """a o b = c row by row through the port's ConstraintMatrices."""
    _, aux, public, _ = batch
    cs = ConstraintSystem(track_names=False)
    AnonymousTransfer().synthesize(cs)
    _pad_input_constraints(cs)
    mats = ConstraintMatrices(cs, cs.num_inputs, device="cpu")
    a_v, b_v, c_v = mats.eval(torch.cat([public, aux], dim=1))
    assert a_v.shape == (8, 50514 + 105, 2)
    assert torch.equal(TL.mont_mul(FR, a_v, b_v), c_v)


def test_fold_through_fixed_chain_matches_loop_and_mirror():
    """A fold is fixed_chain from the identity: its sums equal a loop of
    ej.add over the plain field ops, word for word, and the mirror's running
    sums after normalisation; several folds side by side on the lane axis."""
    asg = two_assignments()
    ins = wa.witness_inputs_host(asg, "cpu")
    ekx, eky = ins["enc_keys"]
    clx, cly = ins["left_cts"]
    gen = np.random.default_rng(7)
    bools = [torch.from_numpy(gen.integers(0, 2, (ANONIMITY_SIZE, 2))),
             ins["s_bits"], torch.ones((ANONIMITY_SIZE, 2), dtype=torch.int64)]
    folds = [(bools[0], ekx, eky), (bools[1], clx, cly), (bools[2], ekx, eky)]
    sels, lx, ly = wa.fold_windows(folds)
    assert lx.shape == (8, ANONIMITY_SIZE + 1, 3, 2)
    got = cuda_jubjub.fixed_chain(lx, ly)                  # CPU: the plain version
    for f, (sx, sy) in enumerate(sels):
        acc = ej.identity((2,), "cpu")
        loop = []
        for k in range(ANONIMITY_SIZE):
            acc = ej.add(acc, ej.ext_from_affine(sx[:, k], sy[:, k], ej.PLAIN_OPS),
                         ej.PLAIN_OPS)
            loop.append(acc)
        assert torch.equal(got[:, :, :, f], cuda_jubjub.stack_xyz(loop))
    values = wa.compute_folds(folds)
    for f, (b_mask, key) in enumerate(zip(bools, ("enc_keys", "left_ciphertexts",
                                                  "enc_keys"))):
        accx, accy = values[f][2], values[f][3]
        for b in range(2):
            acc = jj.ZERO
            for k in range(ANONIMITY_SIZE):
                if int(b_mask[k, b]):
                    acc = jj.add(acc, asg[b][key][k])
                assert (FR.to_ints(accx[:, k, b], mont=True)[0],
                        FR.to_ints(accy[:, k, b], mont=True)[0]) == acc


@pytest.mark.skipif(
    not os.environ.get("ZEROCHAIN_WITNESS"),
    reason="set ZEROCHAIN_WITNESS=1 (the JAX witness module compiles for many minutes on a CPU)",
)
def test_anonymous_witness_matches_jax(batch):
    from zerochain_tpu.prover_tpu import witness_anon as jwa

    asg, aux, public, _ = batch
    jaux, jpub = jwa.anonymous_witness_jit(**jwa.witness_inputs_host(asg))
    assert torch.equal(aux, convert.from_ref_limbs(FR, np.asarray(jaux), mont=True))
    assert torch.equal(public, convert.from_ref_limbs(FR, np.asarray(jpub), mont=True))
