"""The witness's gadget kernels (prover/cuda_witness.py): the step pass W1
and the gadget program W2, through their plain versions, against the JAX
package's gadget functions, and the whole ConfidentialTransfer witness
against the synthesis of the JAX package's model.

Everything is exact (tolerance 0): word arrays through ``convert``, or
canonical integers.  B = 2 or 3 proofs, inputs from numpy seeds."""

import numpy as np
import pytest
import torch

from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ff import cuda_ff
from zerochain_tpu_torch.ff import limbs as TL
from zerochain_tpu_torch.mirror import jubjub as mjj
from zerochain_tpu_torch.mirror.field import R
from zerochain_tpu_torch.prover import cuda_witness as cw
from zerochain_tpu_torch.prover import witness as twit
from zerochain_tpu_torch.prover import witness_anon as wa
from zerochain_tpu_torch.prover import witness_mini as wm

torch.set_num_threads(2)  # several test workers share the cores

FR = TL.FR


def _fr(rng, shape, zeros=()):
    n = int(np.prod(shape[1:]))
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    for k in zeros:
        vals[k] = 0
    return FR.array(vals, "cpu").reshape(shape)


def _to_jax(t):
    return convert.to_ref_limbs(FR, t.reshape(FR.n, -1), mont=True)


def _from_jax(a, shape):
    return convert.from_ref_limbs(FR, np.asarray(a), mont=True).reshape(shape)


def _points(rng, n):
    gen = mjj.generator(mjj.NOTE_COMMITMENT_RANDOMNESS)
    return [mjj.mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(n)]


def test_step_aux_matches_jax():
    """W1's plain rows of a variable-base, a 32-bit fixed-base and a fold
    job: every addition gadget's U, A, B, C against the JAX package's
    _affine_add_aux and every doubling's T, A, C against _affine_dbl_aux,
    on the same inputs (one JAX call each)."""
    from zerochain_tpu.prover_tpu import witness as jw

    rng = np.random.RandomState(5)
    B, nb, K = 2, 4, 3
    var_pts = tuple(_fr(rng, (8, nb, 1, B), zeros=(2,)) for _ in range(4))
    bits = torch.from_numpy(rng.randint(0, 2, (nb, 1, B)).astype(np.uint8))
    bits[:, 0, 1] = 1
    fix_pts = (_fr(rng, (8, 11, 1, B)), _fr(rng, (8, 11, 1, B)),
               _fr(rng, (8, 10, 1, B)), _fr(rng, (8, 10, 1, B)))
    digits = torch.from_numpy(rng.randint(0, 8, (11, 1, B)).astype(np.uint8))
    fold_pts = tuple(_fr(rng, (8, K, 1, B)) for _ in range(4))
    jobs = [cw.StepJob(cw.VAR, 0, var_pts, 0, bits)]
    jobs.append(cw.StepJob(cw.FIXED, jobs[-1].n_rows, fix_pts, 0, digits, 32))
    jobs.append(cw.StepJob(cw.FOLD, jobs[-1].aux_off + jobs[-1].n_rows, fold_pts, 0))
    aux = torch.zeros((8, jobs[-1].aux_off + jobs[-1].n_rows, B), dtype=torch.int32)
    cw.steps(jobs, aux)                                    # CPU: the plain version
    assert all(v == 0 for v in cw.launches.values())

    cx, cy, rx, ry = (t[:, :, 0] for t in var_pts)
    on = bits[:, 0].bool()[None]
    sx = torch.where(on, cx, torch.zeros_like(cx))
    sy = torch.where(on, cy, TL.ones_mont(FR, cy.shape[1:]))
    lx, ly, fx, fy = (t[:, :, 0] for t in fix_pts)
    gx, gy, ax, ay = (t[:, :, 0] for t in fold_pts)
    zero, one = torch.zeros_like(ax[:, :1]), TL.ones_mont(FR, (1, B))
    add_in = [torch.cat(parts, dim=1) for parts in zip(
        (rx[:, :-1], ry[:, :-1], sx[:, 1:], sy[:, 1:]),
        (torch.cat([lx[:, :1], fx[:, :9]], 1), torch.cat([ly[:, :1], fy[:, :9]], 1),
         lx[:, 1:11], ly[:, 1:11]),
        (torch.cat([zero, ax[:, :-1]], 1), torch.cat([one, ay[:, :-1]], 1), gx, gy))]
    var_rows = [2 + 13 * s + 7 for s in range(nb - 1)]
    fix_rows = [jobs[1].aux_off + 3 + 9 * (w - 1) + (3 if w < 10 else 2)
                for w in range(1, 11)]
    fold_rows = [jobs[2].aux_off + 8 * i + 2 for i in range(K)]
    got = torch.stack([aux[:, [r + k for r in var_rows + fix_rows + fold_rows]]
                       for k in range(4)])
    want = jw._affine_add_aux(*(_to_jax(t) for t in add_in))
    for k in range(4):
        assert torch.equal(got[k], _from_jax(want[k], got[k].shape))

    want = jw._affine_dbl_aux(_to_jax(cx[:, :-1]), _to_jax(cy[:, :-1]))
    for k, c in enumerate((0, 1, 2)):
        rows = [2 + 13 * s + c for s in range(nb - 1)]
        assert torch.equal(aux[:, rows], _from_jax(want[k], aux[:, rows].shape))


def _gadget_inputs(B):
    """Per proof b: P_b, Q_b and S_b, S_b the small-order (0, -1) for b = 0
    and 2 (its third doubling's x is 0)."""
    rng = np.random.RandomState(11)
    pts = _points(rng, 3 * B)
    s = [(0, R - 1) if b % 2 == 0 else pts[2 * B + b] for b in range(B)]
    return pts[:B], pts[B:2 * B], s


def test_gadget_program_matches_jax():
    """W2's plain interpreter on a program of EdwardsPoint::witness, the
    standalone add and two not-small-order gadgets (a depth of its batched
    inversions holds the zero of a small-order point) against the JAX
    package's emit_witness_point, emit_add_gadget and emit_not_small_order."""
    from zerochain_tpu.prover_tpu import witness as jw

    B = 3
    P, Q, S = _gadget_inputs(B)
    ins = torch.stack([c for pts in (P, Q, S) for c in twit.affine_mont_host(pts, "cpu")],
                      dim=1)
    prog = cw.Program()
    p, q, s = ((prog.load(2 * k, cw.INS), prog.load(2 * k + 1, cw.INS)) for k in range(3))
    vals = (twit.witness_point_aux(prog, *p) + twit.add_gadget(prog, *p, *q)
            + twit.not_small_order_gadget(prog, *p) + twit.not_small_order_gadget(prog, *s))
    for row, v in enumerate(vals):
        prog.store(v, row)
    c = prog.compile()
    assert c.counts["inv"] == 2     # the Z's of the add and both doublings, then the two x's
    aux = torch.zeros((8, len(vals), B), dtype=torch.int32)
    cw.gadgets(c, aux, ins)                                # CPU: the plain version

    jx = {k: _to_jax(ins[:, k]) for k in range(6)}
    em = jw.Emitter()
    jw.emit_witness_point(em, jx[0], jx[1])
    jw.emit_add_gadget(em, jx[0], jx[1], jx[2], jx[3])
    head = _from_jax(em.concat(), (8, 11, B))
    assert torch.equal(aux[:, :9], head[:, 2:])
    em = jw.Emitter()
    jw.emit_not_small_order(em, np.concatenate([jx[0], jx[4]], axis=1),
                            np.concatenate([jx[1], jx[5]], axis=1))
    nso = _from_jax(em.concat(), (8, 16, 2 * B))
    assert torch.equal(aux[:, 9:25], nso[:, :, :B])
    assert torch.equal(aux[:, 25:41], nso[:, :, B:])
    assert int(aux[:, 40, 0].abs().sum()) == 0             # 1/0 -> 0


def test_batched_inversion_with_planted_zeros():
    """Six inversions of one depth are one Montgomery trick (one Fermat
    power): each word equals inv_plain's per-element inverse, 0 for 0, with
    one zero in proof 0, two in proof 1, all six in proof 2, none in 3."""
    rng = np.random.RandomState(13)
    B, k = 4, 6
    zeros = [0 * B + 0, 2 * B + 1, 4 * B + 1] + [i * B + 2 for i in range(k)]
    ins = _fr(rng, (8, k, B), zeros=zeros)
    prog = cw.Program()
    for i in range(k):
        prog.store(prog.inv(prog.load(i, cw.INS)), i)
    c = prog.compile()
    ops = c.ops[:, 0]
    assert (ops == cw.OP_INV).sum() == 1
    assert (ops == cw.OP_NZ1).sum() == (ops == cw.OP_ZSEL).sum() == k
    aux = torch.zeros((8, k, B), dtype=torch.int32)
    cw.gadgets_plain(c, aux, ins)
    assert torch.equal(aux, cuda_ff.inv_plain(FR, ins))
    assert int(aux[:, :, 2].abs().sum()) == 0


@pytest.mark.parametrize("name", ["confidential", "anonymous", "mini"])
def test_plan_programs_are_staged(name):
    """Every plan's rows have one writer (Plan.finish checks it), its
    programs' stages hold one class of operation each, no operation reads a
    slot written in its own stage, and no program loads a row it stores."""
    plan = {"confidential": twit.confidential_plan, "anonymous": wa.anonymous_plan,
            "mini": wm.mini_plan}[name]()
    assert plan.n_aux == {"confidential": 19955, "anonymous": 50429, "mini": 155}[name]
    assert sorted(plan.programs) == {"confidential": ["main"], "anonymous": ["crd", "lc", "main"],
                                     "mini": []}[name]
    for c in plan.programs.values():
        beg = 0
        for end in c.stage_end.tolist():
            st = c.ops[beg:end]
            beg = end
            kinds = {int(o) for o in st[:, 0]}
            assert kinds <= {cw.OP_MUL} or kinds <= {cw.OP_INV} or not (
                kinds & {cw.OP_MUL, cw.OP_INV})
            written = {int(d) for o, d in st[:, :2] if o != cw.OP_STORE}
            reads = {int(x) for o, x in st[:, (0, 2)] if o not in (cw.OP_LOAD, cw.OP_CONST)}
            reads |= {int(y) for o, y in st[:, (0, 3)]
                      if o in (cw.OP_MUL, cw.OP_ADD, cw.OP_SUB, cw.OP_ZSEL)}
            assert not written & reads
        loads = {int(x) for o, x, y in c.ops[:, [0, 2, 3]] if o == cw.OP_LOAD and y == cw.AUX}
        assert not loads & {int(d) for o, d in c.ops[:, :2] if o == cw.OP_STORE}
    if name == "confidential":  # one Fermat power a depth: four
        assert plan.programs["main"].counts["inv"] == 4


def test_confidential_witness_matches_jax_model():
    """The whole ConfidentialTransfer witness at B = 2 through the plain
    versions equals the synthesis of the JAX package's model (a JAX-free
    Python module) for both proofs, aux and public inputs."""
    from zerochain_tpu.models.confidential import ConfidentialTransfer as JConf
    from zerochain_tpu.r1cs.system import ConstraintSystem as JCS

    from test_torch_pipeline import confidential_assignments
    from zerochain_tpu_torch.prover import ConfidentialProver

    asg = confidential_assignments(2)
    aux, public = twit.confidential_witness(**twit.witness_inputs_host(asg, "cpu"))
    assert aux.shape == (8, 19955, 2) and public.shape == (8, 23, 2)
    for b, a in enumerate(asg):
        cs = JCS(track_names=False)
        JConf(**vars(ConfidentialProver.circuit_for(a))).synthesize(cs)
        assert cs.is_satisfied()
        assert FR.to_ints(public[:, :, b], mont=True) == [v % R for v in cs.inputs]
        got = FR.to_ints(aux[:, :, b], mont=True)
        bad = [i for i, (g, w) in enumerate(zip(got, cs.aux)) if g != w % R]
        assert len(got) == len(cs.aux) and not bad, f"first differing rows {bad[:5]}"


def test_wrappers_route_and_refuse():
    """CPU tensors take the plain versions (no launch counted); a meta
    tensor, a wrong dtype or a program's missing input rows raise; a host
    block left unwritten fails the plan's check."""
    prog = cw.Program()
    prog.store(prog.inv(prog.load(0, cw.INS)), 0)
    c = prog.compile()
    aux = torch.zeros((8, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        cw.gadgets(c, aux)
    with pytest.raises(ValueError):
        cw.gadgets(c, aux.to("meta"), torch.zeros((8, 1, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        cw.steps([], aux.to(torch.int64))
    cw.gadgets(c, aux, TL.ones_mont(FR, (1, 2)))
    assert torch.equal(aux, TL.ones_mont(FR, (1, 2)))      # 1/1
    assert all(v == 0 for v in cw.launches.values())
    plan = wm.mini_plan()
    rows = plan.rows(twit.new_aux(plan, 2, "cpu"))
    with pytest.raises(RuntimeError):
        rows.check()
