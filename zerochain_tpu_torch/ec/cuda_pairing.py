"""The BLS12-381 pairing's Miller loop and final exponentiation as staged Fq
programs, a warp a pairing (``csrc/pairing_kernel.cu``).

A *program* is a straight-line list of Fq operations (Montgomery multiply,
add, subtract, move, constant, load from an input row, store to an output
row, and one Fermat power a^(p-2)) on numbered SLOTS of 12 words, in SSA
form while it is built (:class:`Program`).  :func:`build_set` compiles a
list of programs into a :class:`ProgramSet`: each program is packed into
STAGES by its depth (all of a stage's operations are independent: the
multiplies of one depth form one stage, the Fermat powers the next, the
cheap operations the stages after them by their depth among themselves),
its temporaries get slots above the set's pinned slots, reused once their
last reader's stage has ended, and a symbolic run of every stage checks the
result: one writer a slot a stage, no slot read by one operation and
written by another in the same stage, every operand the value it stands
for, every output in its slot.  A *sequence* of (program, row base) pairs
is the control flow: the kernel walks it, adding the base to the rows its
loads and stores name.

Two sets, two launches a pairing call:

- :func:`miller_set` (launch count ``miller``): the G2 preparation and the
  multi-pair Miller loop of ``ec/pairing.py`` walking ``SCHED`` (62 steps,
  5 with an addition, then the final doubling).  The program of step k
  runs the f chain of step k (the line products into f, then f^2) beside
  the R chain of step k + 1 (doubling step, addition step where the bit is
  set), whose coefficients it keeps in pinned slots for the next program:
  the two chains are independent, so their multiplies share stages.  Three
  modes: ``pairing`` (points in, f out), ``prepare`` (G2 points in, the
  line coefficients out) and ``loop`` (G1 points and coefficients in, f
  out); any number of pairs share f, as ``miller_loop(pairs)`` does.
- :func:`final_exp_set` (launch count ``final_exp``): the final
  exponentiation of ``ec/pairing.py`` as programs over Fq12 registers (a
  multiply, a squaring, a squaring and a multiply for the powers by x, the
  Frobenius maps on constant slots, a conjugation, the Fq12 inverse down
  to ONE Fermat power).

``execute`` launches the kernel for CUDA tensors (or raises) and runs
``execute_plain`` for CPU tensors: the same sequence, stage by stage, each
stage's operations of one kind as one tensor op over the plain field ops of
``ff/cuda_ff.py``.  Every word is canonical, so the kernel's words equal
the plain version's, and both equal the tower chain's
(``ec/pairing.py: *_tower``) and the mirror's values.

Rows: an input or output is ``(12, rows, B)`` int32 words, word w of row r
of pairing b at ``(w * rows + r) * B + b``, Montgomery form.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..ff import cuda_ff
from ..ff import limbs as L
from ..mirror import field as mf
from ..mirror.field import BLS_X

FQ = L.FQ

launches = {"miller": 0, "final_exp": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# operation codes, as pairing_kernel.cu; an operation is (op, d, a, b):
#   MUL/ADD/SUB  slot d = slot a (op) slot b
#   MOV          slot d = slot a
#   CONST        slot d = constant a (CONSTS)
#   LOAD         slot d = input row a + base
#   STORE        output row d + base = slot a
#   INV          slot d = slot a ^ (p - 2)
(OP_MUL, OP_ADD, OP_SUB, OP_MOV, OP_CONST, OP_LOAD, OP_STORE, OP_INV) = range(8)
_IN = -1  # a pinned slot's value at the program's start
_HEAVY = (OP_MUL, OP_INV)
_BINARY = (OP_MUL, OP_ADD, OP_SUB)

# the limit of a set: a pairing's slots live in shared memory at a fixed
# stride (pairing_kernel.cu: PP_MAX_SLOTS, 24 KB a warp)
MAX_SLOTS = 512

# MSB-first bits of BLS_X >> 1 with the leading one skipped: the iteration
# schedule of the G2 preparation and the Miller loop (62 steps, 5 set)
_XBITS = [(BLS_X >> 1 >> i) & 1 for i in range(63, -1, -1)]
SCHED = tuple(bool(b) for b in _XBITS[_XBITS.index(1) + 1:])
N_STEPS = len(SCHED) + 1  # the scheduled steps and the final doubling
STEP_ROWS = 12  # a step's coefficient rows: kind (dbl, add) x comp x 3


# ---------------------------------------------------------------------
# constants: zero, one and the Frobenius coefficients' components
# ---------------------------------------------------------------------
def _const_values():
    vals = [0, 1]
    for table in (mf.FROBENIUS_COEFF_FQ6_C1, mf.FROBENIUS_COEFF_FQ6_C2,
                  mf.FROBENIUS_COEFF_FQ12_C1):
        for pair in table:
            vals += [v for v in pair if v not in vals]
    return tuple(vals)


CONSTS = _const_values()
_CONST_AT = {v: k for k, v in enumerate(CONSTS)}
_CONSTS_DEV: dict = {}


def _consts(device):
    """CONSTS as Montgomery words (12, n_consts), once a device."""
    key = str(device)
    got = _CONSTS_DEV.get(key)
    if got is None:
        got = _CONSTS_DEV[key] = FQ.array(list(CONSTS), device, mont=True)
    return got


# ---------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------
class Program:
    """One straight-line Fq program in SSA form: each method returns a value
    id.  ``pin(slot)`` is the value a pinned slot holds when the program
    starts; ``out(v, slot)`` leaves v in a pinned slot when it ends;
    ``store(v, row)`` writes v to an output row.  Equal operations are one
    value (and a multiply or an add of x and y one of y and x)."""

    def __init__(self, name=""):
        self.name = name
        self.nodes = []   # (op, a, b); _IN (slot), CONST (k), LOAD (row)
        self.outs = []    # (value, slot)
        self.stores = []  # (value, row)
        self._memo = {}

    def _node(self, op, a=0, b=0):
        if op in (OP_MUL, OP_ADD) and a > b:
            a, b = b, a
        key = (op, a, b)
        got = self._memo.get(key)
        if got is None:
            self.nodes.append(key)
            got = self._memo[key] = len(self.nodes) - 1
        return got

    def pin(self, slot):
        return self._node(_IN, int(slot))

    def const(self, value: int):
        """The constant ``value`` (an element of CONSTS, as an int)."""
        return self._node(OP_CONST, _CONST_AT[value % mf.Q])

    def load(self, row):
        return self._node(OP_LOAD, int(row))

    def mul(self, a, b):
        return self._node(OP_MUL, a, b)

    def add(self, a, b):
        return self._node(OP_ADD, a, b)

    def sub(self, a, b):
        return self._node(OP_SUB, a, b)

    def inv(self, a):
        return self._node(OP_INV, a)

    def mov(self, a):
        return self._node(OP_MOV, a)

    def out(self, v, slot):
        self.outs.append((v, int(slot)))

    def store(self, v, row):
        self.stores.append((v, int(row)))


def _operands(node):
    op, a, b = node
    if op in _BINARY:
        return (a, b)
    return (a,) if op in (OP_MOV, OP_INV) else ()


class _Compiled(NamedTuple):
    stages: list       # of lists of (op, d, a, b)
    top: int           # one past the highest slot used
    loads: list        # rows loaded
    stored: list       # rows stored


def _compile(prog: Program, base: int) -> _Compiled:
    """Stages and slots of one program; temporaries at slots >= base, the
    slots below it pinned.  Raises if the result fails the symbolic run."""
    nodes = list(prog.nodes)
    outs = []
    for v, s in prog.outs:
        if nodes[v][0] == _IN:
            if nodes[v][1] == s:
                continue  # already there
            nodes.append((OP_MOV, v, 0))
            v = len(nodes) - 1
        outs.append((v, s))
    if len({s for _, s in outs}) != len(outs):
        raise ValueError(f"program {prog.name}: a slot is an output twice")
    if any(s >= base for _, s in outs) or any(
            n[0] == _IN and n[1] >= base for n in nodes):
        raise ValueError(f"program {prog.name}: a pinned slot at or above {base}")
    n = len(nodes)
    live = [False] * n
    stack = [v for v, _ in outs] + [v for v, _ in prog.stores]
    while stack:
        v = stack.pop()
        if not live[v]:
            live[v] = True
            stack.extend(_operands(nodes[v]))

    # depth: a multiply or a Fermat power is one more than its operands'
    # highest depth, a cheap operation the highest
    lvl = [0] * n
    items = []
    for i in range(n):
        if live[i] and nodes[i][0] != _IN:
            top = max((lvl[x] for x in _operands(nodes[i])), default=0)
            lvl[i] = top + 1 if nodes[i][0] in _HEAVY else top
            items.append(i)
    stores = list(range(n, n + len(prog.stores)))

    def args(i):
        return (prog.stores[i - n][0],) if i >= n else _operands(nodes[i])

    def level(i):
        return lvl[prog.stores[i - n][0]] if i >= n else lvl[i]

    # stages, level by level: the multiplies, then the Fermat powers, then
    # the cheap operations (and the stores) by their rank among the cheap
    # operations of the level (one more than their cheap operands' rank)
    rank, key = {}, {}
    for i in items + stores:
        if i < n and nodes[i][0] in _HEAVY:
            key[i] = (lvl[i], _HEAVY.index(nodes[i][0]), 0)
            continue
        rank[i] = 1 + max((rank[x] for x in args(i) if x in rank and level(x) == level(i)),
                          default=0)
        key[i] = (level(i), 2, rank[i])
    order = {k: st for st, k in enumerate(sorted(set(key.values())))}
    stages_items = [[] for _ in order]
    for i in items + stores:
        stages_items[order[key[i]]].append(i)
    n_stages = len(stages_items)
    stage_of = {i: order[key[i]] for i in items + stores}

    # readers: the last stage each value is read in, by another operation
    reads = {}
    for i in items + stores:
        for x in args(i):
            reads.setdefault(x, []).append((stage_of[i], i))
    pinned_in = {nodes[i][1]: i for i in range(n) if live[i] and nodes[i][0] == _IN}

    # an output goes straight to its slot if every other reader of the
    # slot's old value reads it in an earlier stage; else through a
    # temporary and a move in a last stage
    direct, movs = {}, []
    for v, s in outs:
        old = pinned_in.get(s)
        last = max((st for st, r in reads.get(old, ()) if r != v), default=-1)
        if v not in direct and stage_of[v] > last:
            direct[v] = s
        else:
            movs.append((v, s))
    last_read = {x: max(st for st, _ in rs) for x, rs in reads.items()}
    for v, _ in movs:
        last_read[v] = n_stages

    # slots: a temporary's slot is free again after its last reader's stage
    slot = {i: nodes[i][1] for i in pinned_in.values()}
    slot.update(direct)
    free, top = [], base
    for st, group in enumerate(stages_items):
        for i in group:
            if i < n and i not in slot:
                if free:
                    slot[i] = heapq.heappop(free)
                else:
                    slot[i], top = top, top + 1
        read = {x for i in group for x in args(i)}
        for x in sorted(read):
            if last_read[x] == st and slot[x] >= base:
                heapq.heappush(free, slot[x])

    # emit, and keep each operation's (destination value, operand values)
    # for the symbolic run
    stages, meta = [], []
    for group in stages_items:
        rows, mrows = [], []
        for i in sorted(group, key=lambda i: (OP_STORE if i >= n else nodes[i][0], i)):
            if i >= n:
                v, row = prog.stores[i - n]
                rows.append((OP_STORE, row, slot[v], 0))
                mrows.append((None, (v,)))
                continue
            op, a, b = nodes[i]
            xs = _operands(nodes[i])
            if op in (OP_CONST, OP_LOAD):
                rows.append((op, slot[i], a, 0))
            else:
                rows.append((op, slot[i], *[slot[x] for x in xs], *([0] * (2 - len(xs)))))
            mrows.append((i, xs))
        stages.append(rows)
        meta.append(mrows)
    if movs:
        stages.append([(OP_MOV, s, slot[v], 0) for v, s in movs])
        meta.append([(v, (v,)) for v, _ in movs])
    _symbolic_run(prog, nodes, stages, meta, outs, base)
    loads = [nodes[i][1] for i in items if nodes[i][0] == OP_LOAD]
    return _Compiled(stages, max(top, base), loads, [row for _, row in prog.stores])


def _reads(op, a, b):
    """The slots an operation reads."""
    if op in _BINARY:
        return (a, b)
    return (a,) if op in (OP_MOV, OP_INV, OP_STORE) else ()


def _symbolic_run(prog, nodes, stages, meta, outs, base):
    """Step the compiled stages on value ids: each operand slot holds the
    value it stands for, a stage writes each slot once and no operation
    reads a slot that another writes in the same stage (the lanes of a
    stage run in no fixed order), no pinned slot but an output is written,
    and every output ends in its slot."""
    outs_at = {s for _, s in outs}

    def want(v):
        return ("in", nodes[v][1]) if nodes[v][0] == _IN else v

    content = {}
    for st, (rows, mrows) in enumerate(zip(stages, meta)):
        writes = {}
        for k, ((op, d, a, b), (v, xs)) in enumerate(zip(rows, mrows)):
            for slot_, x in zip(_reads(op, a, b), xs):
                if content.get(slot_, ("in", slot_)) != want(x):
                    raise ValueError(f"program {prog.name}: stage {st} reads slot "
                                     f"{slot_} for value {x}, which is not there")
            if op == OP_STORE:
                continue
            if d in writes:
                raise ValueError(f"program {prog.name}: stage {st} writes slot {d} twice")
            if d < base and d not in outs_at:
                raise ValueError(f"program {prog.name}: stage {st} writes pinned slot {d}")
            writes[d] = (k, v)
        for k, (op, d, a, b) in enumerate(rows):
            if any(writes.get(x, (k,))[0] != k for x in _reads(op, a, b)):
                raise ValueError(f"program {prog.name}: stage {st} reads a slot that "
                                 "another operation writes")
        for d, (_, v) in writes.items():
            content[d] = v
    for v, s in outs:
        if content.get(s, ("in", s)) != want(v):
            raise ValueError(f"program {prog.name}: output slot {s} does not hold "
                             f"value {v}")


class ProgramSet(NamedTuple):
    """A compiled set: ``ops`` (n_ops, 4) int32 rows (op, d, a, b) as
    pairing_kernel.cu reads them, ``stage_end`` (n_stages,) (stage s: ops
    [stage_end[s - 1], stage_end[s])), ``prog_stage`` (n_progs + 1,)
    (program p: stages [prog_stage[p], prog_stage[p + 1])), ``seq``
    (n_seq, 2) (program, row base), ``n_slots`` a pairing's slots, and the
    input and output rows."""

    kind: str
    ops: np.ndarray
    stage_end: np.ndarray
    prog_stage: np.ndarray
    seq: np.ndarray
    n_slots: int
    n_in: int
    n_out: int

    @property
    def counts(self) -> dict:
        """Per pairing: the operations the sequence runs by kind, its stages,
        and the set's slots and programs."""
        per_prog = []
        for p in range(len(self.prog_stage) - 1):
            beg = self.stage_end[self.prog_stage[p] - 1] if self.prog_stage[p] else 0
            end = self.stage_end[self.prog_stage[p + 1] - 1] if self.prog_stage[p + 1] else 0
            per_prog.append(np.bincount(self.ops[beg:end, 0], minlength=8))
        ran = sum(per_prog[p] for p in self.seq[:, 0])
        stages = sum(int(self.prog_stage[p + 1] - self.prog_stage[p]) for p in self.seq[:, 0])
        mul_stages = 0
        for p in self.seq[:, 0]:
            for st in range(self.prog_stage[p], self.prog_stage[p + 1]):
                beg = self.stage_end[st - 1] if st else 0
                mul_stages += int(self.ops[beg, 0] == OP_MUL)
        return {"mul": int(ran[OP_MUL]), "inv": int(ran[OP_INV]),
                "linear": int(ran[OP_ADD] + ran[OP_SUB] + ran[OP_MOV]),
                "load": int(ran[OP_LOAD]), "store": int(ran[OP_STORE]),
                "stages": stages, "mul_stages": mul_stages, "slots": self.n_slots,
                "programs": len(self.prog_stage) - 1, "sequence": len(self.seq)}


def check_stages(pset: ProgramSet) -> None:
    """Raise unless, in every stage of the set, each slot has one writer, no
    operation reads a slot that another writes (the lanes of a stage run in
    no fixed order), and every slot is below n_slots."""
    beg = 0
    for st, end in enumerate(pset.stage_end.tolist()):
        writer, rows = {}, pset.ops[beg:end].tolist()
        beg = end
        for k, (op, d, a, b) in enumerate(rows):
            dst = () if op == OP_STORE else (d,)
            if any(not 0 <= x < pset.n_slots for x in _reads(op, a, b) + dst):
                raise ValueError(f"{pset.kind}: stage {st} names a slot past {pset.n_slots}")
            for x in dst:
                if x in writer:
                    raise ValueError(f"{pset.kind}: stage {st} writes slot {x} twice")
                writer[x] = k
        for k, (op, d, a, b) in enumerate(rows):
            if any(writer.get(x, k) != k for x in _reads(op, a, b)):
                raise ValueError(f"{pset.kind}: stage {st} reads a slot that another "
                                 "operation writes")


def build_set(kind, programs, seq, n_pinned, n_in, n_out) -> ProgramSet:
    """Compile ``programs`` (temporaries above the ``n_pinned`` pinned
    slots) and the sequence ``seq`` of (program index, row base).  Raises
    if the slots pass MAX_SLOTS, a load or store falls outside the rows, or
    an output row is never stored."""
    compiled = [_compile(p, n_pinned) for p in programs]
    ops, ends, pstage = [], [], [0]
    for c in compiled:
        for st in c.stages:
            ops += st
            ends.append(len(ops))
        pstage.append(len(ends))
    n_slots = max([n_pinned] + [c.top for c in compiled])
    if n_slots > MAX_SLOTS:
        raise OverflowError(f"{kind} program set: {n_slots} slots, the limit is {MAX_SLOTS}")
    stored = set()
    for p, row_base in seq:
        c = compiled[p]
        if any(not 0 <= r + row_base < n_in for r in c.loads):
            raise ValueError(f"{kind}: program {programs[p].name} loads past the input rows")
        if any(not 0 <= r + row_base < n_out for r in c.stored):
            raise ValueError(f"{kind}: program {programs[p].name} stores past the output rows")
        stored.update(r + row_base for r in c.stored)
    if stored != set(range(n_out)):
        raise ValueError(f"{kind}: output rows {sorted(set(range(n_out)) - stored)[:8]} "
                         "are never stored")
    pset = ProgramSet(kind, np.asarray(ops, dtype=np.int32).reshape(-1, 4),
                      np.asarray(ends, dtype=np.int32), np.asarray(pstage, dtype=np.int32),
                      np.asarray(seq, dtype=np.int32).reshape(-1, 2), n_slots, n_in, n_out)
    check_stages(pset)
    return pset


# ---------------------------------------------------------------------
# the tower over a program's values: Fq2 = (c0, c1), Fq6 = 3 x Fq2,
# Fq12 = 2 x Fq6, the formulas of ec/tower.py and the mirror
# ---------------------------------------------------------------------
class _Tower:
    def __init__(self, p: Program):
        self.p = p

    # Fq2
    def add2(self, a, b):
        return (self.p.add(a[0], b[0]), self.p.add(a[1], b[1]))

    def sub2(self, a, b):
        return (self.p.sub(a[0], b[0]), self.p.sub(a[1], b[1]))

    def neg2(self, a):
        z = self.p.const(0)
        return (self.p.sub(z, a[0]), self.p.sub(z, a[1]))

    def dbl2(self, a):
        return self.add2(a, a)

    def mul2(self, a, b):
        p = self.p
        aa, bb = p.mul(a[0], b[0]), p.mul(a[1], b[1])
        o = p.mul(p.add(a[0], a[1]), p.add(b[0], b[1]))
        return (p.sub(aa, bb), p.sub(o, p.add(aa, bb)))

    def sqr2(self, a):
        p = self.p
        ab = p.mul(a[0], a[1])
        return (p.mul(p.add(a[0], a[1]), p.sub(a[0], a[1])), p.add(ab, ab))

    def mulfq2(self, a, s):
        return (self.p.mul(a[0], s), self.p.mul(a[1], s))

    def nr2(self, a):
        """times xi = 1 + u"""
        return (self.p.sub(a[0], a[1]), self.p.add(a[0], a[1]))

    def conj2(self, a):
        return (a[0], self.p.sub(self.p.const(0), a[1]))

    def mulc2(self, a, k):
        """times the Fq2 constant k = (k0, k1), ints."""
        p = self.p
        k0, k1 = (x % mf.Q for x in k)
        if k1 == 0:
            return self.mulfq2(a, p.const(k0))
        if k0 == 0:  # (a0 + a1 u) k1 u = -a1 k1 + a0 k1 u
            c = p.const(k1)
            return (p.sub(p.const(0), p.mul(a[1], c)), p.mul(a[0], c))
        return self.mul2(a, (p.const(k0), p.const(k1)))

    def inv2(self, a):
        """(c0 - c1 u) / (c0^2 + c1^2): the one Fermat power."""
        p = self.p
        t = p.inv(p.add(p.mul(a[0], a[0]), p.mul(a[1], a[1])))
        return (p.mul(a[0], t), p.sub(p.const(0), p.mul(a[1], t)))

    # Fq6
    def add6(self, a, b):
        return tuple(self.add2(x, y) for x, y in zip(a, b))

    def sub6(self, a, b):
        return tuple(self.sub2(x, y) for x, y in zip(a, b))

    def neg6(self, a):
        return tuple(self.neg2(x) for x in a)

    def nr6(self, a):
        return (self.nr2(a[2]), a[0], a[1])

    def mul6(self, a, b):
        a0, a1, a2 = a
        b0, b1, b2 = b
        v0, v1, v2 = self.mul2(a0, b0), self.mul2(a1, b1), self.mul2(a2, b2)
        t0 = self.sub2(self.mul2(self.add2(a1, a2), self.add2(b1, b2)), self.add2(v1, v2))
        t1 = self.sub2(self.mul2(self.add2(a0, a1), self.add2(b0, b1)), self.add2(v0, v1))
        t2 = self.sub2(self.mul2(self.add2(a0, a2), self.add2(b0, b2)), self.add2(v0, v2))
        return (self.add2(self.nr2(t0), v0), self.add2(t1, self.nr2(v2)), self.add2(t2, v1))

    def mul6_01(self, a, c0, c1):
        """times (c0, c1, 0): five Fq2 products."""
        a0, a1, a2 = a
        aa, bb = self.mul2(a0, c0), self.mul2(a1, c1)
        t1 = self.add2(self.nr2(self.sub2(self.mul2(c1, self.add2(a1, a2)), bb)), aa)
        t3 = self.add2(self.sub2(self.mul2(c0, self.add2(a0, a2)), aa), bb)
        t2 = self.sub2(self.sub2(self.mul2(self.add2(c0, c1), self.add2(a0, a1)), aa), bb)
        return (t1, t2, t3)

    def mul6_1(self, a, c1):
        """times (0, c1, 0): three Fq2 products."""
        a0, a1, a2 = a
        bb = self.mul2(a1, c1)
        t1 = self.nr2(self.sub2(self.mul2(c1, self.add2(a1, a2)), bb))
        t2 = self.sub2(self.mul2(c1, self.add2(a0, a1)), bb)
        return (t1, t2, bb)

    def sqr6(self, a):
        """a^2 as in fq6.rs (CH-SQR2 shape): two squarings fewer than mul6."""
        a0, a1, a2 = a
        s0 = self.sqr2(a0)
        ab = self.mul2(a0, a1)
        s1 = self.dbl2(ab)
        s2 = self.sqr2(self.add2(self.sub2(a0, a1), a2))
        bc = self.mul2(a1, a2)
        s3 = self.dbl2(bc)
        s4 = self.sqr2(a2)
        c0 = self.add2(self.nr2(s3), s0)
        c1 = self.add2(self.nr2(s4), s1)
        c2 = self.sub2(self.sub2(self.add2(self.add2(s1, s2), s3), s0), s4)
        return (c0, c1, c2)

    def inv6(self, a):
        a0, a1, a2 = a
        c0 = self.sub2(self.sqr2(a0), self.nr2(self.mul2(a1, a2)))
        c1 = self.sub2(self.nr2(self.sqr2(a2)), self.mul2(a0, a1))
        c2 = self.sub2(self.sqr2(a1), self.mul2(a0, a2))
        t = self.inv2(self.add2(self.nr2(self.add2(self.mul2(a2, c1), self.mul2(a1, c2))),
                                self.mul2(a0, c0)))
        return (self.mul2(t, c0), self.mul2(t, c1), self.mul2(t, c2))

    def frob6(self, a, power):
        q = power % 6
        f = (lambda x: self.conj2(x)) if q % 2 else (lambda x: x)
        return (f(a[0]), self.mulc2(f(a[1]), mf.FROBENIUS_COEFF_FQ6_C1[q]),
                self.mulc2(f(a[2]), mf.FROBENIUS_COEFF_FQ6_C2[q]))

    # Fq12
    def mul12(self, a, b):
        aa, bb = self.mul6(a[0], b[0]), self.mul6(a[1], b[1])
        o = self.mul6(self.add6(a[0], a[1]), self.add6(b[0], b[1]))
        return (self.add6(self.nr6(bb), aa), self.sub6(self.sub6(o, aa), bb))

    def sqr12(self, a):
        a0, a1 = a
        ab = self.mul6(a0, a1)
        v = self.mul6(self.add6(self.nr6(a1), a0), self.add6(a0, a1))
        return (self.sub6(self.sub6(v, ab), self.nr6(ab)), self.add6(ab, ab))

    def cyc_sqr12(self, a):
        """a^2 for a in the cyclotomic subgroup (Granger-Scott, as the
        bls12_381 crate's cyclotomic_square): nine Fq2 squarings, 18 Fq
        multiplies.  Every value of the final exponentiation's hard part is
        in that subgroup, where this is the square."""
        (z0, z4, z3), (z2, z1, z5) = a

        def fp4_sqr(x, y):
            t0, t1 = self.sqr2(x), self.sqr2(y)
            return (self.add2(self.nr2(t1), t0),
                    self.sub2(self.sub2(self.sqr2(self.add2(x, y)), t0), t1))

        def three_minus_two(t, z):  # 3 t - 2 z
            return self.add2(self.dbl2(self.sub2(t, z)), t)

        def three_plus_two(t, z):  # 3 t + 2 z
            return self.add2(self.dbl2(self.add2(t, z)), t)

        t0, t1 = fp4_sqr(z0, z1)
        t2, t3 = fp4_sqr(z2, z3)
        t4, t5 = fp4_sqr(z4, z5)
        return ((three_minus_two(t0, z0), three_minus_two(t2, z4), three_minus_two(t4, z3)),
                (three_plus_two(self.nr2(t5), z2), three_plus_two(t1, z1),
                 three_plus_two(t3, z5)))

    def conj12(self, a):
        return (a[0], self.neg6(a[1]))

    def inv12(self, a):
        t = self.inv6(self.sub6(self.sqr6(a[0]), self.nr6(self.sqr6(a[1]))))
        return (self.mul6(a[0], t), self.neg6(self.mul6(a[1], t)))

    def frob12(self, a, power):
        q = power % 12
        c1 = self.frob6(a[1], q)
        k = mf.FROBENIUS_COEFF_FQ12_C1[q]
        return (self.frob6(a[0], q), tuple(self.mulc2(x, k) for x in c1))

    def mul12_014(self, a, c0, c1, c4):
        """times the line (c0, c1, 0; 0, c4, 0): 13 Fq2 products."""
        aa = self.mul6_01(a[0], c0, c1)
        bb = self.mul6_1(a[1], c4)
        c1n = self.sub6(self.sub6(self.mul6_01(self.add6(a[1], a[0]), c0,
                                               self.add2(c1, c4)), aa), bb)
        return (self.add6(self.nr6(bb), aa), c1n)


def _fq12_at(fn):
    """Fq12 component (h, i, c) -> fn(h * 6 + i * 2 + c, ...) as a nested
    tuple."""
    return tuple(tuple((fn(h * 6 + i * 2, h, i, 0), fn(h * 6 + i * 2 + 1, h, i, 1))
                       for i in range(3)) for h in range(2))


def fq12_row(h, i, c):
    """The row of Fq12 component (h, i, c) in a (12, 12, B) view of an
    ec/tower.py Fq12 tensor (12, 2, 3, 2, B): c * 6 + i * 2 + h."""
    return c * 6 + i * 2 + h


def _reg12(p, base):
    return _fq12_at(lambda k, h, i, c: p.pin(base + k))


def _out12(p, x, base):
    for h in range(2):
        for i in range(3):
            for c in range(2):
                p.out(x[h][i][c], base + h * 6 + i * 2 + c)


def _load12(p, row0=0):
    return _fq12_at(lambda k, h, i, c: p.load(row0 + fq12_row(h, i, c)))


def _store12(p, x, row0=0):
    for h in range(2):
        for i in range(3):
            for c in range(2):
                p.store(x[h][i][c], row0 + fq12_row(h, i, c))


# ---------------------------------------------------------------------
# the Miller loop: pairing, prepare, loop
# ---------------------------------------------------------------------
def doubling_step(t: _Tower, r):
    """ec/pairing.py's _doubling_step on single values: R = (rx, ry, rz)
    Fq2 -> (new R, coefficients (c0, c1, c2))."""
    rx, ry, rz = r
    tmp0, tmp1, zsq = t.sqr2(rx), t.sqr2(ry), t.sqr2(rz)
    tmp2 = t.sqr2(tmp1)
    tmp3 = t.dbl2(t.sub2(t.sub2(t.sqr2(t.add2(tmp1, rx)), tmp0), tmp2))
    nrz = t.sub2(t.sub2(t.sqr2(t.add2(rz, ry)), tmp1), zsq)
    tmp4 = t.add2(t.dbl2(tmp0), tmp0)
    tmp6 = t.add2(rx, tmp4)
    tmp5 = t.sqr2(tmp4)
    nrx = t.sub2(t.sub2(tmp5, tmp3), tmp3)
    k0 = t.dbl2(t.dbl2(tmp2))
    nry = t.sub2(t.mul2(t.sub2(tmp3, nrx), tmp4), t.dbl2(k0))
    c0 = t.dbl2(t.mul2(nrz, zsq))
    c1 = t.neg2(t.dbl2(t.mul2(tmp4, zsq)))
    c2 = t.sub2(t.sub2(t.sqr2(tmp6), tmp0), t.add2(tmp5, t.dbl2(t.dbl2(tmp1))))
    return (nrx, nry, nrz), (c0, c1, c2)


def addition_step(t: _Tower, r, qx, qy):
    """ec/pairing.py's _addition_step on single values."""
    rx, ry, rz = r
    zsq, ysq = t.sqr2(rz), t.sqr2(qy)
    u = t.sub2(t.sub2(t.sqr2(t.add2(qy, rz)), ysq), zsq)
    t2 = t.sub2(t.mul2(zsq, qx), rx)
    t6 = t.sub2(t.sub2(t.mul2(u, zsq), ry), ry)
    t3 = t.sqr2(t2)
    t4 = t.dbl2(t.dbl2(t3))
    t5, t9, t7 = t.mul2(t4, t2), t.mul2(t6, qx), t.mul2(t4, rx)
    nrx = t.sub2(t.sub2(t.sub2(t.sqr2(t6), t5), t7), t7)
    nrz = t.sub2(t.sub2(t.sqr2(t.add2(rz, t2)), zsq), t3)
    nry = t.sub2(t.mul2(t.sub2(t7, nrx), t6), t.dbl2(t.mul2(ry, t5)))
    t10 = t.sub2(t.sub2(t.sqr2(t.add2(qy, nrz)), ysq), t.sqr2(nrz))
    c2 = t.sub2(t.dbl2(t9), t10)
    return (nrx, nry, nrz), (t.dbl2(nrz), t.dbl2(t.neg2(t6)), c2)


def ell(t: _Tower, f, c, px, py):
    """f times the line of coefficients c at P: (c2, c1 px, 0; 0, c0 py, 0)."""
    return t.mul12_014(f, c[2], t.mulfq2(c[1], px), t.mulfq2(c[0], py))


MODES = ("pairing", "prepare", "loop")
_PAIR_SLOTS = 24  # P (2), Q (4), R (6), the doubling's and the addition's coefficients (6 + 6)


class _MillerLayout:
    """Pinned slots and rows of a Miller set of n pairs.

    Slots: f at 0..11 (Fq12 component (h, i, c) at h * 6 + i * 2 + c); pair
    j from 12 + 24 j: px, py, qx (2), qy (2), rx, ry, rz (2 each), the
    doubling's coefficients (c0, c1, c2; 2 each), the addition's.
    Input rows: ``pairing`` 6 a pair (px, py, qx.c0, qx.c1, qy.c0, qy.c1);
    ``prepare`` 4 a pair (qx, qy); ``loop`` 2 a pair (px, py), then pair
    j's coefficient rows.  Coefficient rows (``prepare``'s output, ``loop``'s
    input) of pair j, step k: j * N_STEPS * 12 + k * 12 + kind * 6 + c * 3 +
    i (kind 0 the doubling's, 1 the addition's; coefficient i, component c),
    so that a (12, N_STEPS, 2, 2, 3, B) view has ec/pairing.py's (12, 2, 3)
    coefficient triples at [:, k, kind]; a step's program names them from
    its row base k * 12.  Output rows of ``pairing`` / ``loop``: f, as
    fq12_row."""

    def __init__(self, mode, n):
        self.mode, self.n = mode, n
        self.n_pinned = 12 + _PAIR_SLOTS * n
        self.per_pair = {"pairing": 6, "prepare": 4, "loop": 2}[mode]
        self.coeff0 = self.per_pair * n if mode == "loop" else 0
        coeff_rows = N_STEPS * STEP_ROWS * n
        self.n_in = self.per_pair * n + (coeff_rows if mode == "loop" else 0)
        self.n_out = coeff_rows if mode == "prepare" else 12

    def slot(self, j, what, k=0):
        off = {"px": 0, "py": 1, "qx": 2, "qy": 4, "r": 6, "cd": 12, "ca": 18}[what]
        return 12 + _PAIR_SLOTS * j + off + k

    def in_row(self, j, what):
        names = {"pairing": ("px", "py", "qx0", "qx1", "qy0", "qy1"),
                 "prepare": ("qx0", "qx1", "qy0", "qy1"), "loop": ("px", "py")}[self.mode]
        return self.per_pair * j + names.index(what)

    def coeff_row(self, j, kind, i, c):
        return self.coeff0 + j * N_STEPS * STEP_ROWS + kind * 6 + c * 3 + i


def _fq2_pins(p, s0):
    return (p.pin(s0), p.pin(s0 + 1))


def _coeff_pins(p, s0):
    return tuple(_fq2_pins(p, s0 + 2 * i) for i in range(3))


def _r_chain(p, t, lay, j, k, coeff_out):
    """The R chain of step k for pair j: the doubling step, then the
    addition step where SCHED[k] is set (k < 62); k = 62 is the final
    doubling, whose R nobody reads.  Coefficients go to the pinned slots
    (``pairing``) or to the coefficient rows (``prepare``)."""
    r = tuple(_fq2_pins(p, lay.slot(j, "r", 2 * m)) for m in range(3))
    qx, qy = _fq2_pins(p, lay.slot(j, "qx")), _fq2_pins(p, lay.slot(j, "qy"))
    r, cd = doubling_step(t, r)
    coeff_out(cd, 0)
    if k < len(SCHED) and SCHED[k]:
        r, ca = addition_step(t, r, qx, qy)
        coeff_out(ca, 1)
    elif lay.mode == "prepare":  # every coefficient row is written
        zero = p.const(0)
        coeff_out(((zero, zero),) * 3, 1)
    if k < len(SCHED):
        for m in range(3):
            for c in range(2):
                p.out(r[m][c], lay.slot(j, "r", 2 * m + c))


def _coeff_sink(p, lay, j):
    def sink(coeffs, kind):
        for i in range(3):
            for c in range(2):
                if lay.mode == "prepare":
                    p.store(coeffs[i][c], lay.coeff_row(j, kind, i, c))
                else:
                    p.out(coeffs[i][c], lay.slot(j, "cd" if kind == 0 else "ca", 2 * i + c))
    return sink


def _prologue(lay) -> Program:
    """f = 1; the points into their slots; R = (qx, qy, 1)."""
    p = Program("prologue")
    if lay.mode != "prepare":
        one, zero = p.const(1), p.const(0)
        _out12(p, _fq12_at(lambda k, h, i, c: one if k == 0 else zero), 0)
    for j in range(lay.n):
        if lay.mode != "prepare":
            p.out(p.load(lay.in_row(j, "px")), lay.slot(j, "px"))
            p.out(p.load(lay.in_row(j, "py")), lay.slot(j, "py"))
        if lay.mode == "loop":
            continue
        q = [p.load(lay.in_row(j, w)) for w in ("qx0", "qx1", "qy0", "qy1")]
        for m, v in enumerate(q):
            p.out(v, lay.slot(j, "qx", m))
        for m, v in enumerate(q + [p.const(1), p.const(0)]):
            p.out(v, lay.slot(j, "r", m))
    return p


def _step(lay, k) -> Program:
    """Step k's program: the f chain of step k (k >= 0, modes pairing and
    loop) and the R chain of step k + 1 (k + 1 <= 62, modes pairing and
    prepare)."""
    p = Program(f"step{k}")
    t = _Tower(p)
    if k >= 0 and lay.mode != "prepare":
        f = _reg12(p, 0)
        bit = k < len(SCHED) and SCHED[k]
        for kind in ((0, 1) if bit else (0,)):
            for j in range(lay.n):
                if lay.mode == "loop":
                    c = tuple((p.load(lay.coeff_row(j, kind, i, 0)),
                               p.load(lay.coeff_row(j, kind, i, 1))) for i in range(3))
                else:
                    c = _coeff_pins(p, lay.slot(j, "cd" if kind == 0 else "ca"))
                f = ell(t, f, c, p.pin(lay.slot(j, "px")), p.pin(lay.slot(j, "py")))
        if k < len(SCHED):
            f = t.sqr12(f)
        _out12(p, f, 0)
    if lay.mode != "loop" and k + 1 < N_STEPS:
        for j in range(lay.n):
            _r_chain(p, t, lay, j, k + 1, _coeff_sink(p, lay, j))
    return p


def _epilogue(lay) -> Program:
    p = Program("epilogue")
    _store12(p, _Tower(p).conj12(_reg12(p, 0)))  # BLS_X < 0
    return p


@functools.lru_cache(maxsize=None)
def miller_set(mode: str, n_pairs: int = 1) -> ProgramSet:
    """The Miller set of ``mode`` for n_pairs pairs sharing f (see
    _MillerLayout for its rows)."""
    if mode not in MODES or n_pairs < 1:
        raise ValueError(f"miller_set({mode!r}, {n_pairs})")
    lay = _MillerLayout(mode, n_pairs)
    progs, index, seq = [], {}, []

    def add(prog_key, build, base):
        if prog_key not in index:
            index[prog_key] = len(progs)
            progs.append(build())
        seq.append((index[prog_key], base))

    add(("prologue",), lambda: _prologue(lay), 0)
    f_chain = mode != "prepare"
    for k in range(0 if mode == "loop" else -1, N_STEPS if f_chain else N_STEPS - 1):
        bit = 0 <= k < len(SCHED) and SCHED[k]
        nxt = (k + 1 < len(SCHED) and SCHED[k + 1], k + 1 == len(SCHED))
        key = ("step", bit if f_chain and k >= 0 else None, k == len(SCHED),
               nxt if mode != "loop" else None)
        base = {"pairing": 0, "prepare": (k + 1) * STEP_ROWS, "loop": k * STEP_ROWS}[mode]
        add(key, lambda k=k: _step(lay, k), base)
    if f_chain:
        add(("epilogue",), lambda: _epilogue(lay), 0)
    return build_set("miller", progs, seq, lay.n_pinned, lay.n_in, lay.n_out)


# ---------------------------------------------------------------------
# the final exponentiation over Fq12 registers
# ---------------------------------------------------------------------
_REGS = ("r", "f1", "f2", "rr", "y0", "y1", "y2", "y3", "acc", "t")


def _reg(name):
    return 12 * _REGS.index(name)


def _fe_program(key) -> Program:
    op, *args = key
    p = Program("/".join(map(str, key)))
    t = _Tower(p)
    if op == "load":
        _out12(p, _load12(p), _reg(args[0]))
        return p
    if op == "store":
        _store12(p, _reg12(p, _reg(args[0])))
        return p
    src = _reg12(p, _reg(args[0]))
    if op == "conj":
        x = t.conj12(src)
    elif op == "inv":
        x = t.inv12(src)
    elif op == "sqr":  # every squaring of final_exp_script is in the hard part
        x = t.cyc_sqr12(src)
    elif op == "mul":
        x = t.mul12(src, _reg12(p, _reg(args[1])))
    elif op == "sqrmul":
        x = t.mul12(t.cyc_sqr12(src), _reg12(p, _reg(args[1])))
    elif op == "frob":
        x = t.frob12(src, args[1])
    else:
        raise ValueError(key)
    _out12(p, x, _reg(args[-1]))
    return p


def final_exp_script():
    """ec/pairing.py's final_exponentiation (mod.rs:104-160) as a list of
    register operations (op, operands..., destination)."""
    s = []

    def pow_(src, e):  # -> acc: MSB-first square-and-multiply
        cur = src
        for bit in bin(e)[3:]:
            s.append(("sqrmul", cur, src, "acc") if bit == "1" else ("sqr", cur, "acc"))
            cur = "acc"

    def exp_by_x(src, dst):  # x is negative
        pow_(src, BLS_X)
        s.append(("conj", "acc", dst))

    s += [("load", "r"), ("conj", "r", "f1"), ("inv", "r", "f2"),
          ("mul", "f1", "f2", "rr"), ("frob", "rr", 2, "t"), ("mul", "t", "rr", "rr"),
          ("sqr", "rr", "y0")]
    exp_by_x("y0", "y1")
    pow_("y1", BLS_X >> 1)
    s += [("conj", "acc", "y2"), ("conj", "rr", "y3"), ("mul", "y1", "y3", "y1"),
          ("conj", "y1", "y1"), ("mul", "y1", "y2", "y1")]
    exp_by_x("y1", "y2")
    exp_by_x("y2", "y3")
    s += [("conj", "y1", "y1"), ("mul", "y3", "y1", "y3"), ("conj", "y1", "y1"),
          ("frob", "y1", 3, "y1"), ("frob", "y2", 2, "y2"), ("mul", "y1", "y2", "y1")]
    exp_by_x("y3", "y2")
    s += [("mul", "y2", "y0", "y2"), ("mul", "y2", "rr", "y2"), ("mul", "y1", "y2", "y1"),
          ("frob", "y3", 1, "y2"), ("mul", "y1", "y2", "y1"), ("store", "y1")]
    return s


@functools.lru_cache(maxsize=None)
def final_exp_set() -> ProgramSet:
    """Input and output: one Fq12 a pairing, rows as fq12_row."""
    progs, index, seq = [], {}, []
    for key in final_exp_script():
        if key not in index:
            index[key] = len(progs)
            progs.append(_fe_program(key))
        seq.append((index[key], 0))
    return build_set("final_exp", progs, seq, 12 * len(_REGS), 12, 12)


# ---------------------------------------------------------------------
# running a set: the plain version and the kernel
# ---------------------------------------------------------------------
def _check_rows(pset: ProgramSet, ins):
    if ins.dtype != torch.int32 or ins.dim() != 3 or tuple(ins.shape[:2]) != (FQ.n, pset.n_in):
        raise ValueError(f"{pset.kind}: inputs must be (12, {pset.n_in}, B) int32, "
                         f"got {tuple(ins.shape)} {ins.dtype}")
    if ins.shape[2] < 1 or not ins.is_contiguous():
        raise ValueError(f"{pset.kind}: inputs must be contiguous with B >= 1")
    if ins.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ins.device}")


_PLAIN: dict = {}


def _plain_stages(pset: ProgramSet, device):
    """Per stage: [(op, d, a, b) index tensors], one group an op code."""
    key = (id(pset), str(device))
    got = _PLAIN.get(key)
    if got is None or got[0] is not pset:
        stages, beg = [], 0
        for end in pset.stage_end.tolist():
            rows = pset.ops[beg:end]
            beg = end
            groups = []
            for op in np.unique(rows[:, 0]).tolist():
                sel = rows[rows[:, 0] == op]
                groups.append((op, *(torch.from_numpy(sel[:, k].astype(np.int64)).to(device)
                                     for k in (1, 2, 3))))
            stages.append(groups)
        got = _PLAIN[key] = (pset, stages)
    return got[1]


def execute_plain(pset: ProgramSet, ins):
    """The set's sequence on the plain field ops: each stage's operations of
    one kind as one tensor op over (12, k, B).  -> (12, n_out, B)."""
    _check_rows(pset, ins)
    B = ins.shape[2]
    slots = torch.zeros((FQ.n, pset.n_slots, B), dtype=torch.int32, device=ins.device)
    out = torch.zeros((FQ.n, pset.n_out, B), dtype=torch.int32, device=ins.device)
    consts = _consts(ins.device).unsqueeze(2)
    stages = _plain_stages(pset, ins.device)
    for prog, base in pset.seq.tolist():
        for st in range(pset.prog_stage[prog], pset.prog_stage[prog + 1]):
            for op, d, a, b in stages[st]:
                if op == OP_STORE:
                    out[:, d + base] = slots[:, a]
                    continue
                if op == OP_LOAD:
                    r = ins[:, a + base]
                elif op == OP_CONST:
                    r = consts[:, a].expand(-1, -1, B)
                elif op == OP_MOV:
                    r = slots[:, a]
                elif op == OP_INV:
                    r = cuda_ff.inv_plain(FQ, slots[:, a])
                elif op == OP_MUL:
                    r = cuda_ff.mont_mul_plain(FQ, slots[:, a], slots[:, b])
                elif op == OP_ADD:
                    r = cuda_ff.add_plain(FQ, slots[:, a], slots[:, b])
                else:
                    r = cuda_ff.sub_plain(FQ, slots[:, a], slots[:, b])
                slots[:, d] = r
    return out


_DEVICE: dict = {}


def _on_device(pset: ProgramSet, device):
    key = (id(pset), str(device))
    got = _DEVICE.get(key)
    if got is None or got[0] is not pset:
        got = _DEVICE[key] = (pset, *(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                                      for x in (pset.ops, pset.stage_end, pset.prog_stage,
                                                pset.seq)), _consts(device).contiguous())
    return got[1:]


def _fn():
    fn = _build.lib("pairing_kernel").zc_pairing_run
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                                ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p, ctypes.c_longlong,
                                                ctypes.c_void_p, ctypes.c_longlong,
                                                ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def execute(pset: ProgramSet, ins):
    """``execute_plain`` in one launch for CUDA inputs, a warp a pairing;
    counted in ``launches[pset.kind]``."""
    _check_rows(pset, ins)
    if ins.device.type == "cpu":
        return execute_plain(pset, ins)
    ops, ends, pstage, seq, consts = _on_device(pset, ins.device)
    B = ins.shape[2]
    out = torch.empty((FQ.n, pset.n_out, B), dtype=torch.int32, device=ins.device)
    with torch.cuda.device(ins.device):
        rc = _fn()(ops.data_ptr(), ends.data_ptr(), pstage.data_ptr(), seq.data_ptr(),
                   len(pset.seq), consts.data_ptr(), consts.shape[1], pset.n_slots,
                   ins.data_ptr(), pset.n_in, out.data_ptr(), pset.n_out, B,
                   torch.cuda.current_stream().cuda_stream)
    launches[pset.kind] += 1
    if rc != 0:
        raise RuntimeError(f"pairing kernel ({pset.kind}): CUDA error {rc}")
    return out
