"""The witness stage's gadget arithmetic in two kernels, written straight
into the aux rows.

``steps`` and ``gadgets`` wrap the two kernels of ``csrc/witness_kernel.cu``:

- ``steps`` (W1, ``zc_wit_steps``): the per-step aux of the scalar-
  multiplication chains, one launch for a list of :class:`StepJob` (one
  emission block each: a variable-base chain, a fixed-base window chain or
  a one-hot fold), one thread a (step, chain, proof);
- ``gadgets`` (W2, ``zc_wit_gadgets``): the per-proof gadgets as a
  straight-line Fr program (:class:`Program`, compiled once per circuit),
  one warp a proof.  The inversions of one depth of the program are one
  Montgomery trick inside it: one Fermat power a depth and proof.

The JAX package routes each of these field operations to its Pallas field
kernels (``zerochain_tpu/ff/pallas_ff.py``) under one ``jax.jit``; the port
ran one K1 launch a field operation.  ``steps_plain`` and ``gadgets_plain``
are the same functions over the plain field ops of ``ff/cuda_ff.py``
(``gadgets_plain`` interprets the program stage by stage, a stage's
operations of one kind as one tensor op), and the kernels return their
words exactly.  A wrapper takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.

Aux is ``(8, n_aux, B)`` int32 words, Montgomery form, written in place.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..ff import cuda_ff
from ..ff import limbs as L
from ..mirror import jubjub as mjj
from ..mirror.field import R

FR = L.FR

launches = {"steps": 0, "gadgets": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# the program's constants, as witness_kernel.cu's ZC_WIT_CONSTS
ZERO, ONE, D, D2 = range(4)
CONST_VALUES = (0, FR.r_mod_p, mjj.EDWARDS_D * FR.r_mod_p % R,
                2 * mjj.EDWARDS_D * FR.r_mod_p % R)

# W1 job kinds and W2 operation codes, as in witness_kernel.cu
VAR, FIXED, FOLD = 0, 1, 2
(OP_MUL, OP_ADD, OP_SUB, OP_NZ1, OP_ZSEL, OP_LOAD, OP_STORE, OP_CONST,
 OP_INV) = range(9)
_INVREQ = -1  # an inversion before the Montgomery tricks are built
AUX, INS = 0, 1  # the rows a load reads


def _mul(a, b):
    return cuda_ff.mont_mul_plain(FR, *torch.broadcast_tensors(a, b))


def _add(a, b):
    return cuda_ff.add_plain(FR, a, b)


def _sub(a, b):
    return cuda_ff.sub_plain(FR, a, b)


def _const(k, like):
    return FR.const(CONST_VALUES[k], like).expand(like.shape)


# ---------------------------------------------------------------------
# W1: the chains' per-step aux
# ---------------------------------------------------------------------
@dataclass(frozen=True)
class StepJob:
    """One emission block of ``steps``.

    ``points``: four (8, n, chains, B) tensors (any stride between words,
    dense below), the x and y of two point arrays (VAR: cur and res of the
    252 steps; FIXED: the n_win lookups and the n_win - 1 window sums; FOLD:
    the K selections and running sums); ``index``: the chain; ``data``:
    (n, chains, B) uint8 (VAR: bits, FIXED: 3-bit digits), None for FOLD;
    ``n_bits``: FIXED's scalar bits.
    Rows from ``aux_off``: VAR 2 + 13 (n - 1); FIXED 3 + 9 (nw - 1), one
    fewer where the last window has fewer than 3 bits; FOLD 8 K."""

    kind: int
    aux_off: int
    points: tuple
    index: int
    data: torch.Tensor | None = None
    n_bits: int = 0

    @property
    def n_steps(self) -> int:
        if self.kind == FIXED:
            return -(-self.n_bits // 3)
        return self.points[0].shape[1]

    @property
    def n_rows(self) -> int:
        n = self.n_steps
        if self.kind == VAR:
            return 2 + 13 * (n - 1)
        if self.kind == FIXED:
            return 3 + 9 * (n - 1) - (self.n_bits % 3 != 0)
        return 8 * n


def dbl_aux_plain(x, y):
    """T, A, C of a doubling gadget of (x, y): (x + y)^2, x y, d A A."""
    s = _add(x, y)
    a = _mul(x, y)
    return _mul(s, s), a, _mul(_mul(_const(D, a), a), a)


def add_aux_plain(x1, y1, x2, y2):
    """U, A, B, C of an addition gadget: (x1 + y1)(x2 + y2), y2 x1, x2 y1,
    d A B."""
    a = _mul(y2, x1)
    b = _mul(x2, y1)
    return (_mul(_add(x1, y1), _add(x2, y2)), a, b,
            _mul(_mul(_const(D, a), a), b))


def select_point(bits, x, y):
    """bits (n, B) 0/1 ? (x, y) : the identity (0, 1), each (8, n, B)."""
    on = bits[None].to(torch.bool)
    return (torch.where(on, x, torch.zeros_like(x)),
            torch.where(on, y, _const(ONE, y)))


def _step_block(job):
    """The job's rows as (8, n_rows, B)."""
    px, py, qx, qy = (t[:, :, job.index] for t in job.points)
    head = px[:, :0]  # FOLD: no head
    if job.kind == VAR:
        sx, sy = select_point(job.data[:, job.index], px, py)
        head = torch.stack([sx[:, 0], sy[:, 0]], dim=1)
        t, a, c = dbl_aux_plain(px[:, :-1], py[:, :-1])
        u, aa, bb, cc = add_aux_plain(qx[:, :-1], qy[:, :-1], sx[:, 1:], sy[:, 1:])
        parts = [t, a, c, px[:, 1:], py[:, 1:], sx[:, 1:], sy[:, 1:],
                 u, aa, bb, cc, qx[:, 1:], qy[:, 1:]]
    elif job.kind == FIXED:
        nw = job.n_steps
        d = job.data[:nw, job.index].to(torch.int64)
        pc = _const(ONE, px[:, :nw]) * (((d >> 1) & (d >> 2) & 1)[None]).to(torch.int32)
        head = torch.stack([px[:, 0], py[:, 0], pc[:, 0]], dim=1)
        prevx = torch.cat([px[:, :1], qx[:, :nw - 2]], dim=1)
        prevy = torch.cat([py[:, :1], qy[:, :nw - 2]], dim=1)
        u, a, b, c = add_aux_plain(prevx, prevy, px[:, 1:nw], py[:, 1:nw])
        parts = [px[:, 1:nw], py[:, 1:nw], pc[:, 1:nw], u, a, b, c,
                 qx[:, :nw - 1], qy[:, :nw - 1]]
    else:
        prevx = torch.cat([torch.zeros_like(qx[:, :1]), qx[:, :-1]], dim=1)
        prevy = torch.cat([_const(ONE, qy[:, :1]), qy[:, :-1]], dim=1)
        u, a, b, c = add_aux_plain(prevx, prevy, px, py)
        parts = [px, py, u, a, b, c, qx, qy]
    block = torch.stack(parts, dim=2)  # (8, steps, parts, B)
    B = block.shape[-1]
    body = block.reshape(FR.n, -1, B)
    if job.kind == FIXED and job.n_bits % 3:  # the last window has no bit
        body = body[:, torch.arange(body.shape[1], device=body.device)
                    != 9 * (job.n_steps - 2) + 2]
    return torch.cat([head, body], dim=1)


def steps_plain(jobs, aux) -> None:
    """Write every job's rows into aux (8, n_aux, B) with the plain ops."""
    for job in jobs:
        aux[:, job.aux_off: job.aux_off + job.n_rows] = _step_block(job)


class _Job(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32), ("aux_off", ctypes.c_int32),
                ("n_steps", ctypes.c_int32), ("n_bits", ctypes.c_int32),
                ("step_stride", ctypes.c_int64), ("p", ctypes.c_void_p * 5),
                ("wstride", ctypes.c_int64 * 4)]


MAX_JOBS = 40  # WIT_MAX_JOBS


def _check_aux(aux):
    if aux.dtype != torch.int32 or aux.dim() != 3 or aux.shape[0] != FR.n:
        raise ValueError(f"aux must be (8, n_aux, B) int32, got "
                         f"{tuple(aux.shape)} {aux.dtype}")
    if not aux.is_contiguous():
        raise ValueError("aux must be contiguous")
    if aux.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {aux.device}")


def _job_record(job, aux):
    B = aux.shape[2]
    rec = _Job(kind=job.kind, aux_off=job.aux_off, n_steps=job.n_steps,
               n_bits=job.n_bits)
    chains = job.points[0].shape[2]
    rec.step_stride = chains * B
    ts = list(job.points) + ([job.data] if job.data is not None else [])
    for i, t in enumerate(ts):
        # any word stride; entries, chains and proofs dense
        if (t.device != aux.device or t.shape[-2:] != (chains, B)
                or t.stride()[-3:] != (chains * B, B, 1)
                or t.dtype != (torch.uint8 if i == 4 else torch.int32)):
            raise ValueError(f"step job tensor {i}: {tuple(t.shape)} "
                             f"{t.stride()} {t.dtype} on {t.device}")
        rec.p[i] = t.data_ptr() + t.element_size() * job.index * B
        if i < 4:
            rec.wstride[i] = t.stride(0)
    if job.aux_off + job.n_rows > aux.shape[1]:
        raise ValueError("step job rows past the end of aux")
    return rec


def _fn(name, argtypes):
    fn = getattr(_build.lib("witness_kernel"), name)
    if not getattr(fn, "_typed", False):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def steps(jobs, aux) -> None:
    """``steps_plain`` for all jobs in one launch (aux on the card)."""
    _check_aux(aux)
    if aux.device.type == "cpu":
        return steps_plain(jobs, aux)
    if not 1 <= len(jobs) <= MAX_JOBS:
        raise ValueError(f"steps takes 1-{MAX_JOBS} jobs, got {len(jobs)}")
    recs = (_Job * len(jobs))(*(_job_record(j, aux) for j in jobs))
    fn = _fn("zc_wit_steps", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_longlong, ctypes.c_longlong,
                              ctypes.c_void_p])
    with torch.cuda.device(aux.device):
        rc = fn(ctypes.addressof(recs), len(jobs), aux.data_ptr(), aux.shape[1],
                aux.shape[2], torch.cuda.current_stream().cuda_stream)
    launches["steps"] += 1
    if rc != 0:
        raise RuntimeError(f"witness steps: CUDA error {rc}")


# ---------------------------------------------------------------------
# W2: the per-proof gadgets as a straight-line Fr program
# ---------------------------------------------------------------------
_MUL_CLASS, _LIN_CLASS, _INV_CLASS = 0, 1, 2


def _op_class(op):
    if op == OP_MUL:
        return _MUL_CLASS
    return _INV_CLASS if op == OP_INV else _LIN_CLASS


class Compiled(NamedTuple):
    """A scheduled program: ``ops`` (n_ops, 4) int32 rows (op, d, x, y) as
    witness_kernel.cu reads them, ``stage_end`` (n_stages,), ``n_slots``."""

    ops: np.ndarray
    stage_end: np.ndarray
    n_slots: int
    n_ins: int

    @property
    def counts(self) -> dict:
        ops = self.ops[:, 0]
        return {"stages": len(self.stage_end), "slots": self.n_slots,
                "mul": int((ops == OP_MUL).sum()), "inv": int((ops == OP_INV).sum()),
                "linear": int(((ops == OP_ADD) | (ops == OP_SUB)).sum()),
                "load": int((ops == OP_LOAD).sum()), "store": int((ops == OP_STORE).sum())}


class Program:
    """A straight-line Fr program of one proof over the aux rows (and an
    optional input tensor), in SSA form: each method returns a value id.

    ``inv`` asks for an inverse (zero for zero); :meth:`compile` batches the
    inversions of one depth (the number of inversions a value depends on)
    into one Montgomery trick: zeros replaced by one, a product tree, one
    Fermat power, the tree unwound, zeros selected back.  Then it drops
    what no store needs, packs the operations into stages (all of a stage's
    operands come from earlier stages; a stage holds multiplies, or the
    cheap operations, or Fermat powers) and gives the values slots, a slot
    reused after its last reader's stage."""

    def __init__(self):
        self.nodes = []     # (op, x, y); LOAD (row, src), CONST (k, 0)
        self.stores = []    # (value, row)
        self._memo = {}

    def _node(self, op, x, y=0):
        key = (op, x, y)
        if key in self._memo:  # one load of a row, one node a constant
            return self._memo[key]
        self.nodes.append(key)
        if op in (OP_LOAD, OP_CONST):
            self._memo[key] = len(self.nodes) - 1
        return len(self.nodes) - 1

    def load(self, row, src=AUX):
        return self._node(OP_LOAD, int(row), src)

    def const(self, k):
        return self._node(OP_CONST, k)

    def mul(self, a, b):
        return self._node(OP_MUL, a, b)

    def add(self, a, b):
        return self._node(OP_ADD, a, b)

    def sub(self, a, b):
        return self._node(OP_SUB, a, b)

    def inv(self, a):
        return self._node(_INVREQ, a)

    def store(self, v, row):
        self.stores.append((v, int(row)))

    # ---- compile ------------------------------------------------------
    def _batch_inversions(self, nodes):
        """Rewrite the inversion requests into Montgomery tricks, one a
        depth; -> the node list and each request's replacement."""
        depth = [0] * len(nodes)
        for i, (op, x, y) in enumerate(nodes):
            if op in (OP_LOAD, OP_CONST):
                continue
            depth[i] = depth[x] + 1 if op == _INVREQ else max(depth[x], depth[y])
        nodes = list(nodes)
        alias = {}

        def new(op, x, y=0):
            nodes.append((op, x, y))
            return len(nodes) - 1

        for lvl in sorted({depth[i] for i, n in enumerate(nodes) if n[0] == _INVREQ}):
            reqs = [i for i, n in enumerate(nodes) if n[0] == _INVREQ and depth[i] == lvl]
            vals = [nodes[i][1] for i in reqs]
            if len(vals) == 1:  # the Fermat power maps zero to zero itself
                alias[reqs[0]] = new(OP_INV, vals[0])
                continue
            leaves = [new(OP_NZ1, v) for v in vals]
            levels = [leaves]
            while len(levels[-1]) > 1:
                cur = levels[-1]
                nxt = [new(OP_MUL, cur[k], cur[k + 1]) for k in range(0, len(cur) - 1, 2)]
                if len(cur) % 2:
                    nxt.append(cur[-1])
                levels.append(nxt)
            invs = [new(OP_INV, levels[-1][0])]
            for cur in reversed(levels[:-1]):  # unwind: children of each node
                down = []
                for k in range(0, len(cur) - 1, 2):
                    down += [new(OP_MUL, invs[k // 2], cur[k + 1]),
                             new(OP_MUL, invs[k // 2], cur[k])]
                if len(cur) % 2:
                    down.append(invs[-1])
                invs = down
            for r, v, iv in zip(reqs, vals, invs):
                alias[r] = new(OP_ZSEL, v, iv)
        return nodes, alias

    def compile(self) -> Compiled:
        nodes, alias = self._batch_inversions(self.nodes)

        def res(v):
            while v in alias:
                v = alias[v]
            return v

        deps = []
        for op, x, y in nodes:
            if op in (OP_LOAD, OP_CONST, _INVREQ):
                deps.append(())
            elif op in (OP_NZ1, OP_INV):
                deps.append((res(x),))
            else:
                deps.append((res(x), res(y)))
        stores = [(res(v), row) for v, row in self.stores]
        rows = [row for _, row in stores]
        loaded = {x for op, x, y in nodes if op == OP_LOAD and y == AUX}
        if len(set(rows)) != len(rows) or loaded & set(rows):
            raise ValueError("a program stores a row twice or loads a row it stores")
        live = [False] * len(nodes)
        stack = [v for v, _ in stores]
        while stack:
            v = stack.pop()
            if not live[v]:
                live[v] = True
                stack.extend(deps[v])
        # list scheduling: each stage takes every ready operation of one
        # class, multiplies first, Fermat powers only when nothing else is
        # ready (so a depth's one power runs alone)
        n = len(nodes)
        items = [i for i in range(n) if live[i]] + [n + k for k in range(len(stores))]
        item_deps = {i: deps[i] for i in range(n) if live[i]}
        item_deps.update({n + k: (v,) for k, (v, _) in enumerate(stores)})
        users = {}
        waiting = {}
        for it in items:
            waiting[it] = len(item_deps[it])
            for d in item_deps[it]:
                users.setdefault(d, []).append(it)
        ready = {c: [] for c in (_MUL_CLASS, _LIN_CLASS, _INV_CLASS)}

        def cls(it):
            return _LIN_CLASS if it >= n else _op_class(nodes[it][0])

        for it in items:
            if waiting[it] == 0:
                ready[cls(it)].append(it)
        stages = []
        while any(ready.values()):
            c = next(k for k in (_MUL_CLASS, _LIN_CLASS, _INV_CLASS) if ready[k])
            stage, ready[c] = sorted(ready[c]), []
            stages.append(stage)
            for it in stage:
                for u in users.get(it, ()):
                    waiting[u] -= 1
                    if waiting[u] == 0:
                        ready[cls(u)].append(u)
        if sum(map(len, stages)) != len(items):
            raise ValueError("program has a cycle")
        # slots: a value's slot is freed after its last reader's stage
        last = {}
        for s, stage in enumerate(stages):
            for it in stage:
                for d in item_deps[it]:
                    last[d] = s
        slot, free, n_slots = {}, [], 0
        out = []
        for s, stage in enumerate(stages):
            for it in stage:
                if it >= n:
                    continue
                if free:
                    slot[it] = free.pop()
                else:
                    slot[it], n_slots = n_slots, n_slots + 1
            for it in stage:
                if it >= n:
                    v, row = stores[it - n]
                    out.append((OP_STORE, row, slot[v], 0))
                    continue
                op, x, y = nodes[it]
                if op in (OP_LOAD, OP_CONST):
                    out.append((op, slot[it], x, y))
                elif op in (OP_NZ1, OP_INV):
                    out.append((op, slot[it], slot[deps[it][0]], 0))
                else:
                    out.append((op, slot[it], slot[deps[it][0]], slot[deps[it][1]]))
            free += sorted((slot[v] for v, s_last in last.items() if s_last == s),
                           reverse=True)
        ends = np.cumsum([len(st) for st in stages]).astype(np.int32)
        n_ins = 1 + max((x for op, x, y in nodes if op == OP_LOAD and y == INS),
                        default=-1)
        return Compiled(np.asarray(out, dtype=np.int32).reshape(-1, 4), ends,
                        max(n_slots, 1), n_ins)


_PLAIN_BINARY = {OP_MUL: _mul, OP_ADD: _add, OP_SUB: _sub}


def _is_zero(t):
    return (t == 0).all(dim=0, keepdim=True)


def gadgets_plain(prog: Compiled, aux, ins=None) -> None:
    """Run the program for every proof with the plain field ops: each stage's
    operations of one kind as one tensor op over (8, k, B)."""
    B = aux.shape[2]
    slots = torch.zeros((FR.n, prog.n_slots, B), dtype=torch.int32,
                        device=aux.device)
    consts = torch.cat([_const(k, aux[:, :1, :1]) for k in range(4)], dim=1)
    beg = 0
    for end in prog.stage_end.tolist():
        stage = prog.ops[beg:end]
        beg = end
        for op in np.unique(stage[:, 0]).tolist():
            sel = stage[stage[:, 0] == op]
            d, x, y = (torch.from_numpy(sel[:, k].astype(np.int64)).to(aux.device)
                       for k in (1, 2, 3))
            if op == OP_STORE:
                aux[:, d] = slots[:, x]
                continue
            if op == OP_LOAD:
                for src, t in ((AUX, aux), (INS, ins)):
                    on = y == src
                    if bool(on.any()):
                        slots[:, d[on]] = t[:, x[on]]
                continue
            if op == OP_CONST:
                slots[:, d] = consts[:, x].expand(-1, -1, B)
                continue
            u = slots[:, x]
            if op == OP_INV:
                r = cuda_ff.inv_plain(FR, u)
            elif op == OP_NZ1:
                r = torch.where(_is_zero(u), consts[:, ONE:ONE + 1], u)
            elif op == OP_ZSEL:
                r = torch.where(_is_zero(u), torch.zeros_like(u), slots[:, y])
            else:
                r = _PLAIN_BINARY[op](u, slots[:, y])
            slots[:, d] = r


_DEVICE_PROGS: dict = {}


def _on_device(prog: Compiled, device):
    key = (id(prog), str(device))
    got = _DEVICE_PROGS.get(key)
    if got is None or got[0] is not prog:
        got = (prog, torch.from_numpy(prog.ops).to(device),
               torch.from_numpy(prog.stage_end).to(device))
        _DEVICE_PROGS[key] = got
    return got[1], got[2]


def gadgets(prog: Compiled, aux, ins=None) -> None:
    """``gadgets_plain`` in one launch (aux on the card), a warp a proof;
    ins: (8, prog.n_ins, B) input rows, where the program loads any."""
    _check_aux(aux)
    if prog.n_ins:
        if ins is None or ins.shape != (FR.n, prog.n_ins, aux.shape[2]):
            raise ValueError(f"program needs ins (8, {prog.n_ins}, B)")
        if ins.device != aux.device or ins.dtype != torch.int32:
            raise ValueError("ins must be int32 on aux's device")
        ins = ins.contiguous()
    if aux.device.type == "cpu":
        return gadgets_plain(prog, aux, ins)
    ops, ends = _on_device(prog, aux.device)
    fn = _fn("zc_wit_gadgets", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(aux.device):
        rc = fn(ops.data_ptr(), ends.data_ptr(), len(prog.stage_end), prog.n_slots,
                aux.data_ptr(), aux.shape[1],
                ins.data_ptr() if prog.n_ins else None, prog.n_ins, aux.shape[2],
                torch.cuda.current_stream().cuda_stream)
    launches["gadgets"] += 1
    if rc != 0:
        raise RuntimeError(f"witness gadgets: CUDA error {rc}")
