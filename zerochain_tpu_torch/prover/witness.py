"""Batched witness synthesis for the ConfidentialTransfer circuit.

The reference re-interprets the circuit per proof (bellman ConstraintSystem
trait calls); here the circuit is fixed, so witness generation is straight
tensor code, batched over a trailing proof axis B, into one preallocated
``(8, n_aux, B)`` aux tensor:

- a :class:`Plan`, built once per circuit, gives every aux block its first
  row in EXACTLY the allocation order of models/confidential.py, and says
  who writes it: the host (bit decompositions, range checks, the witnessed
  points' coordinates), the step kernel (the chains' per-step aux) or the
  gadget program (the per-proof gadgets);
- the scalar-mul chains run inversion-free in extended Edwards coordinates,
  each group of them in one chain-kernel launch (ec/cuda_jubjub.py), and
  are normalised with one ``ff.inv`` launch each;
- the chains' per-step gadget aux is one ``cuda_witness.steps`` launch, the
  per-proof gadgets (witnessed points, standalone adds, not-small-order
  checks, with their inversions batched a depth at a time) one
  ``cuda_witness.gadgets`` launch of the plan's program.
"""

from __future__ import annotations

import functools
from functools import partial

import numpy as np
import torch

from .. import _device
from ..ec import cuda_jubjub
from ..ff import limbs as L
from ..mirror import jubjub as mjj
from ..native.codec import scalars_to_bits_np
from . import cuda_witness as cw

FR = L.FR

mul = partial(L.mont_mul, FR)

ONE_MONT = FR.r_mod_p

_TABLES: dict = {}


def _table_mont(device):
    """Fixed-base window tables (gen NoteCommitmentRandomness): x/y tensors
    (8, 84 * 8) in Montgomery form, window-major."""
    key = str(device)
    if key not in _TABLES:
        windows = mjj.fixed_base_circuit_generators(
            mjj.NOTE_COMMITMENT_RANDOMNESS)
        xs = [x for coords in windows for (x, _) in coords]
        ys = [y for coords in windows for (_, y) in coords]
        assert len(xs) == 84 * 8
        _TABLES[key] = (FR.array(xs, device, mont=True),
                        FR.array(ys, device, mont=True))
    return _TABLES[key]


def bit_mont(bits):
    """(k, B) 0/1 integers -> (8, k, B) Montgomery word tensor."""
    return FR.const(ONE_MONT, bits[None]) * bits[None].to(torch.int32)


def u32_to_mont(v):
    """(B,) int64 values < 2^32 -> (8, B) Montgomery."""
    words = torch.zeros((FR.n, *v.shape), dtype=torch.int32, device=v.device)
    words[0] = ((v << 32) >> 32).to(torch.int32)
    return L.to_mont(FR, words)


def _bits_le(value, n):
    """(B,) int64 -> (n, B) int64 LE bits."""
    shifts = torch.arange(n, device=value.device).reshape(n, 1)
    return (value[None] >> shifts) & 1


class Emitter:
    """Writes aux blocks (8, k, B) into a preallocated aux tensor
    (8, n_aux, B), one after the other from row ``off``; ``written`` (a
    per-row count, optional) records the rows."""

    def __init__(self, aux, off=0, written=None):
        self.aux = aux
        self.off = off
        self.written = written

    def emit(self, arr):
        if arr.dim() == 2:
            arr = arr[:, None, :]
        k = arr.shape[1]
        self.aux[:, self.off: self.off + k] = arr
        if self.written is not None:
            self.written[self.off: self.off + k] += 1
        self.off += k


U32_ROWS = 63  # emit_u32_range: num, 31 run bits, 30 ANDs, bit 31


def emit_u32_range(em: Emitter, value):
    """range_check.rs layout: num, 31 BE run bits, 30 ANDs, bit 31.

    Returns LE bits (32, B)."""
    bits_le = _bits_le(value, 32)
    em.emit(u32_to_mont(value))
    bits_be = bits_le.flip(0)
    em.emit(bit_mont(bits_be[:31]))
    ands = torch.cumprod(bits_be[:31], dim=0)[1:]  # and-chain of the ones run
    em.emit(bit_mont(ands))
    em.emit(bit_mont(bits_be[31:32]))
    return bits_le


def emit_field_bits(em: Emitter, bits):
    em.emit(bit_mont(bits))


# ---------------------------------------------------------------- chains
def fixed_base_digits(bits, n_windows=84):
    """(n, B) bits -> (n_windows, B) 3-bit digits (zero-padded)."""
    n, B = bits.shape
    pad = n_windows * 3 - n
    b = torch.cat([bits, torch.zeros((pad, B), dtype=bits.dtype,
                                     device=bits.device)], dim=0)
    b = b.reshape(n_windows, 3, B)
    return b[:, 0] + 2 * b[:, 1] + 4 * b[:, 2]


def compute_fixed_base_chains(bits_list):
    """Run all fixed-base chains together.

    bits_list: list of (n_i, B) bit tensors (same generator).  Returns per
    chain: dict with lookup affines, precomp bits, chain result affines.
    """
    dev = bits_list[0].device
    digits = torch.stack(
        [fixed_base_digits(b) for b in bits_list], dim=1
    ).to(torch.int64)  # (84, n_chains, B)
    tx, ty = _table_mont(dev)  # (8, 84 * 8)
    flat = (digits + 8 * torch.arange(84, device=dev).reshape(84, 1, 1))

    def gather(tab):  # -> (8, 84, n_chains, B)
        return tab.index_select(1, flat.reshape(-1)).reshape(
            FR.n, *digits.shape)

    lx = gather(tx)
    ly = gather(ty)

    # chain of additions over windows (extended coords), one launch
    rx_all, ry_all = _normalize_stack(
        cuda_jubjub.fixed_chain(lx, ly))  # (8, 83, n_chains, B)
    return {
        "digits": digits,
        "lookup_x": lx,
        "lookup_y": ly,
        "res_x": rx_all,
        "res_y": ry_all,
    }


def _normalize_stack(xyz):
    """X, Y, Z of k extended points, (3, 8, k, ...) -> affine (8, k, ...),
    with one batched inversion for all of them."""
    X, Y, Z = xyz
    zinv = L.batch_inv_mont(FR, Z.reshape(FR.n, -1), axis=1).reshape(Z.shape)
    return mul(X, zinv), mul(Y, zinv)


def compute_var_mul_chains(bases, bits):
    """bases: affine (x, y) each (8, n_chains, B); bits (252, n_chains, B).

    Returns dict of affine tensors for curbase doublings, selections, and
    addition results."""
    curs, results = cuda_jubjub.var_chain(bases, bits)  # one launch
    cur_x, cur_y = _normalize_stack(curs)
    res_x, res_y = _normalize_stack(results)
    return {
        "cur_x": cur_x,  # (8, 252, C, B)
        "cur_y": cur_y,
        "res_x": res_x,
        "res_y": res_y,
    }


def fixed_sources(fb):
    """The step jobs' tensors of compute_fixed_base_chains' result."""
    return ((fb["lookup_x"], fb["lookup_y"], fb["res_x"], fb["res_y"]),
            fb["digits"].to(torch.uint8))


def var_sources(vm, bits):
    """The step jobs' tensors of compute_var_mul_chains' result and its
    bits (252, C, B)."""
    return ((vm["cur_x"], vm["cur_y"], vm["res_x"], vm["res_y"]),
            (bits != 0).to(torch.uint8).contiguous())


# ---------------------------------------------------------------- gadgets
# Each gadget is a few operations of a cuda_witness.Program on a proof's
# values (program value ids); a point is a pair (x, y).

def witness_point_aux(prog, x, y):
    """EdwardsPoint::witness aux after x, y: x^2, y^2, x^2 y^2."""
    x2 = prog.mul(x, x)
    y2 = prog.mul(y, y)
    return [x2, y2, prog.mul(x2, y2)]


def add_aux(prog, x1, y1, x2, y2):
    """U, A, B, C of an addition gadget from the two affine inputs."""
    a = prog.mul(y2, x1)
    b = prog.mul(x2, y1)
    return [prog.mul(prog.add(x1, y1), prog.add(x2, y2)), a, b,
            prog.mul(prog.mul(prog.const(cw.D), a), b)]


def dbl_aux(prog, x, y):
    """T, A, C of a doubling gadget from the INPUT affine point."""
    s = prog.add(x, y)
    a = prog.mul(x, y)
    return [prog.mul(s, s), a, prog.mul(prog.mul(prog.const(cw.D), a), a)]


def _ext(prog, x, y):
    """(x : y : 1 : xy)"""
    return (x, y, prog.const(cw.ONE), prog.mul(x, y))


def ext_add(prog, p, q):
    """ec/jubjub.py's unified add (9M) -> X, Y, Z."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a = prog.mul(prog.sub(Y1, X1), prog.sub(Y2, X2))
    b = prog.mul(prog.add(Y1, X1), prog.add(Y2, X2))
    c = prog.mul(prog.mul(T1, prog.const(cw.D2)), T2)
    zz = prog.mul(Z1, Z2)
    d = prog.add(zz, zz)
    e, f = prog.sub(b, a), prog.sub(d, c)
    g, h = prog.add(d, c), prog.add(b, a)
    return prog.mul(e, f), prog.mul(g, h), prog.mul(f, g), prog.mul(e, h)


def ext_double(prog, p):
    """ec/jubjub.py's unified double (4M + 4S) -> X, Y, Z, T."""
    X1, Y1, Z1, _ = p
    a = prog.mul(X1, X1)
    b = prog.mul(Y1, Y1)
    zz = prog.mul(Z1, Z1)
    c = prog.add(zz, zz)
    xy = prog.add(X1, Y1)
    e = prog.sub(prog.sub(prog.mul(xy, xy), a), b)
    g = prog.sub(b, a)
    f = prog.sub(g, c)
    h = prog.sub(prog.const(cw.ZERO), prog.add(a, b))
    return prog.mul(e, f), prog.mul(g, h), prog.mul(f, g), prog.mul(e, h)


def add_gadget(prog, x1, y1, x2, y2):
    """Standalone EdwardsPoint::add aux: U, A, B, C, x3, y3 (x3, y3 by the
    extended add and a normalisation)."""
    X, Y, Z, _ = ext_add(prog, _ext(prog, x1, y1), _ext(prog, x2, y2))
    zinv = prog.inv(Z)
    return add_aux(prog, x1, y1, x2, y2) + [prog.mul(X, zinv), prog.mul(Y, zinv)]


def not_small_order_gadget(prog, x, y):
    """3 doublings (T, A, C, x3, y3 each) + the ephemeral inverse of the
    final x: 16 values."""
    cur, outs = _ext(prog, x, y), []
    for _ in range(3):
        cur = ext_double(prog, cur)
        zinv = prog.inv(cur[2])
        outs.append((prog.mul(cur[0], zinv), prog.mul(cur[1], zinv)))
    vals = []
    for (ix, iy), (ox, oy) in zip([(x, y)] + outs[:2], outs):
        vals += dbl_aux(prog, ix, iy) + [ox, oy]
    return vals + [prog.inv(outs[2][0])]


# ---------------------------------------------------------------- the plan
def var_rows(n_bits=252):
    return 2 + 13 * (n_bits - 1)


def fixed_rows(n_bits):
    nw = -(-n_bits // 3)
    return 3 + 9 * (nw - 1) - (n_bits % 3 != 0)


class Ins(int):
    """Point k of a program's input rows (8, n_ins, B): rows 2k and 2k + 1."""


class Plan:
    """The aux layout of one circuit: each block's first row (``at``) in
    allocation order, and who fills each row: the host (``host_rows``,
    written by the witness function through :meth:`rows`), a step job
    (``jobs``: kind, first row, rows, source group, chain, bits;
    ``cuda_witness.steps``) or a gadget program (``programs``: name ->
    compiled ``cuda_witness.Program``; a program loads its inputs from rows
    that are written before it runs, or from its input rows).  A point is
    the pair of rows that hold its x and y, or an :class:`Ins`."""

    def __init__(self):
        self.n_aux = 0
        self.at = {}
        self.jobs = []
        self._host = []      # (first row, rows, stride)
        self._progs = {}     # name -> (Program, {row: value it stores})
        self.programs = {}

    def take(self, name, k, host=True):
        if name in self.at:
            raise ValueError(f"aux block {name!r} taken twice")
        off = self.at[name] = self.n_aux
        self.n_aux += k
        if host:
            self._host.append((off, k, 1))
        return off

    # ---- step jobs
    def _step(self, kind, name, rows, group, index, n_bits=0):
        off = self.take(name, rows, host=False)
        self.jobs.append((kind, off, rows, group, index, n_bits))
        return off + rows - 2, off + rows - 1  # the chain's last point

    def fixed(self, name, index, n_bits, group="fb"):
        return self._step(cw.FIXED, name, fixed_rows(n_bits), group, index, n_bits)

    def var(self, name, index, n_bits=252, group="vm"):
        return self._step(cw.VAR, name, var_rows(n_bits), group, index)

    def fold(self, name, group, index, k):
        return self._step(cw.FOLD, name, 8 * k, group, index)

    # ---- gadgets
    def _prog(self, name):
        return self._progs.setdefault(name, (cw.Program(), {}))

    def point(self, pt, prog="main"):
        """A point's values in program prog: the values it stored at the
        rows, else loads."""
        p, stored = self._prog(prog)
        if isinstance(pt, Ins):
            return p.load(2 * pt, cw.INS), p.load(2 * pt + 1, cw.INS)
        return tuple(stored[r] if r in stored else p.load(r) for r in pt)

    def _store(self, prog, row, v):
        p, stored = self._prog(prog)
        p.store(v, row)
        stored[row] = v

    def _gadget(self, name, vals, prog):
        off = self.take(name, len(vals), host=False)
        for k, v in enumerate(vals):
            self._store(prog, off + k, v)
        return off

    def witness_points(self, name, k, prog="main"):
        """k EdwardsPoint::witness gadgets in one block of 5k rows: per point
        x, y (host rows) and x^2, y^2, x^2 y^2; -> the points' rows."""
        off = self.take(name, 5 * k, host=False)
        self._host.append((off, 2 * k, 5))
        p = self._prog(prog)[0]
        pts = [(off + 5 * i, off + 5 * i + 1) for i in range(k)]
        for i, pt in enumerate(pts):
            for j, v in enumerate(witness_point_aux(p, *self.point(pt, prog))):
                self._store(prog, off + 5 * i + 2 + j, v)
        return pts

    def witness_point(self, name, prog="main"):
        return self.witness_points(name, 1, prog)[0]

    def add(self, name, pt, qt, prog="main"):
        off = self._gadget(name, add_gadget(self._prog(prog)[0], *self.point(pt, prog),
                                            *self.point(qt, prog)), prog)
        return off + 4, off + 5

    def not_small_order(self, name, pt, prog="main"):
        self._gadget(name, not_small_order_gadget(self._prog(prog)[0],
                                                  *self.point(pt, prog)), prog)

    # ---- done
    def finish(self, public=()):
        """Compile the programs and check that every row has one writer;
        ``public``: the points of the public inputs after ONE."""
        owner = np.zeros(self.n_aux, np.int32)
        host = np.zeros(self.n_aux, np.int32)
        for off, k, stride in self._host:
            rows = (off + np.arange(k) // 2 * stride + np.arange(k) % 2
                    if stride > 1 else np.arange(off, off + k))
            host[rows] += 1
        owner += host
        for _, off, rows, *_ in self.jobs:
            owner[off: off + rows] += 1
        for name, (p, stored) in self._progs.items():
            owner[list(stored)] += 1
            self.programs[name] = p.compile()
        if not (owner == 1).all():
            raise ValueError(f"aux rows with {sorted(set(owner.tolist()))} writers")
        self.host_rows = host
        self.public = [r for pt in public for r in pt]
        self._public_dev = {}
        del self._progs
        return self

    def step_jobs(self, groups):
        """The StepJobs, with groups: source group -> (points, data)."""
        jobs = []
        for kind, off, rows, g, index, n_bits in self.jobs:
            points, data = groups[g]
            jobs.append(cw.StepJob(kind, off, points, index,
                                   None if kind == cw.FOLD else data, n_bits))
            if jobs[-1].n_rows != rows:
                raise ValueError(f"step job {g}[{index}]: {jobs[-1].n_rows} rows, "
                                 f"the plan has {rows}")
        return jobs

    def rows(self, aux):
        """The host rows' writer: rows(name) is an Emitter at the block's
        first row, rows.points(name, x, y) writes a witness_points block's
        x and y; rows.check() after the last write."""
        return _HostRows(self, aux)

    def public_rows(self, device):
        key = str(device)
        if key not in self._public_dev:
            self._public_dev[key] = torch.tensor(self.public, device=device)
        return self._public_dev[key]


class _HostRows:
    def __init__(self, plan, aux):
        self.plan, self.aux = plan, aux
        self.written = np.zeros(plan.n_aux, np.int32)

    def __call__(self, name):
        return Emitter(self.aux, self.plan.at[name], self.written)

    def points(self, name, x, y):
        """x, y: (8, k, B) or (8, B) for one point."""
        off = self.plan.at[name]
        if x.dim() == 2:
            x, y = x[:, None], y[:, None]
        k = x.shape[1]
        self.aux[:, off: off + 5 * k: 5] = x
        self.aux[:, off + 1: off + 5 * k: 5] = y
        self.written[off: off + 5 * k: 5] += 1
        self.written[off + 1: off + 5 * k: 5] += 1

    def check(self):
        if not np.array_equal(self.written, self.plan.host_rows):
            bad = np.flatnonzero(self.written != self.plan.host_rows)
            raise RuntimeError(f"host rows written wrongly, first at row {bad[0]}")


def new_aux(plan, B, device):
    return torch.empty((FR.n, plan.n_aux, B), dtype=torch.int32, device=device)


def public_of(plan, aux):
    """(8, 1 + len(plan.public), B): ONE, then the public points' rows."""
    B = aux.shape[2]
    return torch.cat([L.ones_mont(FR, (1, B), aux.device),
                      aux.index_select(1, plan.public_rows(aux.device))], dim=1)


# ======================================================================
# full ConfidentialTransfer witness assembly
# ======================================================================

@functools.lru_cache(maxsize=None)
def confidential_plan() -> Plan:
    """models/confidential.py's allocation order."""
    pl = Plan()
    for name in ("amount", "remaining", "fee"):
        pl.take(name, U32_ROWS)
    pl.take("dec_key_bits", 252)
    eks = pl.fixed("enc_key_sender", 0, 252)
    amount_g = pl.fixed("amount_g", 1, 32)
    fee_g = pl.fixed("fee_g", 2, 32)
    pl.take("randomness_bits", 252)

    val_rls = pl.var("val_rls", 0)
    ekr = pl.witness_point("ekr")
    pl.not_small_order("ekr.nso", ekr)
    val_rlr = pl.var("val_rlr", 1)
    c_left_sender = pl.add("c_left_sender", amount_g, val_rls)
    c_left_recipient = pl.add("c_left_recipient", amount_g, val_rlr)
    c_right = pl.fixed("c_right", 3, 252)
    f_left_sender = pl.add("f_left_sender", fee_g, val_rls)

    ebl = pl.witness_point("ebl")
    ebr = pl.witness_point("ebr")
    pl.not_small_order("ebl.nso", ebl)
    pl.not_small_order("ebr.nso", ebr)

    dksr = pl.var("dksr", 2)
    bal_dksr = pl.add("bal_dksr", ebl, dksr)
    pl.add("bi_left", bal_dksr, dksr)

    dksp = pl.var("dksp", 3)
    rem_bal_g = pl.fixed("rem_bal_g", 4, 32)
    val_rem_bal = pl.add("val_rem_bal", c_left_sender, rem_bal_g)
    val_rem_bal_balr = pl.add("val_rem_bal_balr", val_rem_bal, dksp)
    pl.add("bi_right", f_left_sender, val_rem_bal_balr)

    pgk = pl.witness_point("pgk")
    pl.not_small_order("pgk.nso", pgk)
    pl.take("alpha_bits", 252)
    alpha_g = pl.fixed("alpha_g", 5, 252)
    rvk = pl.add("rvk", pgk, alpha_g)
    pl.not_small_order("rvk.nso", rvk)

    gep = pl.witness_point("gep")
    nonce = pl.var("nonce", 4)
    return pl.finish([eks, ekr, c_left_sender, c_left_recipient, c_right,
                      f_left_sender, ebl, ebr, rvk, gep, nonce])


def confidential_witness(
    amount_u32,          # (B,) int64 < 2^32
    remaining_u32,       # (B,)
    fee_u32,             # (B,)
    dec_key_bits,        # (252, B) 0/1
    randomness_bits,     # (252, B)
    alpha_bits,          # (252, B)
    ekr,                 # enc_key_recipient affine mont: (x, y) each (8, B)
    ebl,                 # enc_balance_left
    ebr,                 # enc_balance_right
    pgk,                 # proof generation key
    gep,                 # g_epoch
):
    """-> (aux (8, n_aux, B), public (8, 23, B)), both Montgomery words.

    Aux order matches models/confidential.py allocation order exactly."""
    plan, aux, jobs = confidential_setup(
        amount_u32, remaining_u32, fee_u32, dec_key_bits, randomness_bits,
        alpha_bits, ekr, ebl, ebr, pgk, gep)
    cw.steps(jobs, aux)
    cw.gadgets(plan.programs["main"], aux)
    return aux, public_of(plan, aux)


def confidential_setup(amount_u32, remaining_u32, fee_u32, dec_key_bits,
                       randomness_bits, alpha_bits, ekr, ebl, ebr, pgk, gep):
    """The witness up to its gadget kernels: -> (plan, aux with the host
    rows written, the step jobs over the normalised chains)."""
    plan = confidential_plan()
    B = dec_key_bits.shape[1]
    aux = new_aux(plan, B, dec_key_bits.device)
    rows = plan.rows(aux)

    amount_bits = emit_u32_range(rows("amount"), amount_u32)
    remaining_bits = emit_u32_range(rows("remaining"), remaining_u32)
    fee_bits = emit_u32_range(rows("fee"), fee_u32)
    for name, bits in (("dec_key_bits", dec_key_bits),
                       ("randomness_bits", randomness_bits),
                       ("alpha_bits", alpha_bits)):
        emit_field_bits(rows(name), bits)
    for name, (x, y) in (("ekr", ekr), ("ebl", ebl), ("ebr", ebr), ("pgk", pgk),
                         ("gep", gep)):
        rows.points(name, x, y)
    rows.check()

    # ---- the chains (all on NoteCommitmentRandomness for the fixed base)
    fb = compute_fixed_base_chains(
        [
            dec_key_bits,                         # 0: enc_key_sender
            amount_bits,                          # 1: amount_g
            fee_bits,                             # 2: fee_g
            randomness_bits,                      # 3: c_right
            remaining_bits,                       # 4: rem_bal_g
            alpha_bits,                           # 5: alpha_g
        ]
    )
    # enc_key_sender and c_right are var-mul bases: chain 0's and 3's sums
    last = 84 - 2
    eks = (fb["res_x"][:, last, 0], fb["res_y"][:, last, 0])
    c_right = (fb["res_x"][:, last, 3], fb["res_y"][:, last, 3])
    vm_bases = (
        torch.stack([eks[0], ekr[0], c_right[0], ebr[0], gep[0]], dim=1),
        torch.stack([eks[1], ekr[1], c_right[1], ebr[1], gep[1]], dim=1),
    )
    vm_bits = torch.stack(
        [
            randomness_bits,   # 0: val_rls = eks * randomness
            randomness_bits,   # 1: val_rlr = ekr * randomness
            dec_key_bits,      # 2: dec_key_sender_random = c_right * dk
            dec_key_bits,      # 3: dec_key_sender_pointr = ebr * dk
            dec_key_bits,      # 4: nonce = g_epoch * dk
        ],
        dim=1,
    )  # (252, 5, B)
    vm = compute_var_mul_chains(vm_bases, vm_bits)
    return plan, aux, plan.step_jobs({"fb": fixed_sources(fb),
                                      "vm": var_sources(vm, vm_bits)})


# ---------------------------------------------------------------- host API
def bits_le_host(values, n_bits, device):
    return torch.from_numpy(
        scalars_to_bits_np(list(values), n_bits).astype(np.int64)).to(device)


def affine_mont_host(points, device):
    """[(x, y), ...] host ints -> (x, y) each (8, B) Montgomery."""
    xs = FR.array([p[0] for p in points], device, mont=True)
    ys = FR.array([p[1] for p in points], device, mont=True)
    return xs, ys


def _u32_host(values, device):
    return torch.tensor([int(v) & 0xFFFFFFFF for v in values],
                        dtype=torch.int64, device=device)


def witness_inputs_host(assignments: list[dict], device=None):
    """Build device inputs from a list of per-proof witness dicts with keys:
    amount, remaining_balance, fee (ints); dec_key, randomness, alpha (Fs
    ints); enc_key_recipient, encrypted_balance (left/right), pgk, g_epoch
    (affine int points)."""
    dev = _device.resolve(device)
    get = lambda k: [a[k] for a in assignments]  # noqa: E731
    return dict(
        amount_u32=_u32_host(get("amount"), dev),
        remaining_u32=_u32_host(get("remaining_balance"), dev),
        fee_u32=_u32_host(get("fee"), dev),
        dec_key_bits=bits_le_host(get("dec_key"), 252, dev),
        randomness_bits=bits_le_host(get("randomness"), 252, dev),
        alpha_bits=bits_le_host(get("alpha"), 252, dev),
        ekr=affine_mont_host(get("enc_key_recipient"), dev),
        ebl=affine_mont_host(get("enc_balance_left"), dev),
        ebr=affine_mont_host(get("enc_balance_right"), dev),
        pgk=affine_mont_host(get("pgk"), dev),
        gep=affine_mont_host(get("g_epoch"), dev),
    )
