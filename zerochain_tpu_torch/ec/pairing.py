"""BLS12-381 optimal-ate pairing on batched tower tensors.

The JAX package (``zerochain_tpu/ec/pairing.py``) runs the Miller loop and
the final exponentiation as ``lax.scan``s over the 64-bit BLS_X schedule and
computes both sides of every scheduled branch, selecting one.  Here the
schedule is a host constant: an addition step or line runs only where the
bit is set (5 of the 62 steps), and a power by x squares 63 times and
multiplies 5 times.  The values are the same; the step formulas are the
reference's (core/pairing/src/bls12_381/mod.rs:40-359, eprint 2010/354
algorithms 26/27), as in the host mirror (mirror/pairing.py), which the
tests pin to RELIC's golden vector.

Points: G1 coordinates are Fq tensors (12, *batch), G2 coordinates Fq2
tensors (12, 2, *batch), affine, not at infinity; trailing batch axes ride
through.  ``g2_prepare``, ``miller_loop``, ``final_exponentiation`` and
``pairing`` run on the two program sets of ``ec/cuda_pairing.py``: on CUDA
tensors one kernel launch each (``pairing``: two), a warp a pairing, on CPU
tensors their plain versions; around them only the stacking of the inputs
into rows and the views of the outputs.  ``pairing_host`` resolves
``device=None`` to the card and raises without one.

The ``*_tower`` functions are the same maps as a chain of tower operations
(ec/tower.py), each field operation a K1 kernel launch on CUDA tensors (its
plain version on CPU tensors): the independent reference of the tests and
the "K1 loop" that chip_smoke.py times beside the kernels.
"""

from __future__ import annotations

import math

import torch

from .. import _device
from ..ff import limbs as L
from ..mirror.field import BLS_X
from . import cuda_pairing as CP
from . import tower as T
from .fields import FqOps as F

FQ = L.FQ

# the shared iteration schedule of g2_prepare and the Miller loop (62 steps,
# 5 set): MSB-first bits of BLS_X >> 1 with the leading one skipped
_SCHED = CP.SCHED


def _st(*xs, dim=2):
    return torch.stack(xs, dim)


def _doubling_step(r):
    """One Miller doubling step on R = (rx, ry, rz), an Fq2 triple
    (12, 2, 3, *batch); -> (new R, line coefficients (c_last, c0, c2) in the
    same layout).  The independent squarings and products of each stage
    share a launch."""
    rx, ry, rz = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    sq = T.fq2_sqr(r)                                       # tmp0, tmp1, zsq
    tmp0, tmp1, zsq = sq[:, :, 0], sq[:, :, 1], sq[:, :, 2]
    s = F.add(_st(tmp1, rz), _st(rx, ry))                   # tmp1 + rx, rz + ry
    sq = T.fq2_sqr(_st(tmp1, s[:, :, 0], s[:, :, 1]))
    tmp2 = sq[:, :, 0]
    d = F.sub(F.sub(sq[:, :, 1:], _st(tmp0, tmp1)), _st(tmp2, zsq))
    tmp3 = T.fq2_dbl(d[:, :, 0])
    nrz = d[:, :, 1]
    tmp4 = T.fq2_mul_small(tmp0, 3)
    tmp6 = F.add(rx, tmp4)
    sq = T.fq2_sqr(_st(tmp4, tmp6))
    tmp5 = sq[:, :, 0]
    nrx = F.sub(F.sub(tmp5, tmp3), tmp3)
    m = T.fq2_mul(_st(F.sub(tmp3, nrx), tmp4, nrz), _st(tmp4, zsq, zsq))
    k = T.fq2_mul_small(_st(tmp2, tmp1), 4)                 # 4 tmp2, 4 tmp1
    nry = F.sub(m[:, :, 0], T.fq2_dbl(k[:, :, 0]))          # - 8 tmp2
    dd = T.fq2_dbl(m[:, :, 1:])                             # 2 tmp4 zsq, 2 nrz zsq
    c0 = F.neg(dd[:, :, 0])
    c2 = F.sub(F.sub(sq[:, :, 1], tmp0), F.add(tmp5, k[:, :, 1]))
    return _st(nrx, nry, nrz), _st(dd[:, :, 1], c0, c2)


def _addition_step(r, qx, qy):
    """One Miller addition step of R against the affine base Q."""
    rx, ry, rz = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    rz, qx, qy = T.bcast(rz, qx, qy)
    sq = T.fq2_sqr(_st(rz, qy, F.add(qy, rz)))
    zsq, ysq = sq[:, :, 0], sq[:, :, 1]
    u = F.sub(F.sub(sq[:, :, 2], ysq), zsq)
    m = T.fq2_mul(_st(zsq, u), _st(qx, zsq))                # t0, t1
    d = F.sub(m, _st(rx, ry))                               # t2, t1 - ry
    t2 = d[:, :, 0]
    t6 = F.sub(d[:, :, 1], ry)
    sq2 = T.fq2_sqr(_st(t2, t6, F.add(rz, t2)))
    t3 = sq2[:, :, 0]
    t4 = T.fq2_mul_small(t3, 4)
    m = T.fq2_mul(_st(t4, t6, t4), _st(t2, qx, rx))         # t5, t9, t7
    t5, t9, t7 = m[:, :, 0], m[:, :, 1], m[:, :, 2]
    e = F.sub(F.sub(sq2[:, :, 1:], _st(t5, zsq)), _st(t7, t3))
    nrx = F.sub(e[:, :, 0], t7)
    nrz = e[:, :, 1]
    m = T.fq2_mul(_st(F.sub(t7, nrx), ry), _st(t6, t5))     # t8, ry t5
    sq3 = T.fq2_sqr(_st(F.add(qy, nrz), nrz))
    dd = T.fq2_dbl(_st(m[:, :, 1], t9, nrz, F.neg(t6)))
    nry = F.sub(m[:, :, 0], dd[:, :, 0])
    t10 = F.sub(F.sub(sq3[:, :, 0], ysq), sq3[:, :, 1])
    c2 = F.sub(dd[:, :, 1], t10)
    return _st(nrx, nry, nrz), _st(dd[:, :, 2], dd[:, :, 3], c2)


def g2_prepare_tower(qx, qy):
    """g2_prepare as a chain of tower operations."""
    qx, qy = T.bcast(qx, qy)
    one = torch.zeros_like(qx)
    one[:, 0] = FQ.const(FQ.r_mod_p, one[:, 0])
    r = _st(qx, qy, one)
    dbl, add = [], []
    for bit in _SCHED:
        r, c = _doubling_step(r)
        dbl.append(c)
        if bit:
            r, c = _addition_step(r, qx, qy)
        add.append(c if bit else None)
    _, final = _doubling_step(r)
    return dbl, add, final


def _ell(f, coeffs, px, py):
    """f times the line (c2, c1 px, 0; 0, c0 py, 0): c0 py and c1 px in one
    launch."""
    m = F.mul(coeffs[:, :, :2], torch.stack([py, px], 1).unsqueeze(1))
    return T.fq12_mul_by_014(f, coeffs[:, :, 2], m[:, :, 1], m[:, :, 0])


def miller_loop_tower(pairs):
    """miller_loop as a chain of tower operations."""
    px0 = pairs[0][0][0]
    f = T.fq12_one(px0.shape[1:], px0.device)
    for k, bit in enumerate(_SCHED):
        for (px, py), (dbl, add, _) in pairs:
            f = _ell(f, dbl[k], px, py)
            if bit:
                f = _ell(f, add[k], px, py)
        f = T.fq12_sqr(f)
    for (px, py), (_, _, final) in pairs:
        f = _ell(f, final, px, py)
    return T.fq12_conj(f)


def _pow(f, e: int):
    """f^e, MSB-first square-and-multiply on the host's bits of e."""
    acc = f
    for bit in bin(e)[3:]:
        acc = T.fq12_sqr(acc)
        if bit == "1":
            acc = T.fq12_mul(acc, f)
    return acc


def _exp_by_x(f):
    return T.fq12_conj(_pow(f, BLS_X))  # x is negative


def final_exponentiation_tower(r):
    """final_exponentiation as a chain of tower operations (mod.rs:104-160)."""
    f1 = T.fq12_conj(r)
    f2 = T.fq12_inv(r)
    rr = T.fq12_mul(f1, f2)
    f2 = rr
    rr = T.fq12_mul(T.fq12_frobenius(rr, 2), f2)

    y0 = T.fq12_sqr(rr)
    y1 = _exp_by_x(y0)
    y2 = T.fq12_conj(_pow(y1, BLS_X >> 1))
    y3 = T.fq12_conj(rr)
    y1 = T.fq12_mul(y1, y3)
    y1 = T.fq12_conj(y1)
    y1 = T.fq12_mul(y1, y2)
    y2 = _exp_by_x(y1)
    y3 = _exp_by_x(y2)
    y1 = T.fq12_conj(y1)
    y3 = T.fq12_mul(y3, y1)
    y1 = T.fq12_conj(y1)
    y1 = T.fq12_frobenius(y1, 3)
    y2 = T.fq12_frobenius(y2, 2)
    y1 = T.fq12_mul(y1, y2)
    y2 = _exp_by_x(y3)
    y2 = T.fq12_mul(y2, y0)
    y2 = T.fq12_mul(y2, rr)
    y1 = T.fq12_mul(y1, y2)
    y2 = T.fq12_frobenius(y3, 1)
    return T.fq12_mul(y1, y2)


def pairing_tower(px, py, qx, qy):
    """pairing as a chain of tower operations."""
    return final_exponentiation_tower(miller_loop_tower([((px, py),
                                                          g2_prepare_tower(qx, qy))]))


def _rows(cols, lead, batch):
    """Tensors (*lead dims, *batch') broadcast to batch and stacked ->
    (12, rows, B), the rows of cuda_pairing's sets."""
    out = []
    for c in cols:
        b = c.shape[lead:]
        c = c.reshape(*c.shape[:lead], *(1,) * (len(batch) - len(b)), *b)
        out.append(c.expand(*c.shape[:lead], *batch))
    return torch.stack(out, 1).reshape(FQ.n, -1, math.prod(batch))


def g2_prepare(qx, qy):
    """Line coefficients for affine G2 bases (Fq2 tensors (12, 2, *batch)).
    -> (dbl, add, final): dbl a list of the 62 doubling steps' coefficients
    (each (12, 2, 3, *batch)), add the 62 steps' addition coefficients,
    None where the schedule's bit is clear, final the last doubling's: views
    of one launch's rows (cuda_pairing.miller_set("prepare"))."""
    batch = torch.broadcast_shapes(qx.shape[2:], qy.shape[2:])
    ins = _rows([qx[:, 0], qx[:, 1], qy[:, 0], qy[:, 1]], 1, batch)
    c = CP.execute(CP.miller_set("prepare"), ins).reshape(
        FQ.n, CP.N_STEPS, 2, 2, 3, *batch)
    return ([c[:, k, 0] for k in range(len(_SCHED))],
            [c[:, k, 1] if bit else None for k, bit in enumerate(_SCHED)],
            c[:, len(_SCHED), 0])


def miller_loop(pairs):
    """pairs: [((px, py), (dbl, add, final)), ...], G1 coordinates and
    prepared G2 coefficients of one batch shape.  -> Fq12 (conjugated:
    BLS_X < 0), from one launch of cuda_pairing.miller_set("loop",
    len(pairs)): the pairs share f."""
    batch = torch.broadcast_shapes(*(x.shape[1:] for (p, _) in pairs for x in p),
                                   *(c[-1].shape[3:] for _, c in pairs))
    cols = [x for (p, _) in pairs for x in p]
    for _, (dbl, add, final) in pairs:
        zero = torch.zeros_like(final)
        for k in range(len(_SCHED)):
            cols += [dbl[k], zero if add[k] is None else add[k]]
        cols += [final, zero]
    n_p = 2 * len(pairs)
    ins = torch.cat([_rows(cols[:n_p], 1, batch), _rows(cols[n_p:], 3, batch)], 1)
    f = CP.execute(CP.miller_set("loop", len(pairs)), ins)
    return f.reshape(FQ.n, 2, 3, 2, *batch)


def final_exponentiation(r):
    """mod.rs:104-160 in one launch of cuda_pairing.final_exp_set().
    Assumes r != 0 (true for Miller outputs of valid points)."""
    out = CP.execute(CP.final_exp_set(), r.reshape(FQ.n, 12, -1).contiguous())
    return out.reshape(r.shape)


def pairing(px, py, qx, qy):
    """e(P, Q) on device tensors (trailing batch axes ride through): one
    launch of cuda_pairing.miller_set("pairing") (the G2 preparation and the
    Miller loop) and one of final_exp_set()."""
    batch = torch.broadcast_shapes(px.shape[1:], py.shape[1:], qx.shape[2:], qy.shape[2:])
    ins = _rows([px, py, qx[:, 0], qx[:, 1], qy[:, 0], qy[:, 1]], 1, batch)
    f = CP.execute(CP.miller_set("pairing"), ins)
    return CP.execute(CP.final_exp_set(), f).reshape(FQ.n, 2, 3, 2, *batch)


def g1_tensors(points, device):
    """Affine G1 points [(x, y), ...] -> (px, py), each (12, len)."""
    return tuple(FQ.array([p[i] for p in points], device, mont=True)
                 for i in range(2))


def g2_tensors(points, device):
    """Affine G2 points [((x0, x1), (y0, y1)), ...] -> (qx, qy), each
    (12, 2, len)."""
    return tuple(T.fq2_from_ints([p[i] for p in points], device) for i in range(2))


def pairing_host_batch(ps, qs, device=None):
    """e(P_i, Q_i) for host affine ints, the pairs on one batch axis of one
    call; -> a list of host Fq12 nested int tuples."""
    device = _device.resolve(device)
    return T.fq12_to_ints(pairing(*g1_tensors(ps, device), *g2_tensors(qs, device)))


def pairing_host(p, q, device=None):
    """e(P, Q) for host affine ints; returns host Fq12 nested int tuples."""
    return pairing_host_batch([p], [q], device)[0]
