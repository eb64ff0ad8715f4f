"""Four-step distributed NTT family over Fr (the counterpart of
``zerochain_tpu/dist/ntt.py``).

Decompose d = d1 * d2, with the rows j split over the ranks of a process
group:
  B[j, k] = x[k * d1 + j]
  1. local length-d2 (i)NTT along k (root w^d1, the port's ``NttPlan``)
  2. local twiddle multiply by w^{+-j*r}
  3. all-to-all transpose (the only exchange between the ranks)
  4. local length-d1 (i)NTT along j (root w^d2)
giving Y[q * d2 + r] = E[q, r]; one all-gather of the column blocks gives
every rank the whole result again.  The inverse is the same with inverse
roots (the two local intts contribute 1/d1 * 1/d2 = 1/d).  Coset scalings
are separable across the decomposition (g^(k*d1 + j) = g^j * (g^d1)^k), so
the coset variants add only local elementwise multiplies: a pre-scale in the
input layout B[j, k], a post-scale in the output layout E[q, r].  That is
what the Groth16 quotient needs: intt -> coset_ntt -> pointwise ->
divide-by-z -> icoset_ntt (``DistNtt.quotient``).

Every rank passes the replicated (8, *batch, d) Montgomery word tensor and
gets the replicated result; rank r owns rows r * d1 / n .. (r + 1) * d1 / n
before the exchange and the same block of columns r after it.  The local
transforms are ``NttPlan``'s (on the card its pass kernel, on a contiguous
copy of the transposed views), the twiddle and coset multiplies K1 launches
(``cuda_ff``); the exchanges are ``comm.all_to_all`` and ``comm.all_gather``
along dim 0.
"""

from __future__ import annotations

import torch

from .. import _device
from ..ff import limbs as L
from ..groth16 import domain as dom
from ..mirror.field import R, FR_GENERATOR, fr_inv
from ..ntt.ntt import _powers, plan_for, quotient
from . import comm

FR = L.FR

# Largest d1 * d2 whose twiddles are computed on the host; above it the
# rows are built on the device, one K1 multiply a row.
HOST_TWIDDLES = 1 << 16


def _pow_vec(base: int, n: int, device) -> torch.Tensor:
    """(8, n) Montgomery powers base^0 .. base^(n-1)."""
    return FR.array(_powers(base, n), device, mont=True)


def _twiddle_matrix(d1: int, d2: int, omega: int, device,
                    rows: range | None = None) -> torch.Tensor:
    """(8, len(rows), d2) Montgomery words of w^{j*r} for the rows j (all d1
    where rows is None).  Up to HOST_TWIDDLES entries on the host; above
    that row j+1 = row j * [w^r]_r on the device, from the first row's
    powers, one K1 multiply a row."""
    rows = range(d1) if rows is None else rows
    if d1 * d2 <= HOST_TWIDDLES:
        vals = [v for j in rows for v in _powers(pow(omega, j, R), d2)]
        return FR.array(vals, device, mont=True).reshape(FR.n, len(rows), d2)
    wvec = _pow_vec(omega, d2, device)
    cur = _pow_vec(pow(omega, rows.start, R), d2, device)
    out = []
    for _ in rows:
        out.append(cur)
        cur = L.mont_mul(FR, cur, wvec)
    return torch.stack(out, dim=1)


class DistNtt:
    """Distributed transforms for one (d1, d2) split over a process group
    (None: the default group), on ``device`` (None: the card)."""

    def __init__(self, d1: int, d2: int, group=None, device=None):
        self.device = dev = _device.resolve(device)
        self.d1, self.d2, self.d = d1, d2, d1 * d2
        self.group = group
        self.rank, self.n_dev = rank, n = comm.world(group)
        if d1 % n or d2 % n:
            raise ValueError(f"d1 = {d1} and d2 = {d2} must both divide by "
                             f"the world size {n}")
        self.rows = range(rank * d1 // n, (rank + 1) * d1 // n)
        self.cols = slice(rank * d2 // n, (rank + 1) * d2 // n)
        omega = dom.omega_for(self.d)
        omega_inv = fr_inv(omega)
        # this rank's twiddle rows, (8, d1 / n, d2)
        self.tw_f = _twiddle_matrix(d1, d2, omega, dev, self.rows)
        self.tw_i = _twiddle_matrix(d1, d2, omega_inv, dev, self.rows)
        g, gi = FR_GENERATOR, fr_inv(FR_GENERATOR)
        rows = slice(self.rows.start, self.rows.stop)
        # coset pre-scale in the input layout B[j, k] (i = k * d1 + j)
        self.cs_row = _pow_vec(g, d1, dev)[:, rows]          # g^j, local j
        self.cs_col = _pow_vec(pow(g, d1, R), d2, dev)       # (g^d1)^k
        # icoset post-scale in the output layout E[q, r] (i = q * d2 + r)
        self.ics_row = _pow_vec(pow(gi, d2, R), d1, dev)     # (g^-d2)^q
        self.ics_col = _pow_vec(gi, d2, dev)[:, self.cols]   # g^-r, local r
        self.zinv = FR.array([fr_inv((pow(g, self.d, R) - 1) % R)], dev,
                             mont=True)[:, 0]
        self.plan1, self.plan2 = plan_for(d1, dev), plan_for(d2, dev)

    def _run(self, x, inverse: bool, coset_pre: bool, coset_post: bool):
        """x: (8, *batch, d) replicated -> the same, transformed."""
        d1, d2, n = self.d1, self.d2, self.n_dev
        lead = tuple(x.shape[:-1])
        nb = len(lead) - 1

        def vec(v, rows, cols):  # (8, rows * cols) -> broadcast over the batch
            return v.reshape(FR.n, *(1,) * nb, rows, cols)

        # B[j, k] = x[k * d1 + j], this rank's rows j
        xb = x.reshape(*lead, d2, d1).transpose(-1, -2)[..., self.rows.start:
                                                        self.rows.stop, :]
        if coset_pre:
            xb = L.mont_mul(FR, xb, vec(self.cs_row, d1 // n, 1))
            xb = L.mont_mul(FR, xb, vec(self.cs_col, 1, d2))
        # step 1: the local transform along k
        c = (self.plan2.intt if inverse else self.plan2.ntt)(xb)
        # step 2: twiddles w^{+-j*r} on the local rows j
        tw = self.tw_i if inverse else self.tw_f
        c = L.mont_mul(FR, c, tw.reshape(FR.n, *(1,) * nb, d1 // n, d2))
        # step 3: column block s to rank s; from each rank its rows of ours
        blocks = c.reshape(*lead, d1 // n, n, d2 // n).movedim(-2, 0)
        c = comm.all_to_all(blocks, self.group).movedim(0, -3)
        c = c.reshape(*lead, d1, d2 // n)
        # step 4: the local transform along j -> E[q, r], local r
        e = (self.plan1.intt if inverse else self.plan1.ntt)(c.transpose(-1, -2))
        e = e.transpose(-1, -2)
        if coset_post:
            e = L.mont_mul(FR, e, vec(self.ics_row, d1, 1))
            e = L.mont_mul(FR, e, vec(self.ics_col, 1, d2 // n))
        # re-replicate: gather the column blocks, Y[q * d2 + r] = E[q, r]
        full = comm.all_gather(e.movedim(-1, 0), self.group)
        return full.reshape(d2, *lead, d1).movedim(0, -1).reshape(*lead, self.d)

    # public ------------------------------------------------------------
    def ntt(self, x):
        return self._run(x, False, False, False)

    def intt(self, x):
        return self._run(x, True, False, False)

    def coset_ntt(self, x):
        return self._run(x, False, True, False)

    def icoset_ntt(self, x):
        return self._run(x, True, False, True)

    def divide_by_z_on_coset(self, evals):
        """Divide by Z(x) = x^d - 1 on the coset, a constant there: one
        local elementwise multiply by 1 / (g^d - 1)."""
        return L.mont_mul(FR, evals,
                          self.zinv.reshape((FR.n,) + (1,) * (evals.dim() - 1)))

    def quotient(self, a_ev, b_ev, c_ev):
        """Padded constraint evaluations (8, *batch, d) -> the quotient's
        coefficients h = (A * B - C) / Z on the coset, back in coefficient
        form: ``ntt.quotient``'s chain through these transforms."""
        return quotient(self, a_ev, b_ev, c_ev)


_DIST_PLANS: dict = {}


def dist_plan_for(d: int, group=None, device=None) -> DistNtt:
    """The DistNtt of d on this group and device: d split sqrt-balanced, d1
    doubled until d2 divides by the world size."""
    dev = _device.resolve(device)
    rank, n = comm.world(group)
    key = (d, group, rank, n, str(dev))
    if key not in _DIST_PLANS:
        lg = d.bit_length() - 1
        d1 = 1 << ((lg + 1) // 2)
        d2 = d // d1
        while d2 % n != 0 and d1 < d:
            d1 <<= 1
            d2 >>= 1
        _DIST_PLANS[key] = DistNtt(d1, d2, group, dev)
    return _DIST_PLANS[key]


def distributed_ntt(x, d1: int, d2: int, group=None):
    """x: (8, d) Montgomery word tensor, replicated -> (8, d) NTT output,
    computed with the rows split over the group's ranks."""
    return DistNtt(d1, d2, group, x.device).ntt(x)
