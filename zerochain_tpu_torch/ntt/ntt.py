"""Batched radix-2 NTT over Fr word tensors.

Replaces the bellman fork's multicore radix-2 FFT (SURVEY.md §2.3):
elements are (8, ..., N) word tensors, each butterfly stage is one fully
batched Montgomery multiply + add + sub (three field-kernel launches) over
the whole (batch, N/2) plane, twiddles are precomputed per stage on the
host.  Fr's 2-adicity S = 32 (fr.rs:47) allows sizes up to 2^32; plans are
cached per (size, device).  Oracle: groth16/domain.py.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..ff import limbs as L
from ..groth16 import domain as dom
from ..mirror.field import R, FR_GENERATOR, fr_inv

FR = L.FR


def _powers(base: int, count: int) -> list[int]:
    out, cur = [], 1
    for _ in range(count):
        out.append(cur)
        cur = cur * base % R
    return out


class NttPlan:
    """Precomputed tables for one power-of-two size d on one device."""

    def __init__(self, d: int, device=None):
        assert d & (d - 1) == 0
        self.device = _device.resolve(device)
        self.d = d
        self.lg = d.bit_length() - 1
        omega = dom.omega_for(d)
        omega_inv = fr_inv(omega)

        def mont(vals):
            return FR.array(vals, self.device, mont=True)

        # bit-reversal permutation
        idx = np.arange(d)
        rev = np.zeros(d, dtype=np.int64)
        for b in range(self.lg):
            rev |= ((idx >> b) & 1) << (self.lg - 1 - b)
        self.bitrev = torch.from_numpy(rev).to(self.device)

        # per-stage twiddles: stage s has half-size m = 2^s, twiddles
        # w_m^l = omega^(d/(2m) * l) for l in 0..m-1
        def stage_twiddles(w):
            return [mont(_powers(pow(w, d // (2 << s), R), 1 << s))
                    for s in range(self.lg)]

        self.twiddles = stage_twiddles(omega)
        self.twiddles_inv = stage_twiddles(omega_inv)
        self.n_inv = mont([fr_inv(d)])[:, 0]

        # coset scaling vectors (Montgomery): g^i and g^{-i}
        self.coset = mont(_powers(FR_GENERATOR, d))
        self.coset_inv = mont(_powers(fr_inv(FR_GENERATOR), d))
        # 1 / z(coset) = 1 / (g^d - 1), Montgomery
        self.zinv = mont([fr_inv((pow(FR_GENERATOR, d, R) - 1) % R)])[:, 0]

    # -- core transforms (operate on last axis; word axis 0) ----------
    def _fft(self, a, twiddles):
        d = self.d
        a = a.index_select(-1, self.bitrev)
        batch = a.shape[1:-1]
        for s in range(self.lg):
            m = 1 << s
            nb = d // (2 * m)
            a = a.reshape(FR.n, *batch, nb, 2, m)
            even = a[..., 0, :]
            odd = a[..., 1, :]
            tw = twiddles[s].reshape((FR.n,) + (1,) * (len(batch) + 1) + (m,))
            t = L.mont_mul(FR, odd, tw)
            a = torch.stack([L.add(FR, even, t), L.sub(FR, even, t)], dim=-2)
        return a.reshape(FR.n, *batch, d)

    def _bcast(self, v, like):
        return v.reshape((FR.n,) + (1,) * (like.dim() - 1))

    def ntt(self, a):
        return self._fft(a, self.twiddles)

    def intt(self, a):
        out = self._fft(a, self.twiddles_inv)
        return L.mont_mul(FR, out, self._bcast(self.n_inv, out))

    def _scale(self, a, vec):
        v = vec.reshape((FR.n,) + (1,) * (a.dim() - 2) + (self.d,))
        return L.mont_mul(FR, a, v)

    def coset_ntt(self, coeffs):
        return self.ntt(self._scale(coeffs, self.coset))

    def icoset_ntt(self, evals):
        return self._scale(self.intt(evals), self.coset_inv)

    def divide_by_z_on_coset(self, evals):
        return L.mont_mul(FR, evals, self._bcast(self.zinv, evals))


def quotient(plan, a_ev, b_ev, c_ev):
    """Padded constraint evaluations (8, *batch, d) -> the Groth16
    quotient's coefficients h = (A * B - C) / Z: intt -> coset_ntt ->
    pointwise -> divide by Z on the coset -> icoset_ntt, through ``plan``
    (an ``NttPlan`` or a ``dist.DistNtt``: both have these transforms)."""
    a_c, b_c, c_c = (plan.coset_ntt(plan.intt(e)) for e in (a_ev, b_ev, c_ev))
    q = L.sub(FR, L.mont_mul(FR, a_c, b_c), c_c)
    return plan.icoset_ntt(plan.divide_by_z_on_coset(q))


_PLANS: dict = {}


def plan_for(d: int, device=None) -> NttPlan:
    dev = _device.resolve(device)
    key = (d, str(dev))
    if key not in _PLANS:
        _PLANS[key] = NttPlan(d, dev)
    return _PLANS[key]
