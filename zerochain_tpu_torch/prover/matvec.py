"""Sparse A/B/C constraint evaluation on device.

The circuit's linear combinations are frozen once into COO arrays
(constraint row, variable column, Fr coefficient); per-proof evaluation is
then gather -> Montgomery multiply -> segment-sum over rows -> one reduction
mod p: fully batched, no interpretation.

Headroom: the products are 8 words of 32 bits, so a row sum needs more than
8 words.  Each word column is summed on its own in int64 (a row of k terms
gives column sums < k * 2^32; k < 2^31 is asserted, real rows have < 2^7
terms), the columns are carried into nine words, and the ninth (< k) is
folded back with hi * 2^256 mod p.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..ff import cuda_ff
from ..ff import limbs as L
from ..mirror.field import R
from ..r1cs.system import ConstraintSystem

FR = L.FR


class ConstraintMatrices:
    """Frozen A/B/C of one circuit + a batched evaluator."""

    def __init__(self, cs: ConstraintSystem, num_inputs: int, device=None):
        self.device = _device.resolve(device)
        self.num_constraints = cs.num_constraints
        self.num_inputs = num_inputs
        self.num_aux = len(cs.aux)
        self.num_vars = num_inputs + self.num_aux

        mats = []
        for which in range(3):
            rows, cols, coeffs = [], [], []
            for cidx, constraint in enumerate(cs.constraints):
                for (kind, idx), coeff in constraint[which]:
                    rows.append(cidx)
                    cols.append(idx if kind == "I" else num_inputs + idx)
                    coeffs.append(coeff % R)
            order = np.argsort(np.asarray(rows, dtype=np.int64), kind="stable")
            rows = np.asarray(rows, dtype=np.int64)[order]
            cols = np.asarray(cols, dtype=np.int64)[order]
            if len(rows):
                assert np.bincount(rows).max() < 1 << 31
            cmat = FR.array([coeffs[i] for i in order], self.device, mont=True)
            mats.append((rows, cols, cmat))
        # (rows, cols) stay on the host as numpy (the prover reads the
        # column sets); device copies drive the evaluation
        self.mats = mats
        self._dev = [
            (torch.from_numpy(r).to(self.device),
             torch.from_numpy(c).to(self.device))
            for r, c, _ in mats
        ]

    def _eval_one(self, which, witness):
        """witness: (8, num_vars, *batch) Montgomery words ->
        (8, num_constraints, *batch)."""
        rows, cols = self._dev[which]
        coeffs = self.mats[which][2]
        vals = witness.index_select(1, cols)  # (8, nnz, *b)
        cshaped = coeffs.reshape(
            (FR.n, coeffs.shape[1]) + (1,) * (witness.dim() - 2))
        prods = L.mont_mul(FR, vals, cshaped)
        wide = prods.to(torch.int64) & 0xFFFFFFFF
        sums = torch.zeros(
            (FR.n, self.num_constraints, *witness.shape[2:]),
            dtype=torch.int64, device=witness.device)
        sums.index_add_(1, rows, wide)
        lo, hi = cuda_ff._ripple(sums)  # value = lo + hi * 2^256
        lo = cuda_ff._narrow(lo)
        # lo < 2^256 is not canonical: out of and back into the Montgomery
        # domain reduces it (both multiplies accept any a < R)
        lo = L.to_mont(FR, L.from_mont(FR, lo))
        hi_fe = torch.zeros_like(lo)
        hi_fe[0] = hi.to(torch.int32)
        # hi * R mod p, R = 2^256
        return L.add(FR, lo, L.to_mont(FR, hi_fe))

    def eval(self, witness):
        """-> (a_vals, b_vals, c_vals), each (8, m, *batch) Montgomery."""
        return tuple(self._eval_one(k, witness) for k in range(3))
