"""Groth16 compute backend on the port's device ops (host-level API).

The counterpart of ``zerochain_tpu/prover_tpu/backend.py``: a drop-in for
``groth16.core.MirrorBackend``, so ``generate_parameters`` and
``create_proof`` run their MSMs, fixed-base exponentiations and quotient
NTTs on the card.  The variable-base MSMs are the bucket ``Msm`` (one
``bucket_sums`` and one ``bucket_fold`` launch a chunk) above 64 points and
double-and-add below.

``device=None`` means the CUDA device and raises where there is none; only
``device="cpu"`` selects the CPU.
"""

from __future__ import annotations

from .. import _device
from ..ec.fields import FqOps, Fq2Ops
from ..ff import limbs as L
from ..mirror import curves as cv
from ..msm import pippenger as pip

FR = L.FR


class TorchBackend:
    """groth16.core backend: msm_g1/msm_g2, fixed_base_g1/fixed_base_g2,
    compute_h, all on ``device``."""

    def __init__(self, device=None):
        self.device = _device.resolve(device)
        self._fb_g1 = None
        self._fb_g2 = None

    def msm_g1(self, points, scalars):
        return pip.msm_g1(points, scalars, self.device)

    def msm_g2(self, points, scalars):
        return pip.msm_g2(points, scalars, self.device)

    def fixed_base_g1(self, exponents, chunk: int = 16384):
        from ..ec import g1 as grp

        if self._fb_g1 is None:
            self._fb_g1 = pip.FixedBaseMsm(FqOps, cv.G1_GEN, device=self.device)
        return self._fixed_base(self._fb_g1, grp, exponents, chunk)

    def fixed_base_g2(self, exponents, chunk: int = 8192):
        from ..ec import g2 as grp

        if self._fb_g2 is None:
            self._fb_g2 = pip.FixedBaseMsm(Fq2Ops, cv.G2_GEN, device=self.device)
        return self._fixed_base(self._fb_g2, grp, exponents, chunk)

    def _fixed_base(self, fb, grp, exponents, chunk):
        """[g^e for e in exponents] in chunks (the chunk bounds the
        window-gather temporaries); zero exponent -> None."""
        out = []
        for off in range(0, len(exponents), chunk):
            bits = pip.scalars_to_bits(exponents[off: off + chunk], 255,
                                       self.device)
            out.extend(grp.to_affine_host(fb(bits)))
        return out

    def compute_h(self, cs):
        """Quotient polynomial coefficients (d - 1 ints) by the device NTT
        plan: intt -> coset_ntt -> a*b - c -> divide by Z -> icoset_ntt."""
        from ..groth16 import domain as dom
        from ..ntt import plan_for, quotient

        m = cs.num_constraints
        d = dom.domain_size(m)
        plan = plan_for(d, self.device)

        def vals(which):
            evals = [cs.eval_lc(c[which]) for c in cs.constraints]
            return FR.array(evals + [0] * (d - m), self.device, mont=True)

        h = quotient(plan, vals(0), vals(1), vals(2))
        return FR.to_ints(h[:, : d - 1], mont=True)
