"""The port's bucket MSM (msm/pippenger.py: Msm) against the
JAX package's ``Msm`` on the CPU, where the JAX side runs its composed
Hillis-Steele levels.

Both sort the digits stably, add in the same order and select the same
cases, so the Jacobian words agree exactly (tolerance 0), and the points
agree with the mirror.  G1 only: XLA compiles the JAX G1 ``Msm`` in about
70 s on a CPU and the G2 one in about six minutes; the port's G2 ``Msm`` is
held against the mirror in test_torch_hs_msm.py.  This file stands apart so
that neither file runs past two minutes; for the same reason it also holds
the host ``msm_g2`` at N = 10 (double-and-add) against the mirror, the one
host-MSM case that test_torch_hs_msm.py leaves out."""

import numpy as np
import torch

from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ec import g1 as tg1
from zerochain_tpu_torch.ec.fields import FqOps
from zerochain_tpu_torch.mirror import curves as cv
from zerochain_tpu_torch.msm import pippenger as pip

torch.set_num_threads(2)  # several test workers share the cores

N = 128
B = 2


def test_msm_matches_the_jax_msm():
    import jax.numpy as jnp

    from zerochain_tpu.ec import g1 as jg1
    from zerochain_tpu.ec.fields import FqOps as JFq
    from zerochain_tpu.msm import pippenger as jpip

    rng = np.random.RandomState(19)
    base = [cv.g1_mul(cv.G1_GEN, int(rng.randint(2, 1 << 30)))
            for _ in range(16)]
    pts = [base[int(rng.randint(0, 16))] for _ in range(N)]
    pts[3] = None
    pts[10] = pts[11]
    pts[20] = cv.g1_neg(pts[21])
    scal = [[int(rng.randint(0, 1 << 16)) for _ in range(N)] for _ in range(B)]
    scal[0][10] = scal[0][11] = 0x1234
    scal[0][20] = scal[0][21] = 0x0567
    scal[1][:8] = [0] * 8
    bits = torch.stack([pip.scalars_to_bits(s, 16, "cpu") for s in scal], -1)

    msm = pip.Msm(FqOps, c=4, n_bits=16)
    got = msm(tg1.from_affine_host(pts, device="cpu"), bits)
    jmsm = jpip.Msm(JFq, c=4, n_bits=16, window_group=3, mode="hs")
    want = jmsm(jg1.from_affine_host(pts), jnp.asarray(bits.numpy()))
    want = convert.points_from_ref(tuple(np.asarray(c) for c in want))
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    mirror = []
    for s in scal:
        acc = None
        for p, k in zip(pts, s):
            if p is not None and k:
                acc = cv.g1_add(acc, cv.g1_mul(p, k))
        mirror.append(acc)
    assert tg1.to_affine_host(got) == mirror


def test_host_msm_g2_double_and_add():
    from test_torch_hs_msm import check_host_msm

    check_host_msm("g2", 10)
