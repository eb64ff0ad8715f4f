"""The port's bucket MSM (zerochain_tpu_torch.msm.pippenger: Msm,
naive_msm, msm_g1/msm_g2) and the plain version of its Hillis-Steele level
kernel (ec/cuda_ec.py: hs_add_select) against the JAX package and the
bigint mirror.

- ``hs_add_select``: the plain version against the JAX package's composed
  level ``select(keep, x, select(f, x, add(xl, x)))`` on the same words
  (through ``convert``), with doublings, opposite points, identities and the
  wrapped roll among the inputs: exact on words.
- ``Msm``: against the mirror's sum of scalar multiples, after ``normalize``
  (exact), with 4-bit windows and with 3-bit ones (a top window of 1 bit).  The JAX ``Msm`` itself is held against the
  port in test_torch_hs_msm_jax.py (its XLA compile takes over a minute).
- ``msm_g1`` / ``msm_g2``: the host entry points against the mirror at
  N = 10 (double-and-add; oracle ``g1_msm`` / ``g2_msm``) and N = 100
  (``Msm``; oracle the mirror's bucket MSM ``g1_msm_fast`` / ``g2_msm_fast``,
  itself held against ``g1_msm`` at N = 10 here).

The fold over 255 buckets is 510 sequential point adds, all windows side by
side; the CPU runs them at the speed of tiny tensor operations."""

import numpy as np
import pytest
import torch

from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ec import cuda_ec
from zerochain_tpu_torch.ec import g1 as tg1
from zerochain_tpu_torch.ec import g2 as tg2
from zerochain_tpu_torch.ec import weierstrass as W
from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
from zerochain_tpu_torch.ff import limbs as TL
from zerochain_tpu_torch.mirror import curves as cv
from zerochain_tpu_torch.mirror.field import R
from zerochain_tpu_torch.msm import pippenger as pip

torch.set_num_threads(2)  # several test workers share the cores

GROUPS = {
    "g1": (tg1, FqOps, cv.G1_GEN, cv.g1_mul, cv.g1_add, cv.g1_neg),
    "g2": (tg2, Fq2Ops, cv.G2_GEN, cv.g2_mul, cv.g2_add, cv.g2_neg),
}
N = 128
B = 2


def _leaves(pt):
    out = []
    for c in pt:
        out.extend(c if isinstance(c, tuple) else (c,))
    return out


def _to_ref(pt):
    """A port point batch -> the JAX package's limb arrays."""
    import jax.numpy as jnp

    def conv(c):
        return jnp.asarray(convert.to_ref_limbs(TL.FQ, c, mont=True))

    return tuple(tuple(conv(x) for x in c) if isinstance(c, tuple) else conv(c)
                 for c in pt)


def _set(dst, k, src, j):
    for d, s in zip(_leaves(dst), _leaves(src)):
        d[..., k] = s[..., j]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_hs_add_select_matches_the_jax_level(name):
    import jax

    from zerochain_tpu.ec import weierstrass as JW
    from zerochain_tpu.ec.fields import FqOps as JFq, Fq2Ops as JFq2

    tg, F, gen, mul, add, neg = GROUPS[name]
    JF = JFq if name == "g1" else JFq2
    rng = np.random.RandomState(7)
    n, s = 16, 3
    base = [mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(n)]
    a = tg.from_affine_host(base, device="cpu")
    b = tg.from_affine_host(base[::-1], device="cpu")
    x = W.add(F, a, b)                       # partial sums: Z not in {0, 1}
    xl = tuple(tuple(t.roll(s, -1) for t in c) if isinstance(c, tuple)
               else c.roll(s, -1) for c in x)  # positions < s read the wrap
    _set(xl, 4, x, 4)                        # xl = x: a doubling
    _set(xl, 5, W.neg(F, x), 5)              # xl = -x: the identity
    ident = W.identity(F, (n,), "cpu")
    _set(xl, 6, ident, 6)                    # xl = inf
    _set(x, 7, ident, 7)                     # x = inf
    _set(xl, 8, ident, 8)
    _set(x, 8, ident, 8)                     # both inf
    _set(xl, 9, a, 9)
    _set(x, 9, W.neg(F, a), 9)               # affine P + (-P), Z = 1 on both
    f = torch.from_numpy(rng.rand(n) < 0.3)
    f[4:10] = False
    f[12] = True
    keep = torch.arange(n) < s

    got = cuda_ec.hs_add_select(F, xl, x, f, keep)
    level = jax.jit(lambda xl_, x_, f_, k_: JW.select(
        JF, k_, x_, JW.select(JF, f_, x_, JW.add(JF, xl_, x_))))
    want = level(_to_ref(xl), _to_ref(x), np.asarray(f), np.asarray(keep))
    want = convert.points_from_ref(
        tuple(tuple(np.asarray(t) for t in c) if isinstance(c, tuple)
              else np.asarray(c) for c in want))
    for g, w in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g, w)
    # the mirror agrees on the points
    aff, xa = tg.to_affine_host(got), tg.to_affine_host(x)
    assert aff[4] == add(xa[4], xa[4]) and aff[4] is not None
    assert aff[5] is None and aff[8] is None and aff[9] is None
    assert aff[6] == xa[6] and aff[12] == xa[12]


@pytest.fixture(scope="module", params=sorted(GROUPS))
def case(request):
    tg, F, gen, mul, add, neg = GROUPS[request.param]
    rng = np.random.RandomState(11)
    base = [mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(16)]
    pts = [base[int(rng.randint(0, 16))] for _ in range(N)]
    pts[3] = None                  # padding points
    pts[100] = None
    pts[10] = pts[11]              # duplicates: a doubling inside a bucket
    pts[20] = neg(pts[21])         # opposite points: the identity
    scal = [[int(rng.randint(0, 1 << 16)) for _ in range(N)] for _ in range(B)]
    scal[0][10] = scal[0][11] = 0x1234   # the same digit in every window
    scal[0][20] = scal[0][21] = 0x0567
    scal[1][:8] = [0] * 8
    want = []
    for s in scal:
        acc = None
        for p, k in zip(pts, s):
            if p is not None and k:
                acc = add(acc, mul(p, k))
        want.append(acc)
    bits = torch.stack([pip.scalars_to_bits(s, 16, "cpu") for s in scal], -1)
    return dict(tg=tg, F=F, tp=tg.from_affine_host(pts, device="cpu"),
                bits=bits, want=want)


@pytest.mark.parametrize("c", [3, 4])
def test_msm_matches_the_mirror(case, c):
    msm = pip.Msm(case["F"], c=c, n_bits=16)
    assert msm.n_windows == -(-16 // c)
    got = case["tg"].to_affine_host(msm(case["tp"], case["bits"]))
    assert got == case["want"]


def test_limbs_to_bits():
    rng = np.random.RandomState(13)
    vals = [0, 1, R - 1, (1 << 254) + 3] + [
        int.from_bytes(rng.bytes(32), "little") % R for _ in range(12)]
    words = TL.FR.array(vals, "cpu").reshape(8, 4, 4)
    bits = pip.limbs_to_bits(words, 255)
    assert bits.shape == (255, 4, 4) and bits.dtype == torch.int32
    assert torch.equal(bits.reshape(255, 16),
                       pip.scalars_to_bits(vals, 255, "cpu"))


def check_host_msm(name, n):
    """msm_g1 / msm_g2 on n points with padding, duplicates and opposite
    points among them, against the mirror."""
    _, _, gen, mul, add, neg = GROUPS[name]
    msm_host = pip.msm_g1 if name == "g1" else pip.msm_g2
    naive = cv.g1_msm if name == "g1" else cv.g2_msm
    fast = cv.g1_msm_fast if name == "g1" else cv.g2_msm_fast
    rng = np.random.RandomState(17 + n)
    base = [mul(gen, 3 + 5 * i) for i in range(12)]
    pts = [base[i % 12] for i in range(n)]
    pts[5] = None
    pts[6] = pts[7]                       # duplicates
    pts[8] = neg(pts[9])                  # opposite points
    scal = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    scal[1] = 0
    scal[2] = R - 1
    scal[8] = scal[9]
    got = msm_host(pts, scal, "cpu")
    keep = [(p, s) for p, s in zip(pts, scal) if p is not None]
    args = ([p for p, _ in keep], [s for _, s in keep])
    assert got == fast(*args)
    if n <= 10:
        assert got == naive(*args)
    assert msm_host([None, base[0]], [5, 0], "cpu") is None


# G2 at N = 10 runs in test_torch_hs_msm_jax.py, to keep each file short
@pytest.mark.parametrize("name, n", [("g1", 10), ("g1", 100), ("g2", 100)])
def test_host_msm(name, n):
    check_host_msm(name, n)
