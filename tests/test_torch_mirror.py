"""The mirror's fast paths give the slow paths' values: the field inverse
by pow(a, -1, p) equals Fermat's a^(p-2), and the Jubjub scalar multiply on
extended coordinates equals the affine double-and-add of ``add``."""

import random

import pytest

from zerochain_tpu_torch.mirror import field as mf
from zerochain_tpu_torch.mirror import jubjub as jj


@pytest.mark.parametrize("p, inv", [(mf.Q, mf.fq_inv), (mf.R, mf.fr_inv),
                                    (mf.S, mf.fs_inv)], ids=["Fq", "Fr", "Fs"])
def test_inverse_is_fermat(p, inv):
    rng = random.Random(p & 0xFFFF)
    values = [1, 2, p - 1, p, p + 3, 5 * p] + [rng.randrange(1, 1 << 400)
                                               for _ in range(500)]
    for a in values:
        assert inv(a) == pow(a, p - 2, p)
    with pytest.raises(ZeroDivisionError):
        inv(0)


def _affine_mul(p, k):
    result, addend = jj.ZERO, p
    while k:
        if k & 1:
            result = jj.add(result, addend)
        addend = jj.double(addend)
        k >>= 1
    return result


def test_scalar_mul_is_the_affine_double_and_add():
    rng = random.Random(7)
    g = jj.generator()
    points = [jj.ZERO, g, (0, mf.R - 1)]                      # (0, -1) has order 2
    points += [_affine_mul(g, rng.randrange(1, mf.S)) for _ in range(6)]
    for p in points:
        for k in [0, 1, 2, 3, 8, mf.S, mf.S + 1, mf.R, (1 << 256) - 1,
                  rng.randrange(1 << 252)]:
            assert jj.mul(p, k) == _affine_mul(p, k)
