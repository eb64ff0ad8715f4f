"""Port field arithmetic (zerochain_tpu_torch.ff) against the JAX package
and the bigint mirror.

The same integers, drawn from a numpy seed, go through
``zerochain_tpu.ff.limbs`` (composed path, as on any CPU) and through the
port on ``device="cpu"`` (the plain versions of the field kernels).  All
comparisons are exact: tolerance 0."""

import numpy as np
import pytest
import torch

from zerochain_tpu.ff import limbs as JL
from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ff import cuda_ff
from zerochain_tpu_torch.ff import limbs as TL

torch.set_num_threads(2)  # several test workers share the cores

N = 1024
SPECS = {"Fq": (JL.FQ, TL.FQ), "Fr": (JL.FR, TL.FR), "Fs": (JL.FS, TL.FS)}


def _values(p, seed):
    rng = np.random.RandomState(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % p for _ in range(N)]
    return vals + [0, 1, p - 1]


@pytest.fixture(scope="module", params=sorted(SPECS))
def case(request):
    jspec, tspec = SPECS[request.param]
    a = _values(tspec.p, 11)
    b = _values(tspec.p, 12)[::-1]
    ta = tspec.array(a, "cpu", mont=True)
    tb = tspec.array(b, "cpu", mont=True)
    ja = JL.to_limbs(jspec, a, mont=True)
    jb = JL.to_limbs(jspec, b, mont=True)
    return jspec, tspec, a, b, ta, tb, ja, jb


def _same(tspec, jspec, t_out, j_out, mont=True):
    """Port output == JAX output, through convert, word for word."""
    want = convert.from_ref_limbs(tspec, np.asarray(j_out), mont=mont)
    assert torch.equal(t_out, want)


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_ops(case, op):
    jspec, tspec, a, b, ta, tb, ja, jb = case
    p = tspec.p
    t_out = getattr(TL, op)(tspec, ta, tb)
    mirror = {"mont_mul": lambda x, y: x * y % p,
              "add": lambda x, y: (x + y) % p,
              "sub": lambda x, y: (x - y) % p}[op]
    assert tspec.to_ints(t_out, mont=True) == [mirror(x, y) for x, y in zip(a, b)]
    _same(tspec, jspec, t_out, getattr(JL.ops(jspec), {"mont_mul": "mul"}.get(op, op))(ja, jb))


@pytest.mark.parametrize("op", ["mont_sqr", "neg"])
def test_unary_ops(case, op):
    jspec, tspec, a, _, ta, _, ja, _ = case
    p = tspec.p
    t_out = getattr(TL, op)(tspec, ta)
    mirror = {"mont_sqr": lambda x: x * x % p, "neg": lambda x: -x % p}[op]
    assert tspec.to_ints(t_out, mont=True) == [mirror(x) for x in a]
    _same(tspec, jspec, t_out, getattr(JL.ops(jspec), {"mont_sqr": "sqr"}.get(op, op))(ja))


def test_mont_conversions(case):
    jspec, tspec, a, _, ta, _, ja, _ = case
    canon = TL.from_mont(tspec, ta)
    assert tspec.to_ints(canon) == a
    _same(tspec, jspec, canon, JL.ops(jspec).from_mont(ja), mont=False)
    back = TL.to_mont(tspec, canon)
    assert torch.equal(back, ta)
    _same(tspec, jspec, back, JL.ops(jspec).to_mont(JL.to_limbs(jspec, a)))


def test_inverses(case):
    jspec, tspec, a, _, ta, _, ja, _ = case
    p = tspec.p
    want = [pow(x, -1, p) if x else 0 for x in a]
    k = 64  # Fermat inversion is ~p.bit_length() sequential squarings
    inv = TL.inv_mont(tspec, ta[:, :k])
    assert tspec.to_ints(inv, mont=True) == want[:k]
    binv = TL.batch_inv_mont(tspec, ta[:, : N].reshape(tspec.n, 4, N // 4), axis=2)
    assert tspec.to_ints(binv, mont=True) == want[:N]
    jb = JL.ops(jspec).batch_inv(ja[:, :k].reshape(jspec.n, 4, k // 4))
    _same(tspec, jspec, binv[:, :, : k // 4][:, :1].reshape(tspec.n, -1),
          np.asarray(jb).reshape(jspec.n, 4, k // 4)[:, :1].reshape(jspec.n, -1))


def test_helpers_and_bad_input(case):
    _, tspec, a, _, ta, tb, _, _ = case
    assert TL.is_zero(ta).tolist() == [x == 0 for x in a]
    assert bool(TL.eq(ta, ta).all())
    assert torch.equal(TL.select(TL.is_zero(ta), tb, ta)[:, :N], ta[:, :N])
    assert tspec.to_ints(TL.ones_mont(tspec, (2,), "cpu"), mont=True) == [1, 1]
    assert tspec.to_ints(TL.zeros(tspec, (2,), "cpu")) == [0, 0]
    assert tspec.to_ints(TL.pow_fixed(tspec, ta[:, :4], 5), mont=True) == [
        pow(x, 5, tspec.p) for x in a[:4]]
    with pytest.raises(TypeError):
        cuda_ff.add(tspec, ta.to(torch.int64), tb)
    with pytest.raises(ValueError):
        cuda_ff.add(tspec, ta[:-1], tb[:-1])


def test_convert_round_trip(case):
    jspec, tspec, a, _, ta, _, ja, _ = case
    assert np.array_equal(convert.to_ref_limbs(tspec, ta, mont=True), np.asarray(ja))
    assert torch.equal(convert.from_ref_limbs(tspec, np.asarray(ja), mont=True), ta)
