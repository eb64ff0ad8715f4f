"""Fq2 / Fq6 / Fq12 tower arithmetic over batched Fq word tensors.

An element is ONE int32 tensor, Fq words first, then its tower components,
innermost first, then any batch axes:

    Fq2   (12, 2, *batch)         c0 + c1 u,             u^2 = -1
    Fq6   (12, 2, 3, *batch)      c0 + c1 v + c2 v^2,    v^3 = xi = 1 + u
    Fq12  (12, 2, 3, 2, *batch)   c0 + c1 w,             w^2 = v

so an Fq6 is also an Fq2 batch of shape (3, *batch) and an Fq12 an Fq6 batch
of shape (2, *batch).  ``x[:, i]`` is component i of an Fq2, ``x[:, :, i]`` of
an Fq6, ``x[:, :, :, i]`` of an Fq12.

The formulas are the JAX package's (``zerochain_tpu/ec/tower.py``, after the
reference's core/pairing/src/bls12_381/fq6.rs, fq12.rs), value for value.
What differs is how they reach the field kernels: the field ops are
elementwise, so the independent products of one tower operation are stacked
onto one launch (an Fq6 product is one Fq2 product over six pairs, itself one
Fq multiply over eighteen), and an add, sub or negation of whole elements is
one ``FqOps`` call on their tensors.  The base ops are ``ec/fields.py: FqOps`` (the K1 kernels on CUDA
tensors, their plain versions on CPU tensors); an inversion is one
``cuda_ff.inv`` launch.
"""

from __future__ import annotations

import torch

from ..ff import limbs as L
from ..mirror import field as mf
from .fields import FqOps as F

FQ = L.FQ

_I1 = (1, 0, 0)  # the Karatsuba sums of an Fq6 product: (1+2, 0+1, 0+2)
_I2 = (2, 1, 2)
_IDX: dict = {}


def _take(x, dim: int, idx: tuple):
    """x.index_select(dim, idx) with the index tensor built once a device
    (a list index would copy it to the device on every call)."""
    key = (idx, str(x.device))
    t = _IDX.get(key)
    if t is None:
        t = _IDX[key] = torch.tensor(idx, device=x.device)
    return x.index_select(dim, t)


def bcast(*xs):
    return torch.broadcast_tensors(*xs) if len({x.shape for x in xs}) > 1 else xs


# ------------------------------------------------------------------ fq2
def fq2_dbl(a):
    return F.add(a, a)


def fq2_conj(a):
    return torch.stack([a[:, 0], F.neg(a[:, 1])], 1)


def fq2_mul(a, b):
    """Karatsuba (fq2.rs mul_assign): the three products in one launch."""
    a, b = bcast(a, b)
    s = F.add(torch.stack([a[:, 0], b[:, 0]], 1), torch.stack([a[:, 1], b[:, 1]], 1))
    m = F.mul(torch.cat([a, s[:, :1]], 1), torch.cat([b, s[:, 1:]], 1))
    t = F.add(m[:, 0], m[:, 1])                       # aa + bb
    return F.sub(m[:, 0::2], torch.stack([m[:, 1], t], 1))


def fq2_sqr(a):
    """(a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u."""
    s = F.add(a[:, 0], a[:, 1])
    d = F.sub(a[:, 0], a[:, 1])
    m = F.mul(torch.stack([a[:, 0], s], 1), torch.stack([a[:, 1], d], 1))
    return torch.stack([m[:, 1], F.add(m[:, 0], m[:, 0])], 1)


def fq2_mul_small(a, k: int):
    """k a for a small k >= 1, by doublings and additions."""
    out = a
    for bit in bin(k)[3:]:  # MSB first, the leading one is a itself
        out = fq2_dbl(out)
        if bit == "1":
            out = F.add(out, a)
    return out


def fq2_mul_by_nonresidue(a):
    """xi = 1 + u:  (c0 - c1) + (c0 + c1) u."""
    return torch.stack([F.sub(a[:, 0], a[:, 1]), F.add(a[:, 0], a[:, 1])], 1)


def fq2_inv(a):
    """(c0 - c1 u) / (c0^2 + c1^2): one inversion launch."""
    q = F.mul(a, a)
    norm = F.add(q[:, 0], q[:, 1])
    t = L.batch_inv_mont(FQ, norm.reshape(FQ.n, -1), axis=1).reshape(norm.shape)
    m = F.mul(a, t.unsqueeze(1))
    return torch.stack([m[:, 0], F.neg(m[:, 1])], 1)


def fq2_frobenius(a, power: int):
    return fq2_conj(a) if power % 2 else a


# ------------------------------------------------------------------ fq6
def _c6(a, i):
    return a[:, :, i]


def fq6_mul_by_nonresidue(a):
    """v (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2."""
    return torch.stack([fq2_mul_by_nonresidue(_c6(a, 2)), _c6(a, 0), _c6(a, 1)], 2)


def fq6_mul(a, b):
    """fq6.rs mul_assign: its six Fq2 products in one ``fq2_mul``."""
    a, b = bcast(a, b)
    ab = torch.stack([a, b], 2)                        # (12, 2, 2, 3, *batch)
    s = F.add(_take(ab, 3, _I1), _take(ab, 3, _I2))    # a1+a2, a0+a1, a0+a2; b's
    v = fq2_mul(torch.cat([a, s[:, :, 0]], 2), torch.cat([b, s[:, :, 1]], 2))
    t = F.add(_take(v, 2, _I1), _take(v, 2, _I2))      # v1+v2, v0+v1, v0+v2
    u = F.sub(v[:, :, 3:], t)
    n = fq2_mul_by_nonresidue(torch.stack([_c6(u, 0), _c6(v, 2)], 2))
    return F.add(torch.stack([_c6(n, 0), _c6(u, 1), _c6(u, 2)], 2),
                 torch.stack([_c6(v, 0), _c6(n, 1), _c6(v, 1)], 2))


def fq6_inv(a):
    a0, a1, a2 = _c6(a, 0), _c6(a, 1), _c6(a, 2)
    p = fq2_mul(torch.stack([a0, a1, a2, a0, a1, a0], 2),
                torch.stack([a0, a2, a2, a1, a1, a2], 2))
    # a0^2, a1 a2, a2^2, a0 a1, a1^2, a0 a2
    n = fq2_mul_by_nonresidue(p[:, :, 1:3])            # xi a1 a2, xi a2^2
    c = F.sub(torch.stack([_c6(p, 0), _c6(n, 1), _c6(p, 4)], 2),
              torch.stack([_c6(n, 0), _c6(p, 3), _c6(p, 5)], 2))
    q = fq2_mul(torch.stack([a2, a1, a0], 2), _take(c, 2, (1, 2, 0)))
    d = F.add(fq2_mul_by_nonresidue(F.add(_c6(q, 0), _c6(q, 1))), _c6(q, 2))
    t = fq2_inv(d)
    return fq2_mul(t.unsqueeze(2), c)


# ----------------------------------------------------------------- fq12
def _c12(a, i):
    return a[:, :, :, i]


def fq12_one(batch=(), device=None):
    out = torch.zeros((FQ.n, 2, 3, 2, *batch), dtype=torch.int32, device=device)
    out[:, 0, 0, 0] = FQ.const(FQ.r_mod_p, out[:, 0, 0, 0])
    return out


def fq12_conj(a):
    return torch.stack([_c12(a, 0), F.neg(_c12(a, 1))], 3)


def fq12_mul(a, b):
    """fq12.rs mul_assign: its three Fq6 products in one ``fq6_mul``."""
    a, b = bcast(a, b)
    s = F.add(torch.stack([_c12(a, 0), _c12(b, 0)], 3),
              torch.stack([_c12(a, 1), _c12(b, 1)], 3))
    v = fq6_mul(torch.cat([a, s[:, :, :, :1]], 3), torch.cat([b, s[:, :, :, 1:]], 3))
    aa, bb, o = _c12(v, 0), _c12(v, 1), _c12(v, 2)
    w = F.add(torch.stack([aa, fq6_mul_by_nonresidue(bb)], 3),
              torch.stack([bb, aa], 3))                 # aa + bb, xi bb + aa
    return torch.stack([_c12(w, 1), F.sub(o, _c12(w, 0))], 3)


def fq12_sqr(a):
    """fq12.rs square: its two Fq6 products in one ``fq6_mul``."""
    a0, a1 = _c12(a, 0), _c12(a, 1)
    s = F.add(torch.stack([fq6_mul_by_nonresidue(a1), a0], 3),
              torch.stack([a0, a1], 3))
    v = fq6_mul(torch.stack([a0, _c12(s, 0)], 3), torch.stack([a1, _c12(s, 1)], 3))
    ab = _c12(v, 0)
    w = F.add(torch.stack([ab, ab], 3), torch.stack([ab, fq6_mul_by_nonresidue(ab)], 3))
    return torch.stack([F.sub(_c12(v, 1), _c12(w, 1)), _c12(w, 0)], 3)


def fq12_inv(a):
    sq = fq6_mul(a, a)                                 # a0^2, a1^2
    t = fq6_inv(F.sub(_c12(sq, 0), fq6_mul_by_nonresidue(_c12(sq, 1))))
    m = fq6_mul(a, t.unsqueeze(3))
    return torch.stack([_c12(m, 0), F.neg(_c12(m, 1))], 3)


def fq12_mul_by_014(a, c0, c1, c4):
    """Multiplication by the Miller line b = (c0, c1, 0; 0, c4, 0)."""
    c0, c1, c4 = bcast(c0, c1, c4)
    z = torch.zeros_like(c0)
    b = torch.stack([torch.stack([c0, c1, z], 2), torch.stack([z, c4, z], 2)], 3)
    return fq12_mul(a, b)


# ------------------------------------------------------------- frobenius
_FROB: dict = {}


def _frob_tables(device):
    """The Frobenius coefficients as Montgomery Fq2 columns, built once a
    device: (12, 2, 6) for v and v^2, (12, 2, 12) for w."""
    key = str(device)
    got = _FROB.get(key)
    if got is None:
        got = tuple(fq2_from_ints(c, device) for c in (
            mf.FROBENIUS_COEFF_FQ6_C1, mf.FROBENIUS_COEFF_FQ6_C2,
            mf.FROBENIUS_COEFF_FQ12_C1))
        _FROB[key] = got
    return got


def _col(c, like, lead: int):
    """A (12, 2, k) constant column, broadcast against ``like``'s batch after
    its first ``lead`` axes."""
    return c.reshape(c.shape + (1,) * (like.dim() - lead))


def fq6_frobenius(a, power: int):
    p = power % 6
    c1, c2, _ = _frob_tables(a.device)
    a = fq2_frobenius(a, p)  # conjugates all three components at once
    coef = torch.stack([c1[:, :, p], c2[:, :, p]], 2)  # (12, 2, 2)
    m = fq2_mul(a[:, :, 1:], _col(coef, a, 3))
    return torch.cat([a[:, :, :1], m], 2)


def fq12_frobenius(a, power: int):
    p = power % 12
    _, _, c12 = _frob_tables(a.device)
    f = fq6_frobenius(a, p)                            # both halves at once
    m = fq2_mul(_c12(f, 1), _col(c12[:, :, p:p + 1], _c12(f, 1), 3))
    return torch.stack([_c12(f, 0), m], 3)


# ------------------------------------------------------------- host glue
def fq2_from_ints(vals, device=None):
    """[(c0, c1), ...] -> (12, 2, len) Montgomery words."""
    flat = [v[c] for c in range(2) for v in vals]
    return FQ.array(flat, device, mont=True).reshape(FQ.n, 2, len(vals))


def fq2_to_ints(a):
    """(12, 2, *batch) -> [(c0, c1), ...] over the flattened batch."""
    c0, c1 = (FQ.to_ints(a[:, i].reshape(FQ.n, -1), mont=True) for i in range(2))
    return list(zip(c0, c1))


def fq12_from_ints(vals, device=None):
    """Nested int tuples ((3 x fq2), (3 x fq2)), one a batch entry ->
    (12, 2, 3, 2, len(vals)) Montgomery words."""
    flat = [v[h][i][c] for c in range(2) for i in range(3) for h in range(2)
            for v in vals]
    return FQ.array(flat, device, mont=True).reshape(FQ.n, 2, 3, 2, len(vals))


def fq12_to_ints(a):
    """(12, 2, 3, 2, *batch) -> nested int tuples, one a batch entry (the
    batch flattened)."""
    ints = FQ.to_ints(a.reshape(FQ.n, -1), mont=True)
    nb = len(ints) // 12
    at = lambda c, i, h, b: ints[((c * 3 + i) * 2 + h) * nb + b]  # noqa: E731
    return [tuple(tuple((at(0, i, h, b), at(1, i, h, b)) for i in range(3))
                  for h in range(2)) for b in range(nb)]
