"""Batched short-Weierstrass group law in Jacobian coordinates (y^2 = x^3 + b).

Branch-free on the tensor side: the degenerate cases of the reference's
Jacobian add/double (core/pairing/src/bls12_381/ec.rs:300-530: infinity,
P == Q, P == -Q) are handled over the whole batch.  Points: (X, Y, Z) field
elements; infinity <=> Z == 0.  Generic over the field adapter
(ec/fields.py), instantiated for G1 and G2.  ``add`` and ``double`` are the
kernels of ec/cuda_ec.py, and so is the double-and-add ladder; the rest is
composed of them and of field ops.
"""

from __future__ import annotations

from . import cuda_ec


def identity(F, batch=(), device=None):
    return (F.ones(batch, device), F.ones(batch, device), F.zeros(batch, device))


def is_identity(F, p):
    return F.is_zero(p[2])


def neg(F, p):
    return (p[0], F.neg(p[1]), p[2])


def double(F, p):
    return cuda_ec.double(F, p)


def add(F, p, q):
    return cuda_ec.add(F, p, q)


def add_mixed(F, p, q_affine, q_inf=None):
    """p (Jacobian) + q (affine, Z=1); q_inf optionally marks infinities in q."""
    X1, Y1, Z1 = p
    X2, Y2 = q_affine
    batch = F.batch_shape(X1)
    dev = F.device(X1)
    z1z1 = F.sqr(Z1)
    u2 = F.mul(X2, z1z1)
    s2 = F.mul(F.mul(Y2, Z1), z1z1)
    h = F.sub(u2, X1)
    r = F.sub(s2, Y1)

    hh = F.sqr(h)
    i = F.add(F.add(hh, hh), F.add(hh, hh))
    j = F.mul(h, i)
    r2 = F.add(r, r)
    v = F.mul(X1, i)
    x3 = F.sub(F.sub(F.sqr(r2), j), F.add(v, v))
    y1j = F.mul(Y1, j)
    y3 = F.sub(F.mul(r2, F.sub(v, x3)), F.add(y1j, y1j))
    z3 = F.sub(F.sqr(F.add(Z1, h)), F.add(z1z1, hh))

    p_inf = is_identity(F, p)
    x_eq = F.is_zero(h)
    y_eq = F.is_zero(r)

    dbl = double(F, p)
    inf = identity(F, batch, dev)
    q_jac = (X2, Y2, F.ones(batch, dev))

    res = (x3, y3, z3)
    res = tuple(F.select(x_eq & y_eq & ~p_inf, d, r_)
                for d, r_ in zip(dbl, res))
    res = tuple(F.select(x_eq & ~y_eq & ~p_inf, i_, r_)
                for i_, r_ in zip(inf, res))
    res = tuple(F.select(p_inf, b, r_) for b, r_ in zip(q_jac, res))
    if q_inf is not None:
        res = tuple(F.select(q_inf, a, r_) for a, r_ in zip(p, res))
    return res


def select(F, cond, p, q):
    return tuple(F.select(cond, a, b) for a, b in zip(p, q))


def normalize(F, p):
    """Jacobian -> affine via batched inversion; infinity -> (0, 0).

    Returns (x, y, inf_mask)."""
    X, Y, Z = p
    batch = F.batch_shape(X)
    dev = F.device(X)
    inf = is_identity(F, p)
    # replace Z=0 by 1 to keep the batch inverse well-defined
    zsafe = F.select(inf, F.ones(batch, dev), Z)
    flat = F.map(lambda a: a.reshape(a.shape[0], -1), zsafe)
    zinv = F.map(lambda a: a.reshape(12, *batch), F.batch_inv_flat(flat))
    zinv2 = F.sqr(zinv)
    zinv3 = F.mul(zinv2, zinv)
    x = F.mul(X, zinv2)
    y = F.mul(Y, zinv3)
    x = F.select(inf, F.zeros(batch, dev), x)
    y = F.select(inf, F.zeros(batch, dev), y)
    return x, y, inf


def scalar_mul_bits_jac(F, base_jac, bits):
    """Batched double-and-add from a Jacobian base point batch over LE bit
    tensors (n_bits, *batch): one launch of the ladder kernel
    (``cuda_ec.ladder``)."""
    return cuda_ec.ladder(F, base_jac, bits)


def scalar_mul_bits(F, base_affine, bits, base_inf=None):
    """Batched double-and-add over LE bit tensors (n_bits, *batch)."""
    batch = F.batch_shape(base_affine[0])
    dev = F.device(base_affine[0])
    cur0 = (base_affine[0], base_affine[1], F.ones(batch, dev))
    if base_inf is not None:
        cur0 = select(F, base_inf, identity(F, batch, dev), cur0)
    return scalar_mul_bits_jac(F, cur0, bits)
