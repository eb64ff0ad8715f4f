"""Batched Jubjub (twisted Edwards, a = -1) over Fr word tensors.

Extended coordinates (X:Y:Z:T), unified add/double formulas (complete for
a=-1, d non-square: "Twisted Edwards Curves Revisited" §3.1), so scalar-mul
chains run inversion-free; affine values are recovered with ONE batched
Montgomery inversion at the end (the batched version of the reference's
batch_normalization, core/pairing/src/bls12_381/ec.rs:246).

Replaces the reference's per-scalar double-and-add (core/jubjub/src/curve/
edwards.rs:520-574) with bit-sliced batched chains.  Composed of the field
kernels of ff/cuda_ff.py (``KERNEL_OPS``), or of their plain versions
(``PLAIN_OPS``) where ``add`` and ``double`` are the plain versions of the
chain kernels of ec/cuda_jubjub.py, which run the same formulas on the card.
"""

from __future__ import annotations

from functools import partial
from types import SimpleNamespace

import torch

from ..ff import cuda_ff
from ..ff import limbs as L
from ..mirror import jubjub as mjj
from ..mirror.field import R

FR = L.FR

# Montgomery-domain curve constants
_D_MONT = mjj.EDWARDS_D * FR.r_mod_p % R
_D2_MONT = 2 * mjj.EDWARDS_D * FR.r_mod_p % R

mul = partial(L.mont_mul, FR)
sub = partial(L.sub, FR)
addf = partial(L.add, FR)


def _plain(op):
    def f(a, b):
        return op(FR, *torch.broadcast_tensors(a, b))
    return f


# the Fr ops of the group law: the field kernels' wrappers, or their plain
# versions whatever the device
KERNEL_OPS = SimpleNamespace(mul=mul, sub=sub, add=addf)
PLAIN_OPS = SimpleNamespace(mul=_plain(cuda_ff.mont_mul_plain),
                            sub=_plain(cuda_ff.sub_plain),
                            add=_plain(cuda_ff.add_plain))


# ---------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------
def to_extended(points, batch_shape=None, device=None):
    """Affine int pairs [(x, y), ...] -> extended word tensors (Montgomery).

    Returns (X, Y, Z, T) with Z = 1."""
    X = FR.array([p[0] for p in points], device, mont=True)
    Y = FR.array([p[1] for p in points], device, mont=True)
    Z = FR.array([1] * len(points), device, mont=True)
    T = FR.array([p[0] * p[1] % R for p in points], device, mont=True)
    if batch_shape is not None:
        X, Y, Z, T = (a.reshape((FR.n, *batch_shape)) for a in (X, Y, Z, T))
    return (X, Y, Z, T)


def to_affine_host(pt):
    """Extended point(s) -> list of affine int pairs (via host)."""
    x, y = normalize(pt)
    return list(zip(FR.to_ints(x, mont=True), FR.to_ints(y, mont=True)))


def ext_from_affine(x, y, ops=KERNEL_OPS):
    """Affine (x, y) word tensors -> (x : y : 1 : xy)."""
    one = L.ones_mont(FR, x.shape[1:], x.device)
    return (x, y, one, ops.mul(x, y))


def identity(batch=(), device=None):
    """(0 : 1 : 1 : 0)"""
    zero = L.zeros(FR, batch, device)
    one = L.ones_mont(FR, batch, device)
    return (zero, one, one.clone(), zero.clone())


# ---------------------------------------------------------------------
# group law (unified, batched)
# ---------------------------------------------------------------------
def add(p, q, ops=KERNEL_OPS):
    """Unified extended addition, 9M (complete for a=-1)."""
    mul, sub, addf = ops.mul, ops.sub, ops.add
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a = mul(sub(Y1, X1), sub(Y2, X2))
    b = mul(addf(Y1, X1), addf(Y2, X2))
    c = mul(mul(T1, FR.const(_D2_MONT, T1)), T2)
    zz = mul(Z1, Z2)
    d = addf(zz, zz)
    e = sub(b, a)
    f = sub(d, c)
    g = addf(d, c)
    h = addf(b, a)
    return (mul(e, f), mul(g, h), mul(f, g), mul(e, h))


def double(p, ops=KERNEL_OPS):
    """Unified extended doubling, 4M + 4S."""
    mul, sub, addf = ops.mul, ops.sub, ops.add
    X1, Y1, Z1, _ = p
    a = mul(X1, X1)
    b = mul(Y1, Y1)
    zz = mul(Z1, Z1)
    c = addf(zz, zz)
    xy = addf(X1, Y1)
    e = sub(sub(mul(xy, xy), a), b)
    g = sub(b, a)  # a*A + B with a = -1
    f = sub(g, c)
    ab = addf(a, b)
    h = sub(torch.zeros_like(ab), ab)  # L.neg
    return (mul(e, f), mul(g, h), mul(f, g), mul(e, h))


def select(cond, p, q):
    """cond (bool tensor over batch) ? p : q, componentwise."""
    return tuple(L.select(cond, a, b) for a, b in zip(p, q))


def neg(p):
    X, Y, Z, T = p
    return (L.neg(FR, X), Y, Z, L.neg(FR, T))


def normalize(pt):
    """Extended -> affine (x, y) Montgomery word tensors (batched inverse)."""
    X, Y, Z, T = pt
    flat = Z.reshape(FR.n, -1)
    zinv = L.batch_inv_mont(FR, flat, axis=1).reshape(Z.shape)
    return (mul(X, zinv), mul(Y, zinv))


def normalize_many(points):
    """Normalise a list of extended point batches of one shape with ONE
    inversion (one ``cuda_ff.inv`` launch over all their Z), then two
    multiplies each -> [(x, y), ...] Montgomery word tensors."""
    zs = torch.stack([p[2].reshape(FR.n, -1) for p in points], dim=1)
    zinv = L.batch_inv_mont(FR, zs.reshape(FR.n, -1), axis=1).reshape(zs.shape)
    out = []
    for i, (X, Y, Z, _) in enumerate(points):
        zi = zinv[:, i].reshape(Z.shape)
        out.append((mul(X, zi), mul(Y, zi)))
    return out


# ---------------------------------------------------------------------
# scalar multiplication
# ---------------------------------------------------------------------
def scalar_mul_bits(base, bits):
    """Double-and-add: base is an extended point batch, bits is an
    (n_bits, *batch) tensor of LE bits.  Matches edwards.rs mul semantics
    (LSB-first accumulate, base doubles each step)."""
    acc = identity(base[0].shape[1:], base[0].device)
    cur = base
    n_bits = bits.shape[0]
    for k in range(n_bits):
        cand = add(acc, cur)
        acc = select(bits[k].to(torch.bool), cand, acc)
        if k + 1 < n_bits:
            cur = double(cur)
    return acc


def is_identity(pt):
    """Check X == 0 and Y == Z (projective identity test)."""
    X, Y, Z, _ = pt
    return L.is_zero(X) & L.eq(Y, Z)
