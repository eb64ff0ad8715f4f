"""BLS12-381 G1 batched group ops (Fq word tensors, Jacobian).

Host conversion helpers bridge the mirror's affine int points."""

from __future__ import annotations

from . import weierstrass as W
from .fields import FqOps

F = FqOps


def from_affine_host(points, batch_shape=None, device=None):
    """[affine point | None, ...] -> (X, Y, Z) Jacobian (None -> infinity)."""
    xs, ys, zs = [], [], []
    for p in points:
        if p is None:
            xs.append(0)
            ys.append(0)
            zs.append(0)
        else:
            xs.append(p[0])
            ys.append(p[1])
            zs.append(1)
    return (
        F.from_ints(xs, batch_shape, device),
        F.from_ints(ys, batch_shape, device),
        F.from_ints(zs, batch_shape, device),
    )


def to_affine_host(p):
    x, y, inf = W.normalize(F, p)
    xs = F.to_ints(x)
    ys = F.to_ints(y)
    infs = inf.reshape(-1).tolist()
    return [None if i else (xv, yv) for xv, yv, i in zip(xs, ys, infs)]


def identity(batch=(), device=None):
    return W.identity(F, batch, device)


def add(p, q):
    return W.add(F, p, q)


def add_mixed(p, q_affine, q_inf=None):
    return W.add_mixed(F, p, q_affine, q_inf)


def double(p):
    return W.double(F, p)


def neg(p):
    return W.neg(F, p)


def select(cond, p, q):
    return W.select(F, cond, p, q)


def normalize(p):
    return W.normalize(F, p)


def scalar_mul_bits(base_affine, bits, base_inf=None):
    return W.scalar_mul_bits(F, base_affine, bits, base_inf)
