"""Field adapters: one op interface over Fq word tensors and Fq2 pairs.

Lets the Weierstrass group law (ec/weierstrass.py, ec/cuda_ec.py) be written
once and instantiated for G1 (base field Fq) and G2 (extension Fq2),
mirroring the reference's `curve_impl!` macro genericity
(core/pairing/src/bls12_381/ec.rs:1) in tensor form.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..ff import cuda_ff
from ..ff import limbs as L

FQ = L.FQ


class FqOps:
    """Elements: (12, *batch) int32 word tensors, Montgomery domain."""

    name = "fq"
    ncomp = 1
    _impl = cuda_ff  # the four base ops: kernels on CUDA tensors

    @classmethod
    def add(cls, a, b):
        return cls._impl.add(FQ, a, b)

    @classmethod
    def sub(cls, a, b):
        return cls._impl.sub(FQ, a, b)

    @classmethod
    def neg(cls, a):
        return cls._impl.sub(FQ, L.zeros(FQ, a.shape[1:], a.device), a)

    @classmethod
    def mul(cls, a, b):
        return cls._impl.mont_mul(FQ, a, b)

    @classmethod
    def sqr(cls, a):
        return cls._impl.mont_sqr(FQ, a)

    @staticmethod
    def is_zero(a):
        return L.is_zero(a)

    @staticmethod
    def select(cond, a, b):
        return L.select(cond, a, b)

    @staticmethod
    def zeros(batch=(), device=None):
        return L.zeros(FQ, batch, device)

    @staticmethod
    def ones(batch=(), device=None):
        return L.ones_mont(FQ, batch, device)

    @staticmethod
    def batch_inv_flat(a):
        """Inverse along a flattened batch axis (axis=1 of (n, B))."""
        return L.batch_inv_mont(FQ, a, axis=1)

    @staticmethod
    def from_ints(vals, batch_shape=None, device=None):
        arr = FQ.array(vals, device, mont=True)
        if batch_shape is not None:
            arr = arr.reshape((FQ.n, *batch_shape))
        return arr

    @staticmethod
    def to_ints(arr):
        return FQ.to_ints(arr, mont=True)

    @staticmethod
    def batch_shape(a):
        return tuple(a.shape[1:])

    @staticmethod
    def device(a):
        return a.device

    @staticmethod
    def leaves(a):
        return (a,)

    @staticmethod
    def map(fn, *elems):
        """Apply fn to the word tensors of one or more elements."""
        return fn(*elems)


class Fq2Ops:
    """Elements: (c0, c1) tuples of Fq word tensors; u^2 = -1."""

    name = "fq2"
    ncomp = 2
    base = FqOps

    @classmethod
    def add(cls, a, b):
        return (cls.base.add(a[0], b[0]), cls.base.add(a[1], b[1]))

    @classmethod
    def sub(cls, a, b):
        return (cls.base.sub(a[0], b[0]), cls.base.sub(a[1], b[1]))

    @classmethod
    def neg(cls, a):
        return (cls.base.neg(a[0]), cls.base.neg(a[1]))

    @classmethod
    def mul(cls, a, b):
        # Karatsuba (fq2.rs mul_assign)
        aa = cls.base.mul(a[0], b[0])
        bb = cls.base.mul(a[1], b[1])
        o = cls.base.mul(cls.base.add(a[0], a[1]), cls.base.add(b[0], b[1]))
        return (cls.base.sub(aa, bb), cls.base.sub(o, cls.base.add(aa, bb)))

    @classmethod
    def sqr(cls, a):
        ab = cls.base.mul(a[0], a[1])
        c0 = cls.base.mul(cls.base.add(a[0], a[1]), cls.base.sub(a[0], a[1]))
        return (c0, cls.base.add(ab, ab))

    @classmethod
    def is_zero(cls, a):
        return cls.base.is_zero(a[0]) & cls.base.is_zero(a[1])

    @classmethod
    def select(cls, cond, a, b):
        return (cls.base.select(cond, a[0], b[0]), cls.base.select(cond, a[1], b[1]))

    @classmethod
    def zeros(cls, batch=(), device=None):
        return (cls.base.zeros(batch, device), cls.base.zeros(batch, device))

    @classmethod
    def ones(cls, batch=(), device=None):
        return (cls.base.ones(batch, device), cls.base.zeros(batch, device))

    @classmethod
    def batch_inv_flat(cls, a):
        # 1/(c0 + c1 u) = (c0 - c1 u) / (c0^2 + c1^2)
        norm = cls.base.add(cls.base.sqr(a[0]), cls.base.sqr(a[1]))
        t = cls.base.batch_inv_flat(norm)
        return (cls.base.mul(a[0], t), cls.base.neg(cls.base.mul(a[1], t)))

    @classmethod
    def from_ints(cls, vals, batch_shape=None, device=None):
        return (
            cls.base.from_ints([v[0] for v in vals], batch_shape, device),
            cls.base.from_ints([v[1] for v in vals], batch_shape, device),
        )

    @classmethod
    def to_ints(cls, arr):
        return list(zip(cls.base.to_ints(arr[0]), cls.base.to_ints(arr[1])))

    @classmethod
    def batch_shape(cls, a):
        return tuple(a[0].shape[1:])

    @classmethod
    def device(cls, a):
        return a[0].device

    @classmethod
    def leaves(cls, a):
        return (a[0], a[1])

    @classmethod
    def map(cls, fn, *elems):
        return (fn(*(e[0] for e in elems)), fn(*(e[1] for e in elems)))


class FqOpsPlain(FqOps):
    """FqOps on the plain PyTorch field ops, whatever the device: what the
    plain versions of the curve kernels are composed of."""

    _impl = SimpleNamespace(
        add=cuda_ff.add_plain, sub=cuda_ff.sub_plain,
        mont_mul=cuda_ff.mont_mul_plain, mont_sqr=cuda_ff.mont_sqr_plain,
    )


class Fq2OpsPlain(Fq2Ops):
    """Fq2Ops on the plain field ops.  The component operations of one Fq2
    operation ride one call, stacked on a new batch axis: the same canonical
    results from a third of the tensor ops."""

    base = FqOpsPlain

    @classmethod
    def _pair(cls, fn, a, b):
        r = fn(torch.stack(a, dim=1), torch.stack(b, dim=1))
        return (r[:, 0], r[:, 1])

    @classmethod
    def add(cls, a, b):
        return cls._pair(cls.base.add, a, b)

    @classmethod
    def sub(cls, a, b):
        return cls._pair(cls.base.sub, a, b)

    @classmethod
    def mul(cls, a, b):
        # Karatsuba, the three products in one call
        sa, sb = cls._pair(cls.base.add, (a[0], b[0]), (a[1], b[1]))
        m = cls.base.mul(torch.stack([a[0], a[1], sa], dim=1),
                         torch.stack([b[0], b[1], sb], dim=1))
        aa, bb, o = m[:, 0], m[:, 1], m[:, 2]
        return cls._pair(cls.base.sub, (aa, o), (bb, cls.base.add(aa, bb)))

    @classmethod
    def sqr(cls, a):
        s = cls.base.add(a[0], a[1])
        d = cls.base.sub(a[0], a[1])
        m = cls.base.mul(torch.stack([a[0], s], dim=1),
                         torch.stack([a[1], d], dim=1))
        ab = m[:, 0]
        return (m[:, 1], cls.base.add(ab, ab))


FqOps.plain = FqOpsPlain
Fq2Ops.plain = Fq2OpsPlain
FqOpsPlain.plain = FqOpsPlain
Fq2OpsPlain.plain = Fq2OpsPlain
