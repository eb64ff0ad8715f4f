"""Jacobian point add and double kernels for G1 and G2.

``add`` and ``double`` are wrappers around the kernels of
``csrc/ec_kernels.cu`` (the counterpart of the fused group-law kernels of
``zerochain_tpu/ec/pallas_ec.py``); ``add_plain`` and ``double_plain`` are
the plain PyTorch versions of the same functions, composed of field ops.  A
wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.

Both sides evaluate the same formulas (dbl-2009-l; add-2007-bl with the
cases P = inf, Q = inf, P = Q, P = -Q) on canonical field elements, so the
kernel and the plain version return identical words (tolerance 0).

Points: (X, Y, Z), each coordinate a field element of ``F`` (``FqOps``: one
``(12, *batch)`` int32 tensor; ``Fq2Ops``: a pair of them); infinity <=>
Z == 0.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

launches = {"g1_add": 0, "g1_double": 0, "g2_add": 0, "g2_double": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------
def double_plain(F, p):
    """dbl-2009-l; infinity propagates (Z3 = 2YZ = 0)."""
    F = F.plain
    X, Y, Z = p
    a = F.sqr(X)
    b = F.sqr(Y)
    c = F.sqr(b)
    t = F.sqr(F.add(X, b))
    d1 = F.sub(F.sub(t, a), c)
    d = F.add(d1, d1)
    e = F.add(F.add(a, a), a)
    f = F.sqr(e)
    x3 = F.sub(f, F.add(d, d))
    c2 = F.add(c, c)
    c4 = F.add(c2, c2)
    c8 = F.add(c4, c4)
    y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
    yz = F.mul(Y, Z)
    z3 = F.add(yz, yz)
    return (x3, y3, z3)


def add_plain(F, p, q):
    """Complete-by-masking Jacobian addition (add-2007-bl + cases)."""
    F = F.plain
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    z1z1 = F.sqr(Z1)
    z2z2 = F.sqr(Z2)
    u1 = F.mul(X1, z2z2)
    u2 = F.mul(X2, z1z1)
    s1 = F.mul(F.mul(Y1, Z2), z2z2)
    s2 = F.mul(F.mul(Y2, Z1), z1z1)
    h = F.sub(u2, u1)
    r = F.sub(s2, s1)

    i = F.sqr(F.add(h, h))
    j = F.mul(h, i)
    r2 = F.add(r, r)
    v = F.mul(u1, i)
    x3 = F.sub(F.sub(F.sqr(r2), j), F.add(v, v))
    s1j = F.mul(s1, j)
    y3 = F.sub(F.mul(r2, F.sub(v, x3)), F.add(s1j, s1j))
    z3 = F.mul(F.sub(F.sqr(F.add(Z1, Z2)), F.add(z1z1, z2z2)), h)

    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    x_eq = F.is_zero(h)
    y_eq = F.is_zero(r)

    batch = F.batch_shape(X1)
    dev = F.device(X1)
    inf = (F.ones(batch, dev), F.ones(batch, dev), F.zeros(batch, dev))

    res = (x3, y3, z3)
    # same point -> double (the doubling is computed only if some lane asks)
    same = x_eq & y_eq
    if bool(same.any()):
        dbl = double_plain(F, p)
        res = tuple(F.select(same, d, r_) for d, r_ in zip(dbl, res))
    # same x, different y (neither infinite) -> infinity
    to_inf = x_eq & ~y_eq & ~(p_inf | q_inf)
    res = tuple(F.select(to_inf, i_, r_) for i_, r_ in zip(inf, res))
    res = tuple(F.select(q_inf, a, r_) for a, r_ in zip(p, res))
    res = tuple(F.select(p_inf, b, r_) for b, r_ in zip(q, res))
    return res


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------
def _fn():
    lib = _build.lib("ec_kernels")
    fn = lib.zc_ec_op
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def _planes(F, pt):
    """The coordinate word tensors of a point, in kernel order."""
    out = []
    for coord in pt:
        out.extend(F.leaves(coord))
    return out


def _prepare(planes):
    ref = planes[0]
    for t in planes:
        if t.dtype != torch.int32:
            raise TypeError(f"point coordinates are int32 words, got {t.dtype}")
        if t.dim() < 1 or t.shape[0] != 12:
            raise ValueError(f"coordinate shape {tuple(t.shape)}: expected 12 leading words")
        if t.device != ref.device:
            raise ValueError("point coordinates on different devices")
    if any(t.shape != ref.shape for t in planes):
        planes = list(torch.broadcast_tensors(*planes))
    return [t.contiguous() for t in planes]


def _launch(F, op: str, p, q=None):
    np_ = 3 * F.ncomp
    planes = _planes(F, p) + (_planes(F, q) if q is not None else [])
    planes = _prepare(planes)
    ref = planes[0]
    outs = [torch.empty_like(ref) for _ in range(np_)]
    count = ref.numel() // 12
    if count:
        ins = planes if q is not None else planes + planes
        ptrs = (ctypes.c_void_p * (3 * np_))(
            *[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs])
        with torch.cuda.device(ref.device):
            rc = _fn()(int(F.ncomp == 2), 0 if op == "add" else 1, ptrs, count,
                       torch.cuda.current_stream().cuda_stream)
        launches[("g1_" if F.ncomp == 1 else "g2_") + op] += 1
        if rc != 0:
            raise RuntimeError(f"ec kernel {op}/{F.name}: CUDA error {rc}")
    if F.ncomp == 1:
        return tuple(outs)
    return tuple((outs[2 * k], outs[2 * k + 1]) for k in range(3))


def _device_type(F, p):
    return F.device(p[0]).type


def add(F, p, q):
    """p + q on Jacobian point batches."""
    kind = _device_type(F, p)
    if kind == "cpu":
        return add_plain(F, p, q)
    if kind != "cuda":
        raise ValueError(f"unsupported device {F.device(p[0])}")
    return _launch(F, "add", p, q)


def double(F, p):
    """2p on a Jacobian point batch."""
    kind = _device_type(F, p)
    if kind == "cpu":
        return double_plain(F, p)
    if kind != "cuda":
        raise ValueError(f"unsupported device {F.device(p[0])}")
    return _launch(F, "double", p)
