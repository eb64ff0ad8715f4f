"""BLS12-381 optimal-ate pairing (the oracle).

Mirrors core/pairing/src/bls12_381/mod.rs:24-359: G2 preparation via the
doubling/addition steps of eprint 2010/354 (algorithms 26/27), a multi-pair
Miller loop over the bits of |BLS_X|, and the standard BLS final
exponentiation (easy part + hard part addition chain).  Verified against the
reference's RELIC golden vector (tests/mod.rs:4-60) in the test suite.
"""

from __future__ import annotations

from .field import (
    BLS_X,
    FQ2_ZERO,
    FQ12_ONE,
    fq2_add,
    fq2_mul,
    fq2_mul_scalar,
    fq2_neg,
    fq2_sqr,
    fq2_sub,
    fq12_conj,
    fq12_frobenius,
    fq12_inv,
    fq12_mul,
    fq12_mul_by_014,
    fq12_pow,
    fq12_sqr,
)


def _dbl(x2):
    return fq2_add(x2, x2)


def g2_prepare(q):
    """Line coefficients for the Miller loop (mod.rs:168-359).

    ``q`` is an affine G2 point ((x, y) of Fq2) or None; returns a list of
    (c0, c1, c2) Fq2 triples.
    """
    if q is None:
        return None  # infinity — skipped by the loop

    qx, qy = q
    rx, ry, rz = qx, qy, (1, 0)  # Jacobian

    def doubling_step():
        nonlocal rx, ry, rz
        tmp0 = fq2_sqr(rx)
        tmp1 = fq2_sqr(ry)
        tmp2 = fq2_sqr(tmp1)
        tmp3 = _dbl(fq2_sub(fq2_sub(fq2_sqr(fq2_add(tmp1, rx)), tmp0), tmp2))
        tmp4 = fq2_mul_scalar(tmp0, 3)
        tmp6 = fq2_add(rx, tmp4)
        tmp5 = fq2_sqr(tmp4)
        zsq = fq2_sqr(rz)
        rx = fq2_sub(fq2_sub(tmp5, tmp3), tmp3)
        rz = fq2_sub(fq2_sub(fq2_sqr(fq2_add(rz, ry)), tmp1), zsq)
        ry = fq2_sub(
            fq2_mul(fq2_sub(tmp3, rx), tmp4), fq2_mul_scalar(tmp2, 8)
        )
        c0 = fq2_neg(_dbl(fq2_mul(tmp4, zsq)))
        tmp6 = fq2_sub(
            fq2_sub(fq2_sqr(tmp6), tmp0), fq2_add(tmp5, fq2_mul_scalar(tmp1, 4))
        )
        c2 = tmp6
        c_last = _dbl(fq2_mul(rz, zsq))
        return (c_last, c0, c2)

    def addition_step():
        nonlocal rx, ry, rz
        zsq = fq2_sqr(rz)
        ysq = fq2_sqr(qy)
        t0 = fq2_mul(zsq, qx)
        t1 = fq2_mul(
            fq2_sub(fq2_sub(fq2_sqr(fq2_add(qy, rz)), ysq), zsq), zsq
        )
        t2 = fq2_sub(t0, rx)
        t3 = fq2_sqr(t2)
        t4 = fq2_mul_scalar(t3, 4)
        t5 = fq2_mul(t4, t2)
        t6 = fq2_sub(fq2_sub(t1, ry), ry)
        t9 = fq2_mul(t6, qx)
        t7 = fq2_mul(t4, rx)
        rx = fq2_sub(fq2_sub(fq2_sub(fq2_sqr(t6), t5), t7), t7)
        rz = fq2_sub(fq2_sub(fq2_sqr(fq2_add(rz, t2)), zsq), t3)
        t10 = fq2_add(qy, rz)
        t8 = fq2_mul(fq2_sub(t7, rx), t6)
        t0 = _dbl(fq2_mul(ry, t5))
        ry = fq2_sub(t8, t0)
        t10 = fq2_sub(fq2_sub(fq2_sqr(t10), ysq), fq2_sqr(rz))
        t9 = fq2_sub(_dbl(t9), t10)
        t10 = _dbl(rz)
        t6n = fq2_neg(t6)
        t1 = _dbl(t6n)
        return (t10, t1, t9)

    coeffs = []
    found_one = False
    for i in range(63, -1, -1):  # bits of BLS_X >> 1, MSB first
        bit = (BLS_X >> 1 >> i) & 1
        if not found_one:
            found_one = bool(bit)
            continue
        coeffs.append(doubling_step())
        if bit:
            coeffs.append(addition_step())
    coeffs.append(doubling_step())
    return coeffs


def miller_loop(pairs):
    """Multi-pair Miller loop; pairs = [(g1_affine, g2_coeffs_or_point)]."""
    prepared = []
    for p, q in pairs:
        if p is None or q is None:
            continue
        coeffs = q if isinstance(q, list) else g2_prepare(q)
        if coeffs is None:
            continue
        prepared.append((p, iter(coeffs)))

    def ell(f, coeffs, p):
        px, py = p
        c0 = fq2_mul_scalar(coeffs[0], py)
        c1 = fq2_mul_scalar(coeffs[1], px)
        return fq12_mul_by_014(f, coeffs[2], c1, c0)

    f = FQ12_ONE
    found_one = False
    for i in range(63, -1, -1):
        bit = (BLS_X >> 1 >> i) & 1
        if not found_one:
            found_one = bool(bit)
            continue
        for p, it in prepared:
            f = ell(f, next(it), p)
        if bit:
            for p, it in prepared:
                f = ell(f, next(it), p)
        f = fq12_sqr(f)
    for p, it in prepared:
        f = ell(f, next(it), p)
    # BLS_X is negative
    return fq12_conj(f)


def final_exponentiation(r):
    """(mod.rs:104-160); returns None if r is zero (non-invertible)."""
    f1 = fq12_conj(r)
    try:
        f2 = fq12_inv(r)
    except ZeroDivisionError:
        return None
    rr = fq12_mul(f1, f2)
    f2 = rr
    rr = fq12_mul(fq12_frobenius(rr, 2), f2)

    def exp_by_x(f):
        return fq12_conj(fq12_pow(f, BLS_X))  # x is negative

    y0 = fq12_sqr(rr)
    y1 = exp_by_x(y0)
    y2 = fq12_conj(fq12_pow(y1, BLS_X >> 1))  # exp by x/2
    y3 = fq12_conj(rr)
    y1 = fq12_mul(y1, y3)
    y1 = fq12_conj(y1)
    y1 = fq12_mul(y1, y2)
    y2 = exp_by_x(y1)
    y3 = exp_by_x(y2)
    y1 = fq12_conj(y1)
    y3 = fq12_mul(y3, y1)
    y1 = fq12_conj(y1)
    y1 = fq12_frobenius(y1, 3)
    y2 = fq12_frobenius(y2, 2)
    y1 = fq12_mul(y1, y2)
    y2 = exp_by_x(y3)
    y2 = fq12_mul(y2, y0)
    y2 = fq12_mul(y2, rr)
    y1 = fq12_mul(y1, y2)
    y2 = fq12_frobenius(y3, 1)
    y1 = fq12_mul(y1, y2)
    return y1


def pairing(p, q):
    """e(P, Q) for G1 affine p, G2 affine q."""
    return final_exponentiation(miller_loop([(p, q)]))
