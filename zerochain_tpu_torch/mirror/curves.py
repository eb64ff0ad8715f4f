"""BLS12-381 G1/G2 group law + zcash-format point codecs (the oracle).

Affine points are ``(x, y)`` tuples (ints for G1, Fq2-tuples for G2); the
point at infinity is ``None``.  Encodings follow the reference exactly
(core/pairing/src/bls12_381/ec.rs:646-930 for G1, :1303-1560 for G2):
big-endian base-field bytes with flag bits in the top three bits of byte 0 —
bit7 = compressed, bit6 = infinity, bit5 = y is lexicographically largest
(compressed only).
"""

from __future__ import annotations

from . import field as F
from .field import (
    Q,
    R,
    fq2_add,
    fq2_inv,
    fq2_mul,
    fq2_mul_scalar,
    fq2_neg,
    fq2_sqr,
    fq2_sqrt,
    fq2_sub,
    FQ2_ZERO,
    FQ2_ONE,
    fq_inv,
    fq_sqrt,
)

# Curve constants: G1: y^2 = x^3 + 4; G2: y^2 = x^3 + 4(1+u)
B_G1 = 4
B_G2 = (4, 4)

# Generators (standard BLS12-381 generators; ec.rs cites "lexicographically
# smallest valid x"; values cross-checked in tests vs fq.rs:76-105)
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


# ---------------------------------------------------------------------------
# G1 (affine, ints)
# ---------------------------------------------------------------------------

def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + B_G1)) % Q == 0


def g1_neg(p):
    return None if p is None else (p[0], (Q - p[1]) % Q)


def g1_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        return g1_double(p)
    lam = (y2 - y1) * fq_inv((x2 - x1) % Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    return (x3, (lam * (x1 - x3) - y1) % Q)


def g1_double(p):
    if p is None:
        return None
    x, y = p
    if y == 0:
        return None
    lam = 3 * x * x * fq_inv(2 * y % Q) % Q
    x3 = (lam * lam - 2 * x) % Q
    return (x3, (lam * (x - x3) - y) % Q)


def g1_mul(p, k: int):
    k %= R  # exponent in the scalar field for prime-order ops
    return g1_mul_raw(p, k)


def g1_mul_raw(p, k: int):
    """Double-and-add with the raw integer (no reduction) — cofactor ops."""
    result = None
    addend = p
    while k:
        if k & 1:
            result = g1_add(result, addend)
        addend = g1_double(addend)
        k >>= 1
    return result


def g1_msm(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(p, s))
    return acc


def g1_in_subgroup(p) -> bool:
    return g1_mul_raw(p, R) is None


# ---------------------------------------------------------------------------
# G2 (affine, Fq2 tuples)
# ---------------------------------------------------------------------------

def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return fq2_sub(fq2_sqr(y), fq2_add(fq2_mul(fq2_sqr(x), x), B_G2)) == FQ2_ZERO


def g2_neg(p):
    return None if p is None else (p[0], fq2_neg(p[1]))


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        return g2_double(p)
    lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sqr(lam), x1), x2)
    return (x3, fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1))


def g2_double(p):
    if p is None:
        return None
    x, y = p
    if y == FQ2_ZERO:
        return None
    lam = fq2_mul(fq2_mul_scalar(fq2_sqr(x), 3), fq2_inv(fq2_add(y, y)))
    x3 = fq2_sub(fq2_sqr(lam), fq2_add(x, x))
    return (x3, fq2_sub(fq2_mul(lam, fq2_sub(x, x3)), y))


def g2_mul(p, k: int):
    return g2_mul_raw(p, k % R)


def g2_mul_raw(p, k: int):
    result = None
    addend = p
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_double(addend)
        k >>= 1
    return result


def g2_msm(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        acc = g2_add(acc, g2_mul(p, s))
    return acc


# ---------------------------------------------------------------------------
# Codecs (ec.rs G1Uncompressed/G1Compressed/G2Uncompressed/G2Compressed)
# ---------------------------------------------------------------------------

class DecodeError(ValueError):
    pass


def _fq2_lexicographic_gt(a, b) -> bool:
    """Fq2 ordering: compare c1 first, then c0 (pairing crate Ord for Fq2)."""
    if a[1] != b[1]:
        return a[1] > b[1]
    return a[0] > b[0]


def g1_to_uncompressed(p) -> bytes:
    if p is None:
        out = bytearray(96)
        out[0] |= 1 << 6
        return bytes(out)
    x, y = p
    return x.to_bytes(48, "big") + y.to_bytes(48, "big")


def g1_from_uncompressed(b: bytes, check: bool = True):
    if len(b) != 96:
        raise DecodeError("G1 uncompressed must be 96 bytes")
    flags = b[0]
    if flags & (1 << 7):
        raise DecodeError("unexpected compression flag")
    if flags & (1 << 6):
        if any(b[1:]) or (flags & 0b00111111):
            raise DecodeError("malformed infinity encoding")
        return None
    if flags & (1 << 5):
        raise DecodeError("unexpected sort flag")
    x = int.from_bytes(bytes([b[0] & 0b00011111]) + b[1:48], "big")
    y = int.from_bytes(b[48:96], "big")
    if x >= Q or y >= Q:
        raise DecodeError("coordinate not in field")
    p = (x, y)
    if check:
        if not g1_is_on_curve(p):
            raise DecodeError("not on curve")
        if not g1_in_subgroup(p):
            raise DecodeError("not in subgroup")
    return p


def g1_to_compressed(p) -> bytes:
    out = bytearray(48)
    if p is None:
        out[0] = (1 << 7) | (1 << 6)
        return bytes(out)
    x, y = p
    out[:] = x.to_bytes(48, "big")
    out[0] |= 1 << 7
    if y > (Q - y) % Q:
        out[0] |= 1 << 5
    return bytes(out)


def g1_from_compressed(b: bytes, check: bool = True):
    if len(b) != 48:
        raise DecodeError("G1 compressed must be 48 bytes")
    flags = b[0]
    if not flags & (1 << 7):
        raise DecodeError("compression flag must be set")
    if flags & (1 << 6):
        if any(b[1:]) or (flags & 0b00111111):
            raise DecodeError("malformed infinity encoding")
        return None
    greatest = bool(flags & (1 << 5))
    x = int.from_bytes(bytes([b[0] & 0b00011111]) + b[1:], "big")
    if x >= Q:
        raise DecodeError("x not in field")
    y = fq_sqrt((x * x * x + B_G1) % Q)
    if y is None:
        raise DecodeError("not on curve")
    negy = (Q - y) % Q
    y = max(y, negy) if greatest else min(y, negy)
    p = (x, y)
    if check and not g1_in_subgroup(p):
        raise DecodeError("not in subgroup")
    return p


def _fq2_to_bytes(a) -> bytes:
    # c1 first then c0 (ec.rs G2 serialization order)
    return a[1].to_bytes(48, "big") + a[0].to_bytes(48, "big")


def _fq2_from_bytes(b: bytes):
    c1 = int.from_bytes(b[:48], "big")
    c0 = int.from_bytes(b[48:96], "big")
    if c0 >= Q or c1 >= Q:
        raise DecodeError("coordinate not in field")
    return (c0, c1)


def g2_to_uncompressed(p) -> bytes:
    if p is None:
        out = bytearray(192)
        out[0] |= 1 << 6
        return bytes(out)
    x, y = p
    return _fq2_to_bytes(x) + _fq2_to_bytes(y)


def g2_from_uncompressed(b: bytes, check: bool = True):
    if len(b) != 192:
        raise DecodeError("G2 uncompressed must be 192 bytes")
    flags = b[0]
    if flags & (1 << 7):
        raise DecodeError("unexpected compression flag")
    if flags & (1 << 6):
        if any(b[1:]) or (flags & 0b00111111):
            raise DecodeError("malformed infinity encoding")
        return None
    if flags & (1 << 5):
        raise DecodeError("unexpected sort flag")
    xb = bytearray(b[:96])
    xb[0] &= 0b00011111
    x = _fq2_from_bytes(bytes(xb))
    y = _fq2_from_bytes(b[96:])
    p = (x, y)
    if check:
        if not g2_is_on_curve(p):
            raise DecodeError("not on curve")
        if g2_mul_raw(p, R) is not None:
            raise DecodeError("not in subgroup")
    return p


def g2_to_compressed(p) -> bytes:
    out = bytearray(96)
    if p is None:
        out[0] = (1 << 7) | (1 << 6)
        return bytes(out)
    x, y = p
    out[:] = _fq2_to_bytes(x)
    out[0] |= 1 << 7
    if _fq2_lexicographic_gt(y, fq2_neg(y)):
        out[0] |= 1 << 5
    return bytes(out)


def g2_from_compressed(b: bytes, check: bool = True):
    if len(b) != 96:
        raise DecodeError("G2 compressed must be 96 bytes")
    flags = b[0]
    if not flags & (1 << 7):
        raise DecodeError("compression flag must be set")
    if flags & (1 << 6):
        if any(b[1:]) or (flags & 0b00111111):
            raise DecodeError("malformed infinity encoding")
        return None
    greatest = bool(flags & (1 << 5))
    xb = bytearray(b)
    xb[0] &= 0b00011111
    x = _fq2_from_bytes(bytes(xb))
    rhs = fq2_add(fq2_mul(fq2_sqr(x), x), B_G2)
    y = fq2_sqrt(rhs)
    if y is None:
        raise DecodeError("not on curve")
    negy = fq2_neg(y)
    if _fq2_lexicographic_gt(y, negy) != greatest:
        y = negy
    p = (x, y)
    if check and g2_mul_raw(p, R) is not None:
        raise DecodeError("not in subgroup")
    return p


# ---------------------------------------------------------------------------
# Jacobian fast paths (host-side bulk exponentiation for CRS generation).
# Mirrors the wNAF/windowed design intent of the reference's Wnaf context
# (core/pairing/src/wnaf.rs) in windowed-table form.
# ---------------------------------------------------------------------------

from .field import fq_add, fq_mul, fq_neg


class _JacOps:
    """Generic Jacobian ops over a base field given (mul, add, neg, zero?)"""

    def __init__(self, mul, add, neg, one):
        self.mul = mul
        self.add_f = add
        self.neg = neg
        self.one = one

    def double(self, p):
        if p is None:
            return None
        mul, add, neg = self.mul, self.add_f, self.neg
        X, Y, Z = p
        A = mul(X, X)
        B = mul(Y, Y)
        C = mul(B, B)
        t = add(X, B)
        t = mul(t, t)
        D = add(t, neg(add(A, C)))
        D = add(D, D)
        E = add(add(A, A), A)
        F = mul(E, E)
        X3 = add(F, neg(add(D, D)))
        c4 = add(C, C)
        c8 = add(add(c4, c4), add(c4, c4))
        Y3 = add(mul(E, add(D, neg(X3))), neg(c8))
        Z3 = add(mul(Y, Z), mul(Y, Z))
        return (X3, Y3, Z3)

    def add_mixed(self, p, q_affine):
        """p Jacobian (or None), q affine (x, y)."""
        if q_affine is None:
            return p
        if p is None:
            return (q_affine[0], q_affine[1], self.one)
        mul, add, neg = self.mul, self.add_f, self.neg
        X1, Y1, Z1 = p
        x2, y2 = q_affine
        Z1Z1 = mul(Z1, Z1)
        U2 = mul(x2, Z1Z1)
        S2 = mul(mul(y2, Z1), Z1Z1)
        H = add(U2, neg(X1))
        r = add(S2, neg(Y1))
        if H == self._zero_like(X1):
            if r == self._zero_like(X1):
                return self.double(p)
            return None
        HH = mul(H, H)
        I = add(add(HH, HH), add(HH, HH))
        J = mul(H, I)
        r2 = add(r, r)
        V = mul(X1, I)
        X3 = add(add(mul(r2, r2), neg(J)), neg(add(V, V)))
        Y1J = mul(Y1, J)
        Y3 = add(mul(r2, add(V, neg(X3))), neg(add(Y1J, Y1J)))
        t = add(Z1, H)
        Z3 = add(mul(t, t), neg(add(Z1Z1, HH)))
        return (X3, Y3, Z3)

    def add(self, p, q):
        """Full Jacobian + Jacobian addition."""
        if p is None:
            return q
        if q is None:
            return p
        mul, add, neg = self.mul, self.add_f, self.neg
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1 = mul(Z1, Z1)
        Z2Z2 = mul(Z2, Z2)
        U1 = mul(X1, Z2Z2)
        U2 = mul(X2, Z1Z1)
        S1 = mul(mul(Y1, Z2), Z2Z2)
        S2 = mul(mul(Y2, Z1), Z1Z1)
        H = add(U2, neg(U1))
        r = add(S2, neg(S1))
        if H == self._zero_like(X1):
            if r == self._zero_like(X1):
                return self.double(p)
            return None
        HH = mul(H, H)
        I = add(add(HH, HH), add(HH, HH))
        J = mul(H, I)
        r2 = add(r, r)
        V = mul(U1, I)
        X3 = add(add(mul(r2, r2), neg(J)), neg(add(V, V)))
        S1J = mul(S1, J)
        Y3 = add(mul(r2, add(V, neg(X3))), neg(add(S1J, S1J)))
        t = add(Z1, Z2)
        Z3 = mul(add(mul(t, t), neg(add(Z1Z1, Z2Z2))), H)
        return (X3, Y3, Z3)

    @staticmethod
    def _zero_like(x):
        return 0 if isinstance(x, int) else (0, 0)


_G1_JAC = _JacOps(fq_mul, fq_add, fq_neg, 1)
_G2_JAC = _JacOps(fq2_mul, fq2_add, fq2_neg, FQ2_ONE)


def _jac_to_affine_g1(p):
    if p is None or p[2] == 0:
        return None
    zi = fq_inv(p[2])
    zi2 = zi * zi % Q
    return (p[0] * zi2 % Q, p[1] * zi2 % Q * zi % Q)


def _jac_to_affine_g2(p):
    if p is None or p[2] == FQ2_ZERO:
        return None
    zi = fq2_inv(p[2])
    zi2 = fq2_sqr(zi)
    return (fq2_mul(p[0], zi2), fq2_mul(fq2_mul(p[1], zi2), zi))


class FixedBaseExp:
    """Windowed fixed-base exponentiation (8-bit windows, Jacobian)."""

    def __init__(self, base_affine, jac, to_affine, c=8, n_bits=256):
        self.jac = jac
        self.to_affine = to_affine
        self.c = c
        self.n_windows = -(-n_bits // c)
        # table[w][k] = k * 2^{cw} * base (affine)
        self.table = []
        cur = base_affine
        for _ in range(self.n_windows):
            row = [None]
            acc = None
            for _ in range((1 << c) - 1):
                acc = jac.add_mixed(acc, cur)
                row.append(self.to_affine(acc))
            self.table.append(row)
            # cur = 2^c * cur
            j = (cur[0], cur[1], jac.one)
            for _ in range(c):
                j = jac.double(j)
            cur = self.to_affine(j)

    def exp(self, e: int):
        acc = None
        w = 0
        while e:
            k = e & ((1 << self.c) - 1)
            if k:
                acc = self.jac.add_mixed(acc, self.table[w][k])
            e >>= self.c
            w += 1
        return self.to_affine(acc)

    def exp_many(self, exps):
        return [self.exp(e) for e in exps]


_FIXED_EXP_CACHE: dict = {}


def g1_fixed_base_exp(exponents):
    """[g1^e] with a cached 8-bit window table (fast host path)."""
    if "g1" not in _FIXED_EXP_CACHE:
        _FIXED_EXP_CACHE["g1"] = FixedBaseExp(
            G1_GEN, _G1_JAC, _jac_to_affine_g1
        )
    return _FIXED_EXP_CACHE["g1"].exp_many(exponents)


def g2_fixed_base_exp(exponents):
    if "g2" not in _FIXED_EXP_CACHE:
        _FIXED_EXP_CACHE["g2"] = FixedBaseExp(
            G2_GEN, _G2_JAC, _jac_to_affine_g2
        )
    return _FIXED_EXP_CACHE["g2"].exp_many(exponents)


def _pippenger(jac, to_affine, points, scalars, c=8, n_bits=255):
    """Host windowed-bucket MSM (Jacobian); points affine, ints scalars."""
    pairs = [(p, s) for p, s in zip(points, scalars) if p is not None and s]
    if not pairs:
        return None
    n_windows = -(-n_bits // c)
    mask = (1 << c) - 1
    result = None
    for w in range(n_windows - 1, -1, -1):
        if result is not None:
            for _ in range(c):
                result = jac.double(result) if result else None
        buckets = [None] * (1 << c)
        shift = w * c
        for p, s in pairs:
            k = (s >> shift) & mask
            if k:
                buckets[k] = jac.add_mixed(buckets[k], p)
        running = None
        total = None
        for k in range(mask, 0, -1):
            if buckets[k] is not None:
                running = jac.add(running, buckets[k])
            if running is not None:
                total = jac.add(total, running)
        result = jac.add(result, total)
    return to_affine(result)


def g1_msm_fast(points, scalars):
    """Pippenger over G1 (the host-side bellman-multiexp equivalent)."""
    return _pippenger(_G1_JAC, _jac_to_affine_g1, points, scalars)


def g2_msm_fast(points, scalars):
    return _pippenger(_G2_JAC, _jac_to_affine_g2, points, scalars)
