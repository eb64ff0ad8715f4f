"""Evaluation domain over Fr: radix-2 (i)NTT + coset transforms (oracle).

Mirrors bellman's EvaluationDomain semantics: power-of-two domain with
omega = ROOT_OF_UNITY^(2^(32 - lg d)); coset generator is Fr's
multiplicative generator 7 (core/pairing/src/bls12_381/fr.rs:38,50).
The tensor NTT (ntt/) is validated against this module.
"""

from __future__ import annotations

from ..mirror.field import R, FR_GENERATOR, FR_ROOT_OF_UNITY, FR_S, fr_inv


def domain_size(n: int) -> int:
    d = 1
    while d < n:
        d <<= 1
    return d


def omega_for(d: int) -> int:
    lg = d.bit_length() - 1
    assert 1 << lg == d and lg <= FR_S
    return pow(FR_ROOT_OF_UNITY, 1 << (FR_S - lg), R)


def ntt(a: list[int], omega: int) -> list[int]:
    """In-order iterative radix-2 Cooley-Tukey NTT (length = power of 2)."""
    n = len(a)
    a = list(a)
    # bit reversal
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    m = 1
    while m < n:
        w_m = pow(omega, n // (2 * m), R)
        for k in range(0, n, 2 * m):
            w = 1
            for l in range(m):
                t = a[k + l + m] * w % R
                u = a[k + l]
                a[k + l] = (u + t) % R
                a[k + l + m] = (u - t) % R
                w = w * w_m % R
        m <<= 1
    return a


def intt(a: list[int], omega: int) -> list[int]:
    n = len(a)
    inv_n = fr_inv(n)
    out = ntt(a, fr_inv(omega))
    return [x * inv_n % R for x in out]


def coset_scale(a: list[int], g: int = FR_GENERATOR) -> list[int]:
    out = []
    cur = 1
    for x in a:
        out.append(x * cur % R)
        cur = cur * g % R
    return out


def coset_fft(coeffs: list[int], omega: int) -> list[int]:
    return ntt(coset_scale(coeffs), omega)


def icoset_fft(evals: list[int], omega: int) -> list[int]:
    return coset_scale(intt(evals, omega), fr_inv(FR_GENERATOR))


def z_on_coset(d: int) -> int:
    """Vanishing polynomial on the coset: g^d - 1 (constant over the coset)."""
    return (pow(FR_GENERATOR, d, R) - 1) % R
