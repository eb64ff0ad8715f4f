"""Jubjub (twisted Edwards over Fr of BLS12-381) — the oracle.

Mirrors core/jubjub/src/curve/{mod.rs,edwards.rs,montgomery.rs,fs.rs} and
core/jubjub/src/group_hash.rs.  Affine Edwards points are ``(x, y)`` int
tuples; identity is ``(0, 1)``.  The curve is ``-x^2 + y^2 = 1 + d x^2 y^2``
with ``d = -(10240/10241)`` (complete — no exceptional cases), cofactor 8,
prime subgroup order ``S`` (field.py).
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

from .field import R, S, fr_inv, fr_sqrt

# d = -(10240/10241) mod r  (curve/mod.rs:218 stores the decimal expansion;
# we derive it).  EDWARDS_A = -1.
EDWARDS_D = (R - 10240) * fr_inv(10241) % R
# Montgomery form y^2 = x^3 + A x^2 + x with A = 2(a+d)/(a-d), a = -1
MONTGOMERY_A = 2 * (EDWARDS_D - 1) % R * fr_inv((R - 1 - EDWARDS_D) % R) % R
# scale = sqrt(4 / (a - d)) — conversion factor between the forms
MONTGOMERY_SCALE = fr_sqrt(4 * fr_inv((R - 1 - EDWARDS_D) % R) % R)

ZERO = (0, 1)

# --------------------------------------------------------------------------
# Edwards group law (complete formulas)
# --------------------------------------------------------------------------

def is_on_curve(p) -> bool:
    x, y = p
    return (
        (-x * x + y * y) % R == (1 + EDWARDS_D * x * x % R * y % R * y) % R
    )


def neg(p):
    x, y = p
    return ((R - x) % R, y)


def add(p, q):
    x1, y1 = p
    x2, y2 = q
    prod = EDWARDS_D * x1 % R * x2 % R * y1 % R * y2 % R
    x3 = (x1 * y2 + y1 * x2) % R * fr_inv((1 + prod) % R) % R
    y3 = (y1 * y2 + x1 * x2) % R * fr_inv((1 - prod) % R) % R
    return (x3, y3)


def double(p):
    return add(p, p)


_D2 = 2 * EDWARDS_D % R


def _ext_add(p, q):
    """The same complete law on extended coordinates (X : Y : Z : T), with
    no inversion (add-2008-hwcd-3, a = -1)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % R
    b = (y1 + x1) * (y2 + x2) % R
    c = t1 * _D2 % R * t2 % R
    d = 2 * z1 * z2 % R
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % R, g * h % R, f * g % R, e * h % R)


def mul(p, k: int):
    """Scalar mul by a raw integer (host semantics: repr bits, no reduction;
    edwards.rs:520-540 double-and-add), on extended coordinates with one
    inversion at the end: the law is complete, so the affine result is the
    affine loop's."""
    x, y = p
    result = (0, 1, 1, 0)
    addend = (x, y, 1, x * y % R)
    while k:
        if k & 1:
            result = _ext_add(result, addend)
        addend = _ext_add(addend, addend)
        k >>= 1
    zi = fr_inv(result[2])
    return (result[0] * zi % R, result[1] * zi % R)


def mul_by_cofactor(p):
    return double(double(double(p)))


def is_prime_order(p) -> bool:
    """as_prime_order check (edwards.rs): p != 0 and s*p == 0."""
    return p != ZERO and mul(p, S) == ZERO


def is_small_order(p) -> bool:
    return mul_by_cofactor(p) == ZERO


# --------------------------------------------------------------------------
# Codec — 32 bytes: y little-endian, bit 255 = (x is odd)  (edwards.rs read/
# write; reads reject y >= r and off-curve values)
# --------------------------------------------------------------------------

class DecodeError(ValueError):
    pass


def to_bytes(p) -> bytes:
    x, y = p
    v = y | ((x & 1) << 255)
    return v.to_bytes(32, "little")


def get_for_y(y: int, x_odd: bool):
    """x^2 = (y^2 - 1)/(d y^2 + 1); pick the root with matching parity."""
    y2 = y * y % R
    denom = (EDWARDS_D * y2 + 1) % R
    xx = (y2 - 1) % R * fr_inv(denom) % R
    x = fr_sqrt(xx)
    if x is None:
        return None
    if (x & 1) != x_odd:
        x = (R - x) % R
    return (x, y)


def from_bytes(b: bytes):
    """Unknown-order point decode (no subgroup check — edwards.rs read)."""
    if len(b) != 32:
        raise DecodeError("jubjub point must be 32 bytes")
    v = int.from_bytes(b, "little")
    x_odd = bool(v >> 255)
    y = v & ((1 << 255) - 1)
    if y >= R:
        raise DecodeError("y not in field")
    p = get_for_y(y, x_odd)
    if p is None:
        raise DecodeError("not on curve")
    return p


def from_bytes_prime_order(b: bytes):
    """Decode + as_prime_order (rejects small/mixed order; elgamal.rs read)."""
    p = from_bytes(b)
    if not is_prime_order(p):
        raise DecodeError("not in the prime-order subgroup")
    return p


# --------------------------------------------------------------------------
# Montgomery form (montgomery.rs) — affine (u, v); infinity is None
# --------------------------------------------------------------------------

def edwards_to_montgomery(p):
    x, y = p
    if y == 1:
        return None
    if x == 0:
        return (0, 0)
    u = (1 + y) * fr_inv((1 - y) % R) % R
    v = MONTGOMERY_SCALE * u % R * fr_inv(x) % R
    return (u, v)


def montgomery_to_edwards(p):
    if p is None:
        return ZERO
    u, v = p
    if v == 0:
        # order-2 point (0,0) -> (0, -1)
        return (0, (R - 1) % R)
    x = MONTGOMERY_SCALE * u % R * fr_inv(v) % R
    y = (u - 1) % R * fr_inv((u + 1) % R) % R
    return (x, y)


def montgomery_is_on_curve(p) -> bool:
    if p is None:
        return True
    u, v = p
    return v * v % R == (u * u % R * u + MONTGOMERY_A * u % R * u + u) % R


def montgomery_add(p, q):
    """Incomplete Montgomery chord/tangent law (montgomery.rs add)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % R == 0:
            return None
        lam = (
            (3 * x1 * x1 + 2 * MONTGOMERY_A * x1 + 1)
            % R
            * fr_inv(2 * y1 % R)
            % R
        )
    else:
        lam = (y2 - y1) % R * fr_inv((x2 - x1) % R) % R
    x3 = (lam * lam - MONTGOMERY_A - x1 - x2) % R
    return (x3, (lam * (x1 - x3) - y1) % R)


# --------------------------------------------------------------------------
# group_hash (group_hash.rs:17-46) and the fixed generators (curve/mod.rs)
# --------------------------------------------------------------------------

GH_FIRST_BLOCK = (
    b"096b36a5804bfacef1691e173c366a47ff5ba84a44f26ddd7e8d9f79d5b42df0"
)

PEDERSEN_HASH_GENERATORS_PERSONALIZATION = b"Zcash_PH"
PROOF_GENERATION_KEY_BASE_GENERATOR_PERSONALIZATION = b"Zcash_H_"
NULLIFIER_POSITION_IN_TREE_GENERATOR_PERSONALIZATION = b"Zcash_J_"
VALUE_COMMITMENT_GENERATOR_PERSONALIZATION = b"Zcash_cv"
SPENDING_KEY_GENERATOR_PERSONALIZATION = b"Zcash_G_"


def group_hash(tag: bytes, personalization: bytes):
    """Random prime-order point from a tag; None on failure."""
    assert len(personalization) == 8
    h = hashlib.blake2s(digest_size=32, person=personalization)
    h.update(GH_FIRST_BLOCK)
    h.update(tag)
    try:
        p = from_bytes(h.digest())
    except DecodeError:
        return None
    p = mul_by_cofactor(p)
    return p if p != ZERO else None


def find_group_hash(m: bytes, personalization: bytes):
    """First successful group_hash of m || counter (curve/mod.rs:231-252)."""
    counter = 0
    while True:
        p = group_hash(m + bytes([counter]), personalization)
        assert counter != 255, "exhausted group-hash counter"
        counter += 1
        if p is not None:
            return p


# FixedGenerators indices (curve/mod.rs:67-91; external sapling-crypto names
# in parentheses — the circuits use the sapling names)
PROOF_GENERATION_KEY_BASE = 0   # (ProofGenerationKey)
NOTE_COMMITMENT_RANDOMNESS = 1  # (NoteCommitmentRandomness / "Diversifier")
ELGAMAL = 2                     # (NullifierPosition / "ElGamal")
VALUE_COMMITMENT_VALUE = 3
VALUE_COMMITMENT_RANDOMNESS = 4
SPENDING_KEY_GENERATOR = 5
MAX_FIXED_GENERATORS = 6

FIXED_BASE_CHUNKS_PER_GENERATOR = 84  # curve/mod.rs:186
PEDERSEN_HASH_CHUNKS_PER_GENERATOR = 63  # curve/mod.rs:183
PEDERSEN_HASH_EXP_WINDOW_SIZE = 8  # curve/mod.rs:192


@lru_cache(maxsize=None)
def fixed_base_generators():
    """The six protocol base points (curve/mod.rs:319-338)."""
    return (
        find_group_hash(
            b"", PROOF_GENERATION_KEY_BASE_GENERATOR_PERSONALIZATION
        ),
        find_group_hash(b"r", PEDERSEN_HASH_GENERATORS_PERSONALIZATION),
        find_group_hash(
            b"", NULLIFIER_POSITION_IN_TREE_GENERATOR_PERSONALIZATION
        ),
        find_group_hash(b"v", VALUE_COMMITMENT_GENERATOR_PERSONALIZATION),
        find_group_hash(b"r", VALUE_COMMITMENT_GENERATOR_PERSONALIZATION),
        find_group_hash(b"", SPENDING_KEY_GENERATOR_PERSONALIZATION),
    )


def generator(index: int = NOTE_COMMITMENT_RANDOMNESS):
    return fixed_base_generators()[index]


@lru_cache(maxsize=None)
def pedersen_hash_generators():
    """Five segment generators, tag = LE u32 segment number (mod.rs:254)."""
    return tuple(
        find_group_hash(
            m.to_bytes(4, "little"),
            PEDERSEN_HASH_GENERATORS_PERSONALIZATION,
        )
        for m in range(5)
    )


@lru_cache(maxsize=None)
def fixed_base_circuit_generators(index: int):
    """3-bit window tables for the in-circuit fixed-base mul.

    84 chunks; window i holds [identity, g, 2g, ..., 7g] in affine (x, y)
    where g = 8^i * base (curve/mod.rs:389-407).  Entry 0 is (0, 1).
    """
    gen = generator(index)
    windows = []
    for _ in range(FIXED_BASE_CHUNKS_PER_GENERATOR):
        coeffs = [ZERO]
        g = gen
        for _ in range(7):
            coeffs.append(g)
            g = add(g, gen)
        windows.append(coeffs)
        gen = g  # g is now 8 * original gen
    return windows


@lru_cache(maxsize=None)
def pedersen_circuit_generators():
    """2-bit Montgomery window tables for the Pedersen-hash gadget.

    Per segment generator: 63 chunks; per chunk coeffs = [g, 2g, 3g, 4g] in
    Montgomery (x, y), chunks separated by 4 doublings (mod.rs:358-386).
    """
    out = []
    for gen_e in pedersen_hash_generators():
        gen = edwards_to_montgomery(gen_e)
        windows = []
        for _ in range(PEDERSEN_HASH_CHUNKS_PER_GENERATOR):
            coeffs = []
            g = gen
            for _ in range(4):
                assert g is not None, "cannot produce O"
                coeffs.append(g)
                g = montgomery_add(g, gen)
            windows.append(coeffs)
            for _ in range(4):
                gen = montgomery_add(gen, gen)
        out.append(windows)
    return out
