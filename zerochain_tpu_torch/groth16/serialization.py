"""Byte-compatible Groth16 object serialization.

Formats (verified against reference fixtures in tests/vectors/):
  Proof      = 192 B: compressed A (48) | B (96) | C (48)
               (core/bellman-verifier/src/lib.rs:54-109)
  Fq12       = 576 B: c0 | c1 as Fq6; Fq6 = 3x Fq2; Fq2 = c0 | c1 as
               48-byte big-endian Fq  (core/pairing/src/bls12_381/fq12.rs:29-45)
  G2Prepared = u32 BE coeff count | coeffs (3x Fq2 each) | 1 B infinity
               (core/pairing/src/bls12_381/ec.rs:1624-1684)
  PreparedVerifyingKey = Fq12 | G2Prepared x2 | u32 BE ic len |
               uncompressed G1 x len  (core/bellman-verifier/src/lib.rs:174-237)
  VerifyingKey / Parameters follow the bellman fork layout (uncompressed
               points, u32 BE counts, zero-exponent a/b entries filtered).
"""

from __future__ import annotations

import io as _io

from ..mirror import curves as cv
from ..mirror.field import Q
from .core import Parameters, PreparedVerifyingKey, Proof, VerifyingKey


# ---------------------------------------------------------------- proof
def proof_to_bytes(p: Proof) -> bytes:
    return (
        cv.g1_to_compressed(p.a)
        + cv.g2_to_compressed(p.b)
        + cv.g1_to_compressed(p.c)
    )


def proof_from_bytes(b: bytes, check: bool = True) -> Proof:
    assert len(b) == 192, "proof must be 192 bytes"
    a = cv.g1_from_compressed(b[:48], check)
    g2 = cv.g2_from_compressed(b[48:144], check)
    c = cv.g1_from_compressed(b[144:], check)
    if a is None or g2 is None or c is None:
        raise cv.DecodeError("proof point at infinity")
    return Proof(a=a, b=g2, c=c)


# ---------------------------------------------------------------- tower
def fq2_to_bytes_rw(a) -> bytes:
    """Fq2::write order: c0 then c1 (unlike the G2 point codec)."""
    return a[0].to_bytes(48, "big") + a[1].to_bytes(48, "big")


def fq2_from_bytes_rw(b: bytes):
    c0 = int.from_bytes(b[:48], "big")
    c1 = int.from_bytes(b[48:], "big")
    if c0 >= Q or c1 >= Q:
        raise cv.DecodeError("Fq2 coordinate not in field")
    return (c0, c1)


def fq12_to_bytes(a) -> bytes:
    out = b""
    for c6 in a:
        for c2 in c6:
            out += fq2_to_bytes_rw(c2)
    return out


def fq12_from_bytes(b: bytes):
    assert len(b) == 576
    c6s = []
    for i in range(2):
        c2s = []
        for j in range(3):
            off = (i * 3 + j) * 96
            c2s.append(fq2_from_bytes_rw(b[off : off + 96]))
        c6s.append(tuple(c2s))
    return tuple(c6s)


def g2_prepared_to_bytes(coeffs, infinity: bool = False) -> bytes:
    if coeffs is None:
        coeffs, infinity = [], True
    out = len(coeffs).to_bytes(4, "big")
    for c in coeffs:
        out += fq2_to_bytes_rw(c[0]) + fq2_to_bytes_rw(c[1]) + fq2_to_bytes_rw(c[2])
    out += b"\x01" if infinity else b"\x00"
    return out


def g2_prepared_from_stream(r) -> tuple[list, bool]:
    n = int.from_bytes(r.read(4), "big")
    coeffs = []
    for _ in range(n):
        c0 = fq2_from_bytes_rw(r.read(96))
        c1 = fq2_from_bytes_rw(r.read(96))
        c2 = fq2_from_bytes_rw(r.read(96))
        coeffs.append((c0, c1, c2))
    flag = r.read(1)[0]
    if flag not in (0, 1):
        raise cv.DecodeError("bad infinity flag")
    return coeffs, bool(flag)


# ------------------------------------------------------------------ pvk
def pvk_to_bytes(pvk: PreparedVerifyingKey) -> bytes:
    out = fq12_to_bytes(pvk.alpha_g1_beta_g2)
    out += g2_prepared_to_bytes(pvk.neg_gamma_g2)
    out += g2_prepared_to_bytes(pvk.neg_delta_g2)
    out += len(pvk.ic).to_bytes(4, "big")
    for p in pvk.ic:
        out += cv.g1_to_uncompressed(p)
    return out


def pvk_from_bytes(b: bytes, check: bool = True) -> PreparedVerifyingKey:
    r = _io.BytesIO(b)
    alpha_beta = fq12_from_bytes(r.read(576))
    neg_gamma, _ = g2_prepared_from_stream(r)
    neg_delta, _ = g2_prepared_from_stream(r)
    n = int.from_bytes(r.read(4), "big")
    ic = []
    for _ in range(n):
        p = cv.g1_from_uncompressed(r.read(96), check)
        if p is None:
            raise cv.DecodeError("IC point at infinity")
        ic.append(p)
    rest = r.read()
    assert not rest, f"{len(rest)} trailing bytes in pvk"
    return PreparedVerifyingKey(
        alpha_g1_beta_g2=alpha_beta,
        neg_gamma_g2=neg_gamma,
        neg_delta_g2=neg_delta,
        ic=ic,
    )


# ------------------------------------------------------------------- vk
def vk_to_bytes(vk: VerifyingKey) -> bytes:
    out = cv.g1_to_uncompressed(vk.alpha_g1)
    out += cv.g1_to_uncompressed(vk.beta_g1)
    out += cv.g2_to_uncompressed(vk.beta_g2)
    out += cv.g2_to_uncompressed(vk.gamma_g2)
    out += cv.g1_to_uncompressed(vk.delta_g1)
    out += cv.g2_to_uncompressed(vk.delta_g2)
    out += len(vk.ic).to_bytes(4, "big")
    for p in vk.ic:
        out += cv.g1_to_uncompressed(p)
    return out


def vk_from_bytes(b: bytes, check: bool = True) -> VerifyingKey:
    r = _io.BytesIO(b)
    alpha_g1 = cv.g1_from_uncompressed(r.read(96), check)
    beta_g1 = cv.g1_from_uncompressed(r.read(96), check)
    beta_g2 = cv.g2_from_uncompressed(r.read(192), check)
    gamma_g2 = cv.g2_from_uncompressed(r.read(192), check)
    delta_g1 = cv.g1_from_uncompressed(r.read(96), check)
    delta_g2 = cv.g2_from_uncompressed(r.read(192), check)
    n = int.from_bytes(r.read(4), "big")
    ic = [cv.g1_from_uncompressed(r.read(96), check) for _ in range(n)]
    return VerifyingKey(
        alpha_g1=alpha_g1, beta_g1=beta_g1, beta_g2=beta_g2,
        gamma_g2=gamma_g2, delta_g1=delta_g1, delta_g2=delta_g2, ic=ic,
    )


# ------------------------------------------------------------ parameters
def params_to_bytes(params: Parameters) -> bytes:
    """bellman Parameters::write: vk, then h/l/a/b_g1/b_g2 with u32 BE
    lengths; zero-exponent (None) a/b entries are filtered out."""
    out = vk_to_bytes(params.vk)

    def g1_vec(v, filter_none):
        pts = [p for p in v if p is not None] if filter_none else v
        chunk = len(pts).to_bytes(4, "big")
        for p in pts:
            chunk += cv.g1_to_uncompressed(p)
        return chunk

    def g2_vec(v):
        pts = [p for p in v if p is not None]
        chunk = len(pts).to_bytes(4, "big")
        for p in pts:
            chunk += cv.g2_to_uncompressed(p)
        return chunk

    out += g1_vec(params.h, False)
    out += g1_vec(params.l, True)
    out += g1_vec(params.a, True)
    out += g1_vec(params.b_g1, True)
    out += g2_vec(params.b_g2)
    return out


def params_from_bytes(b: bytes, densities, num_inputs: int | None = None,
                      check: bool = False) -> Parameters:
    """Reconstruct Parameters; densities = (a_density, b_density) boolean
    lists over all variables (inputs then aux) saying which entries were
    kept, recovered by re-synthesizing the circuit (as bellman's prover
    recomputes density trackers)."""
    r = _io.BytesIO(b)
    vk_len = 96 * 3 + 192 * 3
    head = r.read(vk_len)
    n_ic = int.from_bytes(r.read(4), "big")
    vk = vk_from_bytes(head + n_ic.to_bytes(4, "big") + r.read(96 * n_ic), check)

    def g1_vec():
        n = int.from_bytes(r.read(4), "big")
        return [cv.g1_from_uncompressed(r.read(96), check) for _ in range(n)]

    def g2_vec():
        n = int.from_bytes(r.read(4), "big")
        return [cv.g2_from_uncompressed(r.read(192), check) for _ in range(n)]

    h = g1_vec()
    l = g1_vec()
    a_f = g1_vec()
    b1_f = g1_vec()
    b2_f = g2_vec()

    a_density, b_density = densities

    def expand(filtered, density):
        out, it = [], iter(filtered)
        for keep in density:
            out.append(next(it) if keep else None)
        return out

    # l is aux-length and unfiltered (bellman writes l as-is)
    return Parameters(
        vk=vk, h=h, l=l,
        a=expand(a_f, a_density),
        b_g1=expand(b1_f, b_density),
        b_g2=expand(b2_f, b_density),
        num_inputs=len(vk.ic) if num_inputs is None else num_inputs,
    )


def densities_for(circuit):
    """Which variables appear in A / in B (the bellman density trackers)."""
    from ..r1cs.system import ConstraintSystem
    from .core import _pad_input_constraints

    cs = ConstraintSystem(track_names=False)
    circuit.synthesize(cs)
    _pad_input_constraints(cs)
    n_in, n_aux = cs.num_inputs, len(cs.aux)
    a_d = [False] * (n_in + n_aux)
    b_d = [False] * (n_in + n_aux)
    for a, b, _ in cs.constraints:
        for (kind, idx), coeff in a:
            if coeff:
                a_d[idx if kind == "I" else n_in + idx] = True
        for (kind, idx), coeff in b:
            if coeff:
                b_d[idx if kind == "I" else n_in + idx] = True
    return a_d, b_d
