"""Groth16 setup / prover / verifier over BLS12-381 (bellman semantics).

CRS and proof construction follow the bellman fork's groth16 module (the
reference's external prover, imported at core/proofs/src/setup.rs:2-5 and
confidential.rs:149): per-input padding constraints for IC density, Lagrange
coefficients at tau via iNTT, quotient h(x) on a multiplicative coset, and
the standard A/B/C multiexp assembly.

The `backend` argument supplies the hot kernels:
    msm_g1(points, scalars) -> point      variable-base G1 MSM
    msm_g2(points, scalars) -> point      variable-base G2 MSM
so the device implementation (prover/) swaps in transparently.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..mirror import curves as cv
from ..mirror import pairing as pr
from ..mirror.field import R, fr_inv
from ..r1cs.system import ConstraintSystem
from . import domain as dom


class MirrorBackend:
    """Naive bigint kernels — the correctness oracle (slow, small sizes)."""

    @staticmethod
    def msm_g1(points, scalars):
        return cv.g1_msm_fast(points, scalars)

    @staticmethod
    def msm_g2(points, scalars):
        return cv.g2_msm_fast(points, scalars)

    @staticmethod
    def fixed_base_g1(exponents):
        """[g1^e for e in exponents]; zero exponent -> None (infinity)."""
        return cv.g1_fixed_base_exp(exponents)

    @staticmethod
    def fixed_base_g2(exponents):
        return cv.g2_fixed_base_exp(exponents)

    @staticmethod
    def compute_h(cs):
        """Quotient-poly scalar list (host oracle path)."""
        return compute_h_scalars(cs)


MIRROR = MirrorBackend()


@dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    ic: list


@dataclass
class PreparedVerifyingKey:
    """alpha*beta pairing value, prepared -gamma/-delta, IC copy.

    (reference core/bellman-verifier/src/lib.rs:114-123)"""

    alpha_g1_beta_g2: tuple  # Fq12
    neg_gamma_g2: list  # G2Prepared coeff triples
    neg_delta_g2: list
    ic: list
    # affine points kept for re-serialization of the prepared pairs
    neg_gamma_g2_affine: tuple | None = None
    neg_delta_g2_affine: tuple | None = None


@dataclass
class Proof:
    a: tuple  # G1 affine
    b: tuple  # G2 affine
    c: tuple  # G1 affine


@dataclass
class Parameters:
    vk: VerifyingKey
    h: list  # G1, len d-1
    l: list  # G1, len num_aux (None where zero)
    a: list  # G1 per variable (inputs then aux); None where u_v == 0
    b_g1: list  # G1 per variable; None where v_v == 0
    b_g2: list  # G2 per variable; None where v_v == 0
    num_inputs: int


def _pad_input_constraints(cs: ConstraintSystem):
    """bellman generator/prover: enforce input * 0 = 0 per public input."""
    for i in range(cs.num_inputs):
        cs.enforce("", [(("I", i), 1)], [], [])


def _transpose(cs: ConstraintSystem, num_vars: int, offset_aux: int):
    """Per-variable sparse rows: var -> [(constraint_idx, coeff)] for A,B,C."""
    at = [[] for _ in range(num_vars)]
    bt = [[] for _ in range(num_vars)]
    ct = [[] for _ in range(num_vars)]
    for cidx, (a, b, c) in enumerate(cs.constraints):
        for terms, dest in ((a, at), (b, bt), (c, ct)):
            for (kind, idx), coeff in terms:
                v = idx if kind == "I" else offset_aux + idx
                dest[v].append((cidx, coeff))
    return at, bt, ct


def crs_exponents(circuit, tau: int, alpha: int, beta: int, gamma: int,
                  delta: int):
    """The CRS exponent vectors (bellman generator.rs, pre-exponentiation).

    Returns dict with h/a(u)/b(v)/ic/l exponent lists + num_inputs."""
    cs = ConstraintSystem(track_names=False)
    circuit.synthesize(cs)
    _pad_input_constraints(cs)

    n_in = cs.num_inputs
    n_vars = n_in + len(cs.aux)
    m = cs.num_constraints
    d = dom.domain_size(m)
    omega = dom.omega_for(d)

    gamma_inv = fr_inv(gamma)
    delta_inv = fr_inv(delta)

    # Lagrange coefficients at tau: iNTT of (1, tau, ..., tau^{d-1})
    taupows = []
    cur = 1
    for _ in range(d):
        taupows.append(cur)
        cur = cur * tau % R
    # h query exponents: tau^i * z(tau)/delta, i in 0..d-2
    zt_delta = (pow(tau, d, R) - 1) % R * delta_inv % R
    h_exps = [taupows[i] * zt_delta % R for i in range(d - 1)]

    lag = dom.intt(taupows, omega)
    at, bt, ct = _transpose(cs, n_vars, n_in)

    def poly_at_tau(rows):
        return [
            sum(coeff * lag[cidx] for cidx, coeff in row) % R if row else 0
            for row in rows
        ]

    u = poly_at_tau(at)
    v = poly_at_tau(bt)
    w = poly_at_tau(ct)

    ic_exps = [
        (beta * u[i] + alpha * v[i] + w[i]) % R * gamma_inv % R
        for i in range(n_in)
    ]
    l_exps = [
        (beta * u[i] + alpha * v[i] + w[i]) % R * delta_inv % R
        for i in range(n_in, n_vars)
    ]
    return dict(
        h=h_exps, u=u, v=v, ic=ic_exps, l=l_exps, num_inputs=n_in,
        alpha=alpha, beta=beta, gamma=gamma, delta=delta,
    )


def vk_from_exponents(exps, ic_points=None) -> VerifyingKey:
    g1, g2 = cv.G1_GEN, cv.G2_GEN
    if ic_points is None:
        ic_points = cv.g1_fixed_base_exp(exps["ic"])
    return VerifyingKey(
        alpha_g1=cv.g1_mul(g1, exps["alpha"]),
        beta_g1=cv.g1_mul(g1, exps["beta"]),
        beta_g2=cv.g2_mul(g2, exps["beta"]),
        gamma_g2=cv.g2_mul(g2, exps["gamma"]),
        delta_g1=cv.g1_mul(g1, exps["delta"]),
        delta_g2=cv.g2_mul(g2, exps["delta"]),
        ic=ic_points,
    )


def generate_parameters(
    circuit, tau: int, alpha: int, beta: int, gamma: int, delta: int,
    backend=MIRROR,
) -> Parameters:
    """Deterministic CRS from explicit toxic waste (bellman generator.rs)."""
    exps = crs_exponents(circuit, tau, alpha, beta, gamma, delta)
    h_exps, u, v = exps["h"], exps["u"], exps["v"]
    ic_exps, l_exps = exps["ic"], exps["l"]

    # bulk fixed-base exponentiations (the CRS hot loop) via the backend
    n_h, n_u, n_v, n_ic = len(h_exps), len(u), len(v), len(ic_exps)
    all_g1 = backend.fixed_base_g1(h_exps + u + v + ic_exps + l_exps)
    h = all_g1[:n_h]
    a_query = all_g1[n_h : n_h + n_u]
    b_g1_query = all_g1[n_h + n_u : n_h + n_u + n_v]
    ic = all_g1[n_h + n_u + n_v : n_h + n_u + n_v + n_ic]
    l_query = all_g1[n_h + n_u + n_v + n_ic :]
    b_g2_query = backend.fixed_base_g2(v)

    assert all(p is not None for p in ic), "IC must not contain infinity"

    vk = vk_from_exponents(exps, ic_points=ic)
    return Parameters(
        vk=vk, h=h, l=l_query, a=a_query, b_g1=b_g1_query, b_g2=b_g2_query,
        num_inputs=exps["num_inputs"],
    )


def _rand_fr(rng=None) -> int:
    while True:
        v = int.from_bytes(os.urandom(32), "little") % R
        if v:
            return v


def generate_random_parameters(circuit, backend=MIRROR) -> Parameters:
    return generate_parameters(
        circuit, _rand_fr(), _rand_fr(), _rand_fr(), _rand_fr(), _rand_fr(),
        backend=backend,
    )


def synthesize_witness(circuit):
    """Run witness synthesis; returns (cs, input_assignment, aux_assignment)."""
    cs = ConstraintSystem(track_names=False)
    circuit.synthesize(cs)
    _pad_input_constraints(cs)
    assert cs.is_satisfied(), "witness does not satisfy the circuit"
    return cs, list(cs.inputs), list(cs.aux)


def compute_h_scalars(cs: ConstraintSystem):
    """Quotient polynomial coefficients (bellman prover.rs eval_h).

    Returns d-1 Fr scalars to pair with the h query."""
    m = cs.num_constraints
    d = dom.domain_size(m)
    omega = dom.omega_for(d)

    a_vals = [cs.eval_lc(a) for a, _, _ in cs.constraints] + [0] * (d - m)
    b_vals = [cs.eval_lc(b) for _, b, _ in cs.constraints] + [0] * (d - m)
    c_vals = [cs.eval_lc(c) for _, _, c in cs.constraints] + [0] * (d - m)

    a_c = dom.coset_fft(dom.intt(a_vals, omega), omega)
    b_c = dom.coset_fft(dom.intt(b_vals, omega), omega)
    c_c = dom.coset_fft(dom.intt(c_vals, omega), omega)

    zinv = fr_inv(dom.z_on_coset(d))
    q = [(a_c[i] * b_c[i] - c_c[i]) % R * zinv % R for i in range(d)]
    coeffs = dom.icoset_fft(q, omega)
    return coeffs[: d - 1]


def create_proof(circuit, params: Parameters, r: int, s: int,
                 backend=MIRROR) -> Proof:
    cs, inputs, aux = synthesize_witness(circuit)
    h_scalars = backend.compute_h(cs)

    full_assignment = inputs + aux
    vk = params.vk

    h_acc = backend.msm_g1(params.h, h_scalars)
    l_acc = backend.msm_g1(params.l, aux)

    a_acc = backend.msm_g1(params.a, full_assignment)
    b1_acc = backend.msm_g1(params.b_g1, full_assignment)
    b2_acc = backend.msm_g2(params.b_g2, full_assignment)

    # A = alpha + sum + r*delta
    g_a = cv.g1_add(
        cv.g1_add(vk.alpha_g1, a_acc), cv.g1_mul(vk.delta_g1, r)
    )
    # B = beta + sum + s*delta
    g_b = cv.g2_add(
        cv.g2_add(vk.beta_g2, b2_acc), cv.g2_mul(vk.delta_g2, s)
    )
    # C = s*A + r*B1 - rs*delta + l + h, with B1 = beta_g1 + b1 + s*delta_g1
    b1_full = cv.g1_add(
        cv.g1_add(vk.beta_g1, b1_acc), cv.g1_mul(vk.delta_g1, s)
    )
    g_c = cv.g1_mul(g_a, s)
    g_c = cv.g1_add(g_c, cv.g1_mul(b1_full, r))
    g_c = cv.g1_add(g_c, cv.g1_neg(cv.g1_mul(vk.delta_g1, r * s % R)))
    g_c = cv.g1_add(g_c, l_acc)
    g_c = cv.g1_add(g_c, h_acc)

    return Proof(a=g_a, b=g_b, c=g_c)


def create_random_proof(circuit, params: Parameters, backend=MIRROR) -> Proof:
    return create_proof(circuit, params, _rand_fr(), _rand_fr(), backend)


def prepare_verifying_key(vk: VerifyingKey) -> PreparedVerifyingKey:
    neg_gamma = cv.g2_neg(vk.gamma_g2)
    neg_delta = cv.g2_neg(vk.delta_g2)
    return PreparedVerifyingKey(
        alpha_g1_beta_g2=pr.pairing(vk.alpha_g1, vk.beta_g2),
        neg_gamma_g2=pr.g2_prepare(neg_gamma),
        neg_delta_g2=pr.g2_prepare(neg_delta),
        ic=list(vk.ic),
        neg_gamma_g2_affine=neg_gamma,
        neg_delta_g2_affine=neg_delta,
    )


def verify_proof(pvk: PreparedVerifyingKey, proof: Proof,
                 public_inputs: list[int]) -> bool:
    """(reference core/bellman-verifier/src/verifier.rs:32-63)"""
    if len(public_inputs) + 1 != len(pvk.ic):
        raise ValueError("malformed verifying key")
    acc = pvk.ic[0]
    for x, b in zip(public_inputs, pvk.ic[1:]):
        acc = cv.g1_add(acc, cv.g1_mul(b, x))
    f = pr.miller_loop(
        [
            (proof.a, proof.b),
            (acc, pvk.neg_gamma_g2),
            (proof.c, pvk.neg_delta_g2),
        ]
    )
    return pr.final_exponentiation(f) == pvk.alpha_g1_beta_g2
