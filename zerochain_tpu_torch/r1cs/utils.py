"""Shared circuit helpers (reference core/proofs/src/circuit/utils.rs)."""

from __future__ import annotations

from ..mirror import jubjub as jj
from ..mirror.field import R
from .system import ConstraintSystem, ONE
from .boolean import field_into_boolean_vec_le
from .ecc import EdwardsPoint, fixed_base_multiplication
from .num import AllocatedNum


def eq_edwards_points(cs, a: EdwardsPoint, b: EdwardsPoint):
    """Enforce a == b coordinate-wise (utils.rs:10-37)."""
    cs.enforce("equal x nums", [(a.x.var, 1)], [(ONE, 1)], [(b.x.var, 1)])
    cs.enforce("equal y nums", [(a.y.var, 1)], [(ONE, 1)], [(b.y.var, 1)])


def negate_point(cs, point: EdwardsPoint) -> EdwardsPoint:
    """Allocate -P and prove it is on the curve (utils.rs:39-68)."""
    with cs.namespace("negate x"):
        neg_x = AllocatedNum.alloc(
            cs, None if point.x.value is None else (R - point.x.value) % R
        )
    with cs.namespace("interpret negate point"):
        return EdwardsPoint.interpret(cs, neg_x, point.y)


def rvk_inputize(cs, proof_gen_key, alpha, generator_index):
    """Prove rvk = pgk + alpha*G and inputize it (utils.rs:71-124)."""
    with cs.namespace("pgk"):
        pgk = EdwardsPoint.witness(cs, proof_gen_key)
    with cs.namespace("pgk not small order"):
        pgk.assert_not_small_order(cs)
    with cs.namespace("alpha"):
        alpha_bits = field_into_boolean_vec_le(cs, alpha)
    with cs.namespace("computation of randomiation for the signing key"):
        alpha_g = fixed_base_multiplication(cs, generator_index, alpha_bits)
    with cs.namespace("computation of rvk"):
        rvk = pgk.add(cs, alpha_g)
    with cs.namespace("rvk not small order"):
        rvk.assert_not_small_order(cs)
    with cs.namespace("rvk"):
        rvk.inputize(cs)


def g_epoch_nonce_inputize(cs, g_epoch, dec_key_bits):
    """Prove nonce = dec_key * g_epoch; inputize both (utils.rs:126-154)."""
    with cs.namespace("g_epoch"):
        g_epoch_pt = EdwardsPoint.witness(cs, g_epoch)
    with cs.namespace("g_epoch mul by dec_key"):
        nonce = g_epoch_pt.mul(cs, dec_key_bits)
    with cs.namespace("inputize g_epoch"):
        g_epoch_pt.inputize(cs)
    with cs.namespace("inputize nonce"):
        nonce.inputize(cs)
