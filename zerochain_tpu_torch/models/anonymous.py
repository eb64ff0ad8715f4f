"""AnonymousTransfer circuit (reference anonymous_transfer.rs + anonimity_set.rs).

Statement (anonymous_transfer.rs:1-16): transfer among ANONIMITY_SIZE=12
keys (sender + recipient + 10 decoys) with one-hot selectors s (sender) and
t (recipient):
  * amount checks over t-fold, (s xor t)-fold and (nor)-conditioned pairs
  * randomness check D = r*G
  * balance check against the s-fold of (C_li + C_i)
  * secret key check  sk*G = Σ s_i y_i
  * nonce + spend-authority as in the confidential circuit

105 public inputs incl. ONE (12x2 enc keys, 12x2 amount lefts, 12x2 balance
lefts, 12x2 balance rights, right ct, rvk, g_epoch, nonce).  NOTE: faithful
to the reference, the one-hot sums Σs_i = 1 / Σt_i = 1 documented in its
header are NOT enforced as constraints (anonimity_set.rs:34-70 allocates
plain booleans only); we reproduce the circuit as implemented.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..mirror import jubjub as jj
from ..r1cs.boolean import (
    AllocatedBit,
    Boolean,
    field_into_boolean_vec_le,
    u32_into_bit_vec_le,
)
from ..r1cs.ecc import EdwardsPoint, fixed_base_multiplication
from ..r1cs import utils as cutils
from ..r1cs.system import ConstraintSystem

ANONIMITY_SIZE = 12  # reference core/proofs/src/constants.rs:1
DECOY_SIZE = ANONIMITY_SIZE - 2

GENERATOR_INDEX = jj.NOTE_COMMITMENT_RANDOMNESS


class Binary:
    """One-hot selector gadget (anonimity_set.rs:31-192)."""

    def __init__(self, booleans):
        self.bools = booleans

    @classmethod
    def new(cls, cs, st: str, index):
        acc = []
        for i in range(ANONIMITY_SIZE):
            val = None if index is None else (i == index)
            with cs.namespace(f"{st} binary {i}"):
                acc.append(Boolean.from_bit(AllocatedBit.alloc(cs, val)))
        return cls(acc)

    def nor(self, cs, other: "Binary") -> "Binary":
        acc = []
        for i in range(ANONIMITY_SIZE):
            with cs.namespace(f"{i} nor binary"):
                acc.append(
                    Boolean.and_(cs, self.bools[i].not_(), other.bools[i].not_())
                )
        return Binary(acc)

    def xor(self, cs, other: "Binary") -> "Binary":
        acc = []
        for i in range(ANONIMITY_SIZE):
            with cs.namespace(f"{i} xor binary"):
                acc.append(Boolean.xor(cs, self.bools[i], other.bools[i]))
        return Binary(acc)

    def conditionally_equals(self, cs, a_points, b_points):
        for i, (a, b) in enumerate(zip(a_points, b_points)):
            with cs.namespace(f"conditionally select a_{i}"):
                c_a = a.conditionally_select(cs, self.bools[i])
            with cs.namespace(f"conditionally select b_{i}"):
                c_b = b.conditionally_select(cs, self.bools[i])
            with cs.namespace(f"equal ca_{i} and cb"):
                cutils.eq_edwards_points(cs, c_a, c_b)

    def edwards_add_fold(self, cs, points, zero_p: EdwardsPoint):
        acc = zero_p
        for i, (b, p) in enumerate(zip(self.bools, points)):
            with cs.namespace(f"conditionally select p_{i} depending on b"):
                sel = p.conditionally_select(cs, b)
            with cs.namespace(f"add conditionally selected p_{i}"):
                acc = acc.add(cs, sel)
        return acc


def _witness_points(cs, points, count, ns_fmt):
    out = []
    for i in range(count):
        p = None if points is None else points[i]
        with cs.namespace(ns_fmt.format(i)):
            out.append(EdwardsPoint.witness(cs, p))
    return out


def _inputize_points(cs, points, ns_fmt):
    for i, p in enumerate(points):
        with cs.namespace(ns_fmt.format(i)):
            p.inputize(cs)


@dataclass
class AnonymousTransfer:
    amount: int | None = None
    remaining_balance: int | None = None
    s_index: int | None = None
    t_index: int | None = None
    randomness: int | None = None  # Fs
    alpha: int | None = None  # Fs
    proof_generation_key: tuple | None = None
    dec_key: int | None = None
    enc_keys: list | None = None  # 12 affine points
    left_ciphertexts: list | None = None  # 12 affine points
    right_ciphertext: tuple | None = None
    enc_balances: list | None = None  # 12 (left, right) point pairs
    g_epoch: tuple | None = None

    def synthesize(self, cs: ConstraintSystem):
        with cs.namespace("initialize acc."):
            zero_p = EdwardsPoint.witness(cs, jj.ZERO)

        with cs.namespace("range proof of amount"):
            amount_bits = u32_into_bit_vec_le(cs, self.amount)
        with cs.namespace("compute the amount in the exponent"):
            amount_g = fixed_base_multiplication(cs, GENERATOR_INDEX, amount_bits)

        with cs.namespace("range proof of remaining_balance"):
            remaining_bits = u32_into_bit_vec_le(cs, self.remaining_balance)
        with cs.namespace("compute the remaining balance in the exponent"):
            remaining_balance_g = fixed_base_multiplication(
                cs, GENERATOR_INDEX, remaining_bits
            )

        with cs.namespace("dec_key"):
            dec_key_bits = field_into_boolean_vec_le(cs, self.dec_key)

        with cs.namespace("new s binary"):
            s_bins = Binary.new(cs, "s", self.s_index)
        with cs.namespace("new t binary"):
            t_bins = Binary.new(cs, "t", self.t_index)

        with cs.namespace("push enckeys"):
            enc_key_set = _witness_points(
                cs, self.enc_keys, ANONIMITY_SIZE, "{} enc_key witness"
            )

        with cs.namespace("add folded enc keys"):
            expected_enc_key_sender = s_bins.edwards_add_fold(
                cs, enc_key_set, zero_p
            )

        with cs.namespace("compute enc_key_sender"):
            enc_key_sender = fixed_base_multiplication(
                cs, GENERATOR_INDEX, dec_key_bits
            )

        with cs.namespace("equal enc_key_sender"):
            cutils.eq_edwards_points(cs, expected_enc_key_sender, enc_key_sender)

        # Σ r * y_i  (anonimity_set.rs:234-261)
        with cs.namespace("generate enc keys multipled by randomness"):
            with cs.namespace("randomness_bits"):
                randomness_bits_a = field_into_boolean_vec_le(cs, self.randomness)
            enc_keys_mul_random = []
            for i in range(ANONIMITY_SIZE):
                with cs.namespace(f"randomness mul enc_key_{i}"):
                    enc_keys_mul_random.append(
                        enc_key_set[i].mul(cs, randomness_bits_a)
                    )

        with cs.namespace("ciphertext_left_set"):
            ciphertext_left_set = _witness_points(
                cs, self.left_ciphertexts, ANONIMITY_SIZE, "witness lc {}"
            )

        with cs.namespace("add folded enc keys mul random"):
            enc_keys_random_fold_t = t_bins.edwards_add_fold(
                cs, enc_keys_mul_random, zero_p
            )
        with cs.namespace("compute ciphertext left t_i"):
            expected_ct_left_t = enc_keys_random_fold_t.add(cs, amount_g)
        with cs.namespace("add folded left ciphertext based in t_i"):
            ct_left_t = t_bins.edwards_add_fold(cs, ciphertext_left_set, zero_p)
        with cs.namespace("left ciphertext equals based in t_i"):
            cutils.eq_edwards_points(cs, expected_ct_left_t, ct_left_t)

        with cs.namespace("s_i xor t_i"):
            xor_st = s_bins.xor(cs, t_bins)
        with cs.namespace("add folded randomized enc keys based in (s_i xor t_i)"):
            rand_fold_xor = xor_st.edwards_add_fold(
                cs, enc_keys_mul_random, zero_p
            )
        with cs.namespace("add folded left ciphertext based in (s_i xor t_i)"):
            ct_left_xor = xor_st.edwards_add_fold(cs, ciphertext_left_set, zero_p)
        with cs.namespace("left ciphertext equals based in (s_i xor t_i)"):
            cutils.eq_edwards_points(cs, ct_left_xor, rand_fold_xor)

        with cs.namespace("s_i nor t_i"):
            nor_st = s_bins.nor(cs, t_bins)
        with cs.namespace("equal a and b in nor st"):
            nor_st.conditionally_equals(
                cs, ciphertext_left_set, enc_keys_mul_random
            )

        with cs.namespace("inputize enc key set"):
            _inputize_points(cs, enc_key_set, "inputize enc keys {}")
        with cs.namespace("inputize ciphertext left set"):
            _inputize_points(
                cs, ciphertext_left_set, "inputize left ciphertexts {}"
            )

        # balance integrity
        lefts = (
            None
            if self.enc_balances is None
            else [b[0] for b in self.enc_balances]
        )
        rights = (
            None
            if self.enc_balances is None
            else [b[1] for b in self.enc_balances]
        )
        with cs.namespace("left balance ciphertexts witness"):
            left_balance = _witness_points(
                cs, lefts, ANONIMITY_SIZE, "left ciphertext {} witness"
            )
        with cs.namespace("add each with left amount ciphertexts"):
            added_lefts = []
            for i in range(ANONIMITY_SIZE):
                with cs.namespace(f"add each left ciphertexts {i}"):
                    added_lefts.append(
                        left_balance[i].add(cs, ciphertext_left_set[i])
                    )
        with cs.namespace("Add folded C_l minus C"):
            lh_c = s_bins.edwards_add_fold(cs, added_lefts, zero_p)

        with cs.namespace("right balance ciphertexts witness"):
            right_balance = _witness_points(
                cs, rights, ANONIMITY_SIZE, "right ciphertext {} witness"
            )
        with cs.namespace("add folded right balance ciphertexts"):
            right_fold = s_bins.edwards_add_fold(cs, right_balance, zero_p)

        with cs.namespace("randomness_bits"):
            randomness_bits = field_into_boolean_vec_le(cs, self.randomness)
        with cs.namespace("compute the right elgamal component"):
            right_ciphertext = fixed_base_multiplication(
                cs, GENERATOR_INDEX, randomness_bits
            )
        with cs.namespace("amount minus balance ciphertext"):
            cr_minus_d = right_fold.add(cs, right_ciphertext)
        with cs.namespace("cr_minus_d mul sk"):
            cr_minus_d_mul_sk = cr_minus_d.mul(cs, dec_key_bits)
        with cs.namespace("rb_g adds cr_minus_d_mul_sk"):
            rh_c = remaining_balance_g.add(cs, cr_minus_d_mul_sk)
        with cs.namespace("rl_c equals to rh_c"):
            cutils.eq_edwards_points(cs, lh_c, rh_c)

        with cs.namespace("inputize left balance ciphertext"):
            _inputize_points(
                cs, left_balance, "inputize left balance ciphertexts {}"
            )
        with cs.namespace("inputize right balance ciphertext"):
            _inputize_points(
                cs, right_balance, "inputize right balance ciphertexts {}"
            )
        with cs.namespace("inputize right amount ciphertext."):
            right_ciphertext.inputize(cs)

        with cs.namespace("inputize rvk"):
            cutils.rvk_inputize(
                cs, self.proof_generation_key, self.alpha, GENERATOR_INDEX
            )
        with cs.namespace("inputize g_epoch and nonce"):
            cutils.g_epoch_nonce_inputize(cs, self.g_epoch, dec_key_bits)
