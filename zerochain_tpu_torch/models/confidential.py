"""ConfidentialTransfer circuit.

Statement (reference core/proofs/src/circuit/confidential_transfer.rs:61-304):
  * amount / remaining_balance / fee are u32 (strict range proofs)
  * enc_key_sender = dec_key * G recomputed in-circuit and inputized
  * recipient enc_key is on-curve and not small order
  * ElGamal ciphertext correctness for amount & fee under both keys
  * balance-consistency equation (confidential_transfer.rs:194-198)
  * spend authority rvk = pgk + alpha*G (utils.rs:71-124)
  * epoch nonce = dec_key * g_epoch (utils.rs:126-154)

Public input layout (23 incl. ONE; confidential_transfer.rs:386-409):
  0 ONE | 1,2 enc_key_sender | 3,4 enc_key_recipient | 5,6 c_left_sender
  | 7,8 c_left_recipient | 9,10 c_right | 11,12 f_left_sender
  | 13,14 enc_balance_left | 15,16 enc_balance_right | 17,18 rvk
  | 19,20 g_epoch | 21,22 nonce
"""

from __future__ import annotations

from dataclasses import dataclass

from ..mirror import jubjub as jj
from ..r1cs.system import ConstraintSystem
from ..r1cs.boolean import field_into_boolean_vec_le, u32_into_bit_vec_le
from ..r1cs.ecc import EdwardsPoint, fixed_base_multiplication
from ..r1cs import utils as cutils

GENERATOR_INDEX = jj.NOTE_COMMITMENT_RANDOMNESS


@dataclass
class ConfidentialTransfer:
    """Witness container; all fields None for setup-mode synthesis.

    Points are affine (x, y) tuples on Jubjub; scalars are ints (Fs)."""

    amount: int | None = None
    remaining_balance: int | None = None
    randomness: int | None = None  # Fs
    alpha: int | None = None  # Fs
    proof_generation_key: tuple | None = None  # point
    dec_key_sender: int | None = None  # Fs
    enc_key_recipient: tuple | None = None  # point
    encrypted_balance: tuple | None = None  # (left point, right point)
    fee: int | None = None
    g_epoch: tuple | None = None  # point

    def synthesize(self, cs: ConstraintSystem):
        with cs.namespace("range proof of amount"):
            amount_bits = u32_into_bit_vec_le(cs, self.amount)
        with cs.namespace("range proof of remaining_balance"):
            remaining_balance_bits = u32_into_bit_vec_le(cs, self.remaining_balance)
        with cs.namespace("range proof of fee"):
            fee_bits = u32_into_bit_vec_le(cs, self.fee)

        with cs.namespace("dec_key_sender"):
            dec_key_bits = field_into_boolean_vec_le(cs, self.dec_key_sender)

        with cs.namespace("compute enc_key_sender"):
            enc_key_sender = fixed_base_multiplication(
                cs, GENERATOR_INDEX, dec_key_bits
            )
        with cs.namespace("inputize enc_key_sender"):
            enc_key_sender.inputize(cs)

        with cs.namespace("compute the amount in the exponent"):
            amount_g = fixed_base_multiplication(cs, GENERATOR_INDEX, amount_bits)
        with cs.namespace("compute the fee in the exponent"):
            fee_g = fixed_base_multiplication(cs, GENERATOR_INDEX, fee_bits)

        with cs.namespace("randomness_bits"):
            randomness_bits = field_into_boolean_vec_le(cs, self.randomness)

        with cs.namespace("compute sender amount cipher"):
            val_rls = enc_key_sender.mul(cs, randomness_bits)

        with cs.namespace("recipient enc_key witness"):
            enc_key_recipient = EdwardsPoint.witness(cs, self.enc_key_recipient)
        with cs.namespace("val_gl not small order"):
            enc_key_recipient.assert_not_small_order(cs)

        with cs.namespace("compute recipient amount cipher"):
            val_rlr = enc_key_recipient.mul(cs, randomness_bits)

        with cs.namespace("inputize enc_key_recipient"):
            enc_key_recipient.inputize(cs)

        with cs.namespace("computation of sender's c_left"):
            c_left_sender = amount_g.add(cs, val_rls)
        with cs.namespace("computation of recipient's c_left"):
            c_left_recipient = amount_g.add(cs, val_rlr)
        with cs.namespace("compute the right elgamal component"):
            c_right = fixed_base_multiplication(cs, GENERATOR_INDEX, randomness_bits)
        with cs.namespace("computation of sender's f_left"):
            f_left_sender = fee_g.add(cs, val_rls)

        with cs.namespace("c_left_sender"):
            c_left_sender.inputize(cs)
        with cs.namespace("c_left_recipient"):
            c_left_recipient.inputize(cs)
        with cs.namespace("c_right"):
            c_right.inputize(cs)
        with cs.namespace("f_left_sender"):
            f_left_sender.inputize(cs)

        # Balance encryption validity (confidential_transfer.rs:191-287):
        # enc_balance.left + 2 * dec_key * c_right
        #   == amount_g_cipher.left + remaining_balance*G
        #      + dec_key * enc_balance.right + fee_cipher.left
        enc_bal = self.encrypted_balance
        with cs.namespace("encrypted balance left"):
            enc_balance_left = EdwardsPoint.witness(
                cs, None if enc_bal is None else enc_bal[0]
            )
        with cs.namespace("encrypted balance right"):
            enc_balance_right = EdwardsPoint.witness(
                cs, None if enc_bal is None else enc_bal[1]
            )
        with cs.namespace("enc_balance_left isn't small order"):
            enc_balance_left.assert_not_small_order(cs)
        with cs.namespace("enc_balance_right isn't small order"):
            enc_balance_right.assert_not_small_order(cs)

        with cs.namespace("c_right mul by dec_key_sender"):
            dec_key_sender_random = c_right.mul(cs, dec_key_bits)
        with cs.namespace("enc_balance_left add dec_key_sender_pointl"):
            balance_dec_key_sender_random = enc_balance_left.add(
                cs, dec_key_sender_random
            )
        with cs.namespace("pointl readd dec_key_sender_pointl"):
            bi_left = balance_dec_key_sender_random.add(cs, dec_key_sender_random)

        with cs.namespace("c_right_sender mul by dec_key_sender"):
            dec_key_sender_pointr = enc_balance_right.mul(cs, dec_key_bits)
        with cs.namespace("compute the remaining balance in the exponent"):
            rem_bal_g = fixed_base_multiplication(
                cs, GENERATOR_INDEX, remaining_balance_bits
            )
        with cs.namespace("c_left_sender add rem_bal_g"):
            val_rem_bal = c_left_sender.add(cs, rem_bal_g)
        with cs.namespace("val_rem_bal add "):
            val_rem_bal_balr = val_rem_bal.add(cs, dec_key_sender_pointr)
        with cs.namespace("f_left_sender add"):
            bi_right = f_left_sender.add(cs, val_rem_bal_balr)

        with cs.namespace("equal two edwards poinsts"):
            cutils.eq_edwards_points(cs, bi_left, bi_right)

        with cs.namespace("inputize enc_balance_left"):
            enc_balance_left.inputize(cs)
        with cs.namespace("inputize enc_balance_right"):
            enc_balance_right.inputize(cs)

        with cs.namespace("inputize rvk"):
            cutils.rvk_inputize(
                cs, self.proof_generation_key, self.alpha, GENERATOR_INDEX
            )

        with cs.namespace("inputize g_epoch and nonce"):
            cutils.g_epoch_nonce_inputize(cs, self.g_epoch, dec_key_bits)
