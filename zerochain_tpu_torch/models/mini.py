"""MiniCommit: a tiny fixture circuit for default-suite pipeline tests.

Proves knowledge of a u32 `amount` whose strict range decomposition
(range_check.rs:11-196 semantics) exponentiates the NoteCommitmentRandomness
base to a public point — i.e. the `amount_g` fragment of the
ConfidentialTransfer circuit (confidential_transfer.rs:70-83) in isolation.
Small enough (~150 constraints, domain 256) that the full device proving
pipeline (witness -> matvec -> NTT -> MSMs -> assembly) compiles in the
default CPU test suite, playing the role of the reference's DummyEngine
small-scale logic tests (core/bellman-verifier/src/tests/dummy_engine.rs).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..mirror import jubjub as jj
from ..r1cs.boolean import u32_into_bit_vec_le
from ..r1cs.ecc import fixed_base_multiplication
from ..r1cs.system import ConstraintSystem

GENERATOR_INDEX = jj.NOTE_COMMITMENT_RANDOMNESS


@dataclass
class MiniCommit:
    amount: int | None = None

    def synthesize(self, cs: ConstraintSystem):
        with cs.namespace("range proof of amount"):
            bits = u32_into_bit_vec_le(cs, self.amount)
        with cs.namespace("compute the amount in the exponent"):
            g = fixed_base_multiplication(cs, GENERATOR_INDEX, bits)
        with cs.namespace("inputize amount_g"):
            g.inputize(cs)
