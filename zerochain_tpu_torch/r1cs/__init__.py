"""R1CS constraint-system framework (bellman-compatible semantics).

The synthesis side of the framework is host Python: circuits are fixed, so
they are synthesized ONCE into sparse A/B/C matrices; per-proof witness
generation is then a flat, compiled computation (see prover/).  The
recording CS mirrors bellman's `ConstraintSystem` trait semantics
(reference: core/proofs/src/circuit/test.rs:28-440) including the golden
BLAKE2s constraint-system hash.
"""

from .system import (
    ConstraintSystem,
    LinearCombination,
    SynthesisError,
    Variable,
    ONE,
)
from . import boolean, num, ecc
