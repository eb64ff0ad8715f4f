"""Transaction building: proof drivers + signed extrinsic assembly.

Mirrors the reference's prover-host layer (core/proofs/src/
{crypto_components.rs,confidential.rs,anonymous.rs} + zface tx commands):
KeyContext holds a proving/verifying key pair, gen_proof synthesizes a
witness, proves, locally verifies, and packages the on-chain call bytes.
"""

from .builder import (
    KeyContext,
    ConfidentialXt,
    AnonymousXt,
    build_confidential_xt,
    build_anonymous_xt,
)
