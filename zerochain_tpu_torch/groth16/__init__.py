"""Groth16 zk-SNARK: setup, host prover, verifier, byte-compatible
serialization (the algorithms of the bellman fork the reference uses)."""

from .core import (  # noqa: F401
    Parameters,
    VerifyingKey,
    PreparedVerifyingKey,
    Proof,
    generate_parameters,
    generate_random_parameters,
    create_proof,
    create_random_proof,
    prepare_verifying_key,
    verify_proof,
)
from . import serialization  # noqa: F401
