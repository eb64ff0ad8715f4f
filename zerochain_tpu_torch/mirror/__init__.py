"""Pure-Python bigint mirror of the cryptographic stack.

This package is the *oracle*: a slow, obviously-correct implementation of
every primitive with bit-exact parity to the reference Rust stack
(core/pairing, core/jubjub, core/crypto, external bellman fork). Every
tensor kernel in the sibling packages is tested against this mirror.

It is also the execution path for cold operations (pairings during
verification, trusted setup toxic-waste sampling, key derivation) where
device throughput is irrelevant.
"""

from . import field, curves, jubjub, pairing  # noqa: F401
