"""Zerochain protocol layer: keys, ElGamal and RedDSA (host Python, off the
hot path; the batch verifier's device path is ``redjubjub_device``, which
is not imported here, so that the package imports without torch).  Mirrors the
reference's no_std_aliases/{keys,elgamal}.rs and core/jubjub/src/redjubjub.rs."""

from .keys import (  # noqa: F401
    SpendingKey,
    ProofGenerationKey,
    DecryptionKey,
    EncryptionKey,
)
from .elgamal import Ciphertext, elgamal_extend  # noqa: F401
from . import redjubjub  # noqa: F401
