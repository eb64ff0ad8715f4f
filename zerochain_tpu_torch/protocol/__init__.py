"""Zerochain protocol layer: keys and ElGamal (host Python, off the hot
path).  Mirrors the reference's no_std_aliases/{keys,elgamal}.rs."""

from .keys import (  # noqa: F401
    SpendingKey,
    ProofGenerationKey,
    DecryptionKey,
    EncryptionKey,
)
from .elgamal import Ciphertext, elgamal_extend  # noqa: F401
