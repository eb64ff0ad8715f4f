"""Client wallet: HD key derivation, encrypted keystore, SS58 addresses.

Mirrors zface's wallet stack (zface/src/derive/, wallet/, ss58.rs)."""

from .derive import (
    ChildIndex,
    ExtendedSpendingKey,
    ExtendedProofGenerationKey,
)
from .keystore import KeyFile, Wallet
from .ss58 import encode_ss58, decode_ss58
