"""On-chain runtime state machine (reference modules/ + runtime/).

Python re-implementation of the Substrate modules' semantics: storage maps
are dicts, dispatchables are methods, events are appended to a list.  The
consensus/networking host (Substrate node, libp2p, Aura) is out of scope
(SURVEY.md §7); this layer reproduces the state-transition logic the chain
executes, so end-to-end tests can drive real proofs through the verifier
exactly like the reference's `test_call_from_zface`
(modules/encrypted-balances/src/lib.rs:372-436).
"""

from .primitives import (
    EncKey,
    LeftCiphertext,
    RightCiphertext,
    CiphertextBytes,
    ProofBytes,
    Nonce,
    GEpochBytes,
    SigVerificationKey,
)
from .zk_system import ZkSystem
from .encrypted_balances import EncryptedBalances
from .encrypted_assets import EncryptedAssets
from .anonymous_balances import AnonymousBalances
from .chain import Runtime
