"""The zk-SNARK circuits.

- ``confidential``: ConfidentialTransfer, 19,974 constraints, 23 public
  inputs (reference core/proofs/src/circuit/confidential_transfer.rs).
- ``anonymous``: AnonymousTransfer, 50,514 constraints, 105 public inputs:
  a transfer hidden in an anonymity set of 12 keys (reference
  core/proofs/src/circuit/anonymous_transfer.rs).
- ``mini``: MiniCommit, a small fixture circuit for pipeline tests.
"""

from .anonymous import AnonymousTransfer  # noqa: F401
from .confidential import ConfidentialTransfer  # noqa: F401
from .mini import MiniCommit  # noqa: F401
