"""The zk-SNARK circuits.

- ``confidential``: ConfidentialTransfer, 19,974 constraints, 23 public
  inputs (reference core/proofs/src/circuit/confidential_transfer.rs).
- ``mini``: MiniCommit, a small fixture circuit for pipeline tests.
"""

from .confidential import ConfidentialTransfer  # noqa: F401
from .mini import MiniCommit  # noqa: F401
