"""Witness synthesis, the end-to-end proving pipeline and the Groth16
backend (the counterpart of ``zerochain_tpu.prover_tpu``)."""

from .backend import TorchBackend  # noqa: F401
from .pipeline import AnonymousProver, ConfidentialProver, MiniProver  # noqa: F401
