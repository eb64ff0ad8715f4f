"""Witness synthesis and the end-to-end proving pipeline (the counterpart
of ``zerochain_tpu.prover_tpu``)."""

from .pipeline import ConfidentialProver, MiniProver  # noqa: F401
