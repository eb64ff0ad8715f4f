"""Batched prime-field arithmetic on 32-bit words (Fq, Fr, Fs)."""

from .limbs import FQ, FR, FS, FieldSpec  # noqa: F401
from . import cuda_ff, limbs  # noqa: F401
