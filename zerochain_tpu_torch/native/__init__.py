"""Native (C) host-runtime components.

The device compute path is PyTorch over the CUDA kernels of ``csrc/``; the
host runtime around it (data marshaling between bigints and tensor layouts)
is C, compiled by cc on first use and loaded through ctypes.  Falls back to
NumPy if no compiler is available (``native_available()`` is then False).
"""

from .codec import (
    native_available,
    scalars_to_bits_np,
    scalars_to_limbs_np,
    limbs_to_scalars,
)
