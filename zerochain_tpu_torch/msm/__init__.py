"""Multi-scalar multiplication: fixed-base (CRS generation) and the
suffix-sum variable-base MSM (kernel in ``cuda_scan``)."""

from . import pippenger, cuda_scan, suffix  # noqa: F401
