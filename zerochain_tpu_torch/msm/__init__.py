"""Multi-scalar multiplication: fixed-base (CRS generation), the bucket MSM
(kernel ``hs_add_select`` in ``ec/cuda_ec``) and the suffix-sum
variable-base MSM (kernels in ``cuda_scan``)."""

from . import pippenger, scans, cuda_scan, suffix  # noqa: F401
