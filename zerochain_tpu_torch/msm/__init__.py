"""Multi-scalar multiplication: fixed-base (CRS generation), the bucket MSM
(kernels ``bucket_sums`` and ``bucket_fold`` in ``ec/cuda_ec``) and the
suffix-sum variable-base MSM (kernels ``window_totals`` and ``split_tail``
in ``cuda_scan``)."""

from . import pippenger, scans, cuda_scan, suffix  # noqa: F401
