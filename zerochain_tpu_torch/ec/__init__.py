"""Batched curve group ops: G1/G2 (Jacobian, kernels in ``cuda_ec``) and
Jubjub (extended twisted Edwards)."""

from . import fields, cuda_ec, weierstrass, g1, g2  # noqa: F401
