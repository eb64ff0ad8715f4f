"""Radix-2 NTT over Fr."""

from .ntt import NttPlan, plan_for, quotient  # noqa: F401
