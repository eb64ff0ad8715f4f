"""Radix-2 NTT over Fr."""

from .ntt import NttPlan, plan_for  # noqa: F401
