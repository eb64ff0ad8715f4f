"""Diagnostic scripts that run on a CUDA card."""
