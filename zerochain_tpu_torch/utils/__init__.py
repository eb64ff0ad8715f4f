"""Cross-cutting utilities (profiling/observability)."""
