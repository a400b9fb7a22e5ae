"""Observability of the port; this slice carries only the wall clock."""
