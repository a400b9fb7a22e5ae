"""Observability of the port: the wall clock and the metrics registry.

The reference's session, trace and report modules belong to a later
slice; nothing the port schedules depends on them.
"""
