"""Analysis layer of the port: the runtime sanitizers.

:mod:`repro_torch.analysis.runtime` is the port's copy of the
reference's sanitizers (the global toggle, the event-heap check and
:class:`~repro_torch.analysis.runtime.BufferGuard`).  The static linter
is the reference's ``repro.analysis``, which lints both packages; the
kernel contracts (``analysis/contracts.py``) belong to a later slice.
"""
