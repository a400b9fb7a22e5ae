"""Analysis layer of the port: runtime sanitizers and kernel contracts.

- :mod:`repro_torch.analysis.runtime` — the port's copy of the
  reference's sanitizers (the global toggle, the event-heap check and
  :class:`~repro_torch.analysis.runtime.BufferGuard`, armed by
  ``ServeEngine(debug=True)``);
- :mod:`repro_torch.analysis.contracts` — the geometry-contract
  registry: the CUDA kernels' wrappers and the ``wf_torch``/``rd_torch``
  adapters declare their admissible lattice, the shared memory and
  threads of one block, overflow envelopes and kernel-variant
  signatures via :func:`~repro_torch.analysis.contracts.contract`;
- :mod:`repro_torch.analysis.kernelcheck` — the verifier behind
  ``python -m repro_torch.analysis.kernelcheck``: sweeps each contract's
  boundary lattice and proves memory / range / coverage / variant-surface
  properties without a card.

The static linter is the reference's ``repro.analysis``, which lints both
packages.  Importing this package stays stdlib-only.
"""

from .contracts import CONTRACTS, Axis, BlockConfig, Interval, KernelContract, RangeClaim, contract

__all__ = [
    "Axis",
    "BlockConfig",
    "CONTRACTS",
    "Interval",
    "KernelContract",
    "RangeClaim",
    "contract",
]
