"""PyTorch + CUDA port of the locality-aware scheduler, for NVIDIA Hopper.

The JAX package ``repro`` is the reference this package is held
against; ``repro_torch`` imports nothing of it (and no ``jax``), keeping
its own copies of the host modules it needs under the same relative
paths.  It runs the paper's online scheduler (WF and RD) and serves the
dense transformer family:

- ``core`` — problem instances, host WF and RD (the oracles), OCWF
  orderings, and ``wf_torch`` / ``rd_torch``: WF and RD on the card;
- ``kernels`` — the hand-written CUDA kernels (water level, RD strip,
  RMSNorm, decode and flash attention), their wrappers, plain PyTorch
  versions and launch counts;
- ``models`` / ``configs`` — the dense model (init, prefill, decode) and
  its architectures;
- ``serve`` / ``launch`` — continuous-batching serving with WF replica
  routing, and its command-line driver;
- ``runtime`` — the slot-stepped scheduling engine, cluster state and
  policies;
- ``traces`` — the ``alibaba`` and ``bursty`` job traces;
- ``backend`` — route and device scopes (entry points run on ``cuda``
  unless a ``set_backend(device="cpu")`` scope asks for the CPU);
- ``convert`` — carries the reference's jobs, problems and model
  parameters over.
"""
