"""PyTorch + CUDA port of the locality-aware scheduler, for NVIDIA Hopper.

The JAX package ``repro`` is the reference this package is held
against; ``repro_torch`` imports nothing of it (and no ``jax``), keeping
its own copies of the host modules it needs under the same relative
paths.  It runs the paper's online scheduler (WF and RD) and serves the
dense transformer family and the Mamba2 family (Mamba2, and the Zamba2
hybrid):

- ``core`` — problem instances, host WF and RD (the oracles), OCWF
  orderings, and ``wf_torch`` / ``rd_torch``: WF and RD on the card;
- ``kernels`` — the hand-written CUDA kernels (water level, RD strip,
  RMSNorm, decode and flash attention, the SSD chunk scan), their
  wrappers, plain PyTorch versions and launch counts;
- ``models`` / ``configs`` — the dense, mamba2 and zamba2 models (init,
  prefill, decode) and their architectures;
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
