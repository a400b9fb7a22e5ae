"""PyTorch + CUDA port of the locality-aware scheduler, for NVIDIA Hopper.

The JAX package ``repro`` is the reference this package is held
against; ``repro_torch`` imports nothing of it (and no ``jax``), keeping
its own copies of the host modules it needs under the same relative
paths.  This slice runs the paper's online water-filling scheduler:

- ``core`` — problem instances, host WF (the oracle), OCWF orderings,
  and ``wf_torch``: WF with the water level on the card;
- ``kernels`` — the hand-written CUDA water-level kernel, its wrapper,
  its plain PyTorch version and its launch counts;
- ``runtime`` — the slot-stepped scheduling engine, cluster state and
  policies;
- ``traces`` — the ``alibaba`` and ``bursty`` job traces;
- ``backend`` — route and device scopes (entry points run on ``cuda``
  unless a ``set_backend(device="cpu")`` scope asks for the CPU);
- ``convert`` — carries the reference's jobs and problems over.
"""
