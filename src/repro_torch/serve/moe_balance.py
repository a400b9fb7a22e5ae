"""WF-balanced MoE expert-replica routing (the paper's technique on the card).

The port of ``repro/serve/moe_balance.py``.  Mapping:

  expert replicas across devices  ↔  data-chunk replicas across servers
  token groups sharing an expert  ↔  task groups ``T_c^k``
  per-device queued tokens        ↔  busy times ``b_m^c``
  device token throughput         ↔  capacities ``μ_m^c``

:func:`balance_expert_replicas` runs the K-group water-filling
(:func:`repro_torch.core.wf_torch.water_fill_groups`, one expert a
group) to pick, for each expert's token load, how many tokens each
replica-holding device takes — minimizing the max device queue, i.e. the
step's completion time.  On the card that is one launch of the fused
water-filling kernel a call, whatever the expert count; on the CPU its
plain loop.
"""

from __future__ import annotations

import torch

from ..core.wf_torch import water_fill_groups

__all__ = ["balance_expert_replicas", "replica_placement"]


def replica_placement(
    n_experts: int, n_devices: int, replicas: int, *, generator: torch.Generator
) -> torch.Tensor:
    """(E, R) int64 device ids, replica r of expert e: a shuffled
    round-robin drawn from ``generator``, so co-located experts differ
    across devices.  (The reference draws with ``jax.random``, whose
    stream torch cannot reproduce: to compare the two, pass the
    reference's placement to :func:`balance_expert_replicas`.)"""
    perm = torch.randperm(n_experts * replicas, generator=generator) % n_devices
    return perm.reshape(n_experts, replicas)


def balance_expert_replicas(
    expert_load: torch.Tensor,  # (E,) tokens routed to each expert this step
    placement: torch.Tensor,  # (E, R) device holding each replica
    device_queue: torch.Tensor,  # (D,) tokens already queued per device
    device_rate: torch.Tensor,  # (D,) tokens/step each device absorbs
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split each expert's load across its replicas by water-filling.

    Returns (alloc (E, D) int32 tokens per device, Φ — the max estimated
    queue time, int32 scalar), on ``device_queue``'s device.
    """
    dev = device_queue.device
    e, r = placement.shape
    d = device_queue.shape[0]
    group_mask = torch.zeros((e, d), dtype=torch.bool, device=dev)
    group_mask[
        torch.arange(e, device=dev).repeat_interleave(r),
        placement.reshape(-1).to(device=dev, dtype=torch.long),
    ] = True
    alloc, _, phi = water_fill_groups(
        device_queue.to(torch.int32),
        device_rate.to(device=dev, dtype=torch.int32),
        group_mask,
        expert_load.to(device=dev, dtype=torch.int32),
    )
    return alloc, phi
