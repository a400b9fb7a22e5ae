"""Water-filling on torch tensors: the port of ``repro/core/wf_jax.py``.

The water level of one task group is a sort + prefix-sum + masked
ceiling division; its allocation is a prefix-sum clamp (paper eqs. 7/9
and Alg. 2).  Every group step goes through one of two routes
(:func:`repro_torch.kernels.waterlevel.resolve_waterlevel`):

- ``cuda``: the rows are padded to the kernel's lane width and handed to
  the water-level kernel's wrapper (the CUDA kernel on the card; its
  plain version for CPU tensors);
- ``torch``: the plain version on the unpadded rows, as the reference's
  jnp pipeline does.

Both give bit-identical results; everything is int32, as in the
reference.  The K-group scan and the B-job chain are Python loops over
device tensors with no host sync inside; each adapter brings its result
to the host once.  Unlike the reference, K and B are not padded to
powers of two: that padding only bounds a jit cache, and padded steps
are no-ops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import backend
from ..kernels import waterlevel as wl
from .instance import Assignment, AssignmentProblem

__all__ = [
    "water_level",
    "water_fill_alloc",
    "water_fill_groups",
    "water_fill_batch",
    "water_fill_chain",
    "water_filling_torch",
    "water_filling_torch_batch",
    "water_filling_torch_chain",
    "check_group_capacity",
]

BIG = wl.BIG
I32 = torch.int32


def _ceil_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return -(-a // b)


def _masked(
    busy: torch.Tensor, mu: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.where(mask, busy, BIG), torch.where(mask, mu, 0)


def _alloc_rows(
    b: torch.Tensor, w: torch.Tensor, demand: torch.Tensor, route: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked ``(R, M)`` rows and ``(R,)`` demands → (alloc (R, M), level
    (R,)), with the ``demand <= 0`` → minimum-available-busy rule."""
    m = b.shape[1]
    if route == "cuda":
        pad = wl.n_lanes_for(m) - m
        level, take, idx = wl.waterlevel_sorted(
            F.pad(b, (0, pad), value=BIG), F.pad(w, (0, pad)), demand
        )
    else:
        level, take, idx = wl.waterlevel_sorted_plain(b, w, demand)
    # idx permutes the padded row (pad lanes carry zero takes): scattering
    # into the padded width and slicing drops them with no host sync
    alloc = torch.zeros_like(take).scatter_(1, idx.long(), take)[:, :m]
    return alloc, torch.where(demand > 0, level, b.amin(1))


def _groups_rows(
    busy: torch.Tensor,
    mu: torch.Tensor,
    group_mask: torch.Tensor,
    demands: torch.Tensor,
    route: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The K-group scan over R independent rows: (R, M) busy/mu, (R, K, M)
    masks, (R, K) demands → (alloc (R, K, M), levels (R, K))."""
    b = busy.to(I32)
    mu = mu.to(I32)
    demands = demands.to(I32)
    allocs, levels = [], []
    for k in range(group_mask.shape[1]):
        m_k, d_k = group_mask[:, k], demands[:, k].contiguous()
        alloc_k, xi = _alloc_rows(*_masked(b, mu, m_k), d_k, route)
        raised = m_k & (d_k > 0)[:, None]
        b = torch.where(raised, torch.maximum(b, xi[:, None]), b)  # eq. 10
        allocs.append(alloc_k)
        levels.append(xi)
    return torch.stack(allocs, 1), torch.stack(levels, 1)


def _phi(levels: torch.Tensor, demands: torch.Tensor) -> torch.Tensor:
    return torch.where(demands > 0, levels, 0).amax(-1)


def water_level(
    busy: torch.Tensor,
    mu: torch.Tensor,
    mask: torch.Tensor,
    demand: torch.Tensor,
    *,
    impl: str | None = None,
) -> torch.Tensor:
    """Minimal integer ξ with ``Σ_m mask_m·max{ξ-busy_m,0}·μ_m ≥ demand``
    (scalar int32; the minimum available busy value when demand is 0).
    ``impl`` names the route (``None`` resolves it)."""
    return water_fill_alloc(busy, mu, mask, demand, impl=impl)[1]


def water_fill_alloc(
    busy: torch.Tensor,
    mu: torch.Tensor,
    mask: torch.Tensor,
    demand: torch.Tensor,
    *,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Water-level allocation of one group: (alloc (M,) int32, ξ scalar)."""
    route = wl.resolve_waterlevel(impl, busy.shape[-1])
    b, w = _masked(busy.to(I32), mu.to(I32), mask)
    demand = torch.as_tensor(demand, dtype=I32, device=busy.device).reshape(1)
    alloc, level = _alloc_rows(b[None], w[None], demand, route)
    return alloc[0], level[0]


def water_fill_groups(
    busy: torch.Tensor,
    mu: torch.Tensor,
    group_mask: torch.Tensor,
    demands: torch.Tensor,
    *,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential WF over K task groups, carrying busy levels (eq. 10).

    (M,) busy/mu, (K, M) bool masks, (K,) demands → (alloc (K, M),
    levels (K,), Φ scalar = max level over groups with demand > 0).
    """
    route = wl.resolve_waterlevel(impl, busy.shape[-1])
    alloc, levels = _groups_rows(
        busy[None], mu[None], group_mask[None], demands[None], route
    )
    return alloc[0], levels[0], _phi(levels[0], demands.to(I32))


def water_fill_batch(
    busy: torch.Tensor,
    mu: torch.Tensor,
    group_mask: torch.Tensor,
    demands: torch.Tensor,
    *,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """WF over B *independent* problems: (B, M) busy/mu, (B, K, M) masks,
    (B, K) demands → ((B, K, M) alloc, (B, K) levels, (B,) Φ).  Each
    group step is one launch over all B rows.  The problems do not see
    each other's allocations; same-slot admission uses
    :func:`water_fill_chain`."""
    route = wl.resolve_waterlevel(impl, busy.shape[-1])
    alloc, levels = _groups_rows(busy, mu, group_mask, demands, route)
    return alloc, levels, _phi(levels, demands.to(I32))


def water_fill_chain(
    busy: torch.Tensor,
    mu: torch.Tensor,
    group_mask: torch.Tensor,
    demands: torch.Tensor,
    *,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential admission of B jobs, committing eq. 2 between jobs.

    (M,) busy before the burst, (B, M) mu, (B, K, M) masks, (B, K)
    demands → (alloc (B, K, M), Φ (B,), busy after the burst (M,)).
    Job ``i+1`` sees ``b_m + ⌈load_m^i/μ_m^i⌉``, exactly as if the jobs
    were admitted one at a time.
    """
    route = wl.resolve_waterlevel(impl, busy.shape[-1])
    b = busy.to(I32)[None]
    mu = mu.to(I32)
    demands = demands.to(I32)
    allocs, phis = [], []
    for j in range(mu.shape[0]):
        alloc_j, levels_j = _groups_rows(
            b, mu[j : j + 1], group_mask[j : j + 1], demands[j : j + 1], route
        )
        loads = alloc_j[0].sum(0, dtype=I32)
        # loads > 0 only where μ > 0; the clamp keeps the other lanes'
        # (discarded) division defined
        mu_j = mu[j].clamp(min=1)
        b = b + torch.where(loads > 0, _ceil_div(loads, mu_j), 0)  # eq. 2
        allocs.append(alloc_j[0])
        phis.append(_phi(levels_j[0], demands[j]))
    return torch.stack(allocs), torch.stack(phis), b[0]


# ---------------------------------------------------------------------------
# host adapters (numpy helpers copied from repro/core/wf_jax.py)


def check_group_capacity(
    mu: np.ndarray, masks: np.ndarray, demands: np.ndarray
) -> None:
    """A group with positive demand must have a non-empty mask and
    positive total capacity, otherwise the device water level would
    silently return a ``BIG``-derived value.

    ``mu`` is (M,) or (B, M); ``masks`` (K, M) or (B, K, M); ``demands``
    (K,) or (B, K) — raises :class:`ValueError` on the first violation.
    """
    mu = np.atleast_2d(np.asarray(mu))
    masks = np.asarray(masks)
    demands = np.atleast_2d(np.asarray(demands))
    masks = masks.reshape((demands.shape[0], demands.shape[1], -1))
    cap = (masks * mu[:, None, :]).sum(axis=-1)
    bad = (demands > 0) & (cap <= 0)
    if bad.any():
        i, k = map(int, np.argwhere(bad)[0])
        reason = (
            "an all-False availability mask"
            if not masks[i, k].any()
            else "zero total capacity on its available servers"
        )
        raise ValueError(
            f"infeasible water-fill group (problem {i}, group {k}): "
            f"demand {int(demands[i, k])} with {reason}"
        )


def _dense_inputs(
    problems: list[AssignmentProblem], k_pad: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(B,M) busy/mu, (B,K,M) masks, (B,K) demands; padded groups have
    demand 0 + empty mask, which the water level treats as no-ops."""
    b = len(problems)
    m = problems[0].n_servers
    busy = np.stack([p.busy for p in problems]).astype(np.int32)
    mu = np.stack([p.mu for p in problems]).astype(np.int32)
    masks = np.zeros((b, k_pad, m), dtype=bool)
    demands = np.zeros((b, k_pad), dtype=np.int32)
    for i, prob in enumerate(problems):
        for k, g in enumerate(prob.groups):
            masks[i, k, list(g.servers)] = True
            demands[i, k] = g.size
    check_group_capacity(mu, masks, demands)
    return busy, mu, masks, demands


def _to_assignment(
    problem: AssignmentProblem, alloc: np.ndarray, phi: int
) -> Assignment:
    per_group: list[dict[int, int]] = []
    for k in range(len(problem.groups)):
        row = alloc[k]
        nz = np.flatnonzero(row)
        per_group.append({int(mm): int(row[mm]) for mm in nz})
    result = Assignment(alloc=per_group, phi=int(phi))
    result.validate(problem)
    return result


def _pad_k(k: int) -> int:
    """The reference's power-of-two padding of K and B (its jit cache
    bound); the port runs unpadded, and the tests use this to show that
    padded steps change nothing."""
    p = 1
    while p < k:
        p *= 2
    return p


def _to_device(*arrays: np.ndarray) -> list[torch.Tensor]:
    dev = backend.device()
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _fetch(alloc: torch.Tensor, phi: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """One device→host transfer for both results."""
    flat = torch.cat([alloc.reshape(-1), phi.reshape(-1)]).cpu().numpy()
    n = alloc.numel()
    return flat[:n].reshape(alloc.shape), flat[n:]


def water_filling_torch(
    problem: AssignmentProblem, *, impl: str | None = None
) -> Assignment:
    """Host-facing WF with the water level on the device (registered as
    ``"wf_torch"``); same allocation and ``Φ_c`` as the host
    :func:`repro_torch.core.wf.water_filling`."""
    if not problem.groups:
        return Assignment(alloc=[], phi=0)  # parity with host water_filling
    busy, mu, masks, demands = _dense_inputs([problem], len(problem.groups))
    alloc, _, phi = water_fill_groups(
        *_to_device(busy[0], mu[0], masks[0], demands[0]), impl=impl
    )
    alloc, phi = _fetch(alloc, phi)
    return _to_assignment(problem, alloc, int(phi[0]))


def water_filling_torch_batch(
    problems: list[AssignmentProblem], *, impl: str | None = None
) -> list[Assignment]:
    """WF over *independent* problems in one batched pass (busy times are
    per-problem and not carried across jobs)."""
    if not problems:
        return []
    m = problems[0].n_servers
    if any(p.n_servers != m for p in problems):
        raise ValueError("batched WF requires a single cluster size")
    k = max(len(p.groups) for p in problems)
    busy, mu, masks, demands = _dense_inputs(problems, k)
    alloc, _, phi = water_fill_batch(*_to_device(busy, mu, masks, demands), impl=impl)
    alloc, phi = _fetch(alloc, phi)
    return [
        _to_assignment(p, alloc[i], int(phi[i])) for i, p in enumerate(problems)
    ]


def water_filling_torch_chain(
    problems: list[AssignmentProblem], *, impl: str | None = None
) -> list[Assignment]:
    """Admit many same-slot arrivals in one chained device pass.

    Every problem must share one cluster and carry the *same* pre-burst
    busy vector; the chain commits eq. 2 between jobs, so the results are
    identical to per-job :func:`water_filling_torch` calls with busy
    times re-read after each enqueue.
    """
    if not problems:
        return []
    m = problems[0].n_servers
    if any(p.n_servers != m for p in problems):
        raise ValueError("chained WF requires a single cluster size")
    if any(not p.groups for p in problems):
        raise ValueError("chained WF requires non-empty problems")
    base = problems[0].busy
    if any(
        p.busy is not base and not np.array_equal(p.busy, base)
        for p in problems[1:]
    ):
        # the chain re-commits eq. 2 between jobs itself; a caller passing
        # per-job evolved busy vectors would get them double-counted
        raise ValueError(
            "chained WF requires every problem to carry the same pre-burst "
            "busy vector (eq. 2 is committed inside the chain)"
        )
    k = max(len(p.groups) for p in problems)
    busy, mu, masks, demands = _dense_inputs(problems, k)
    alloc, phi, _ = water_fill_chain(
        *_to_device(busy[0], mu, masks, demands), impl=impl
    )
    alloc, phi = _fetch(alloc, phi)
    return [
        _to_assignment(p, alloc[i], int(phi[i])) for i, p in enumerate(problems)
    ]
