"""Integer water-level computation (eqs. 7 and 9 of the paper).

Given busy levels ``b_m`` and widths ``μ_m`` over a server set, find the
minimal integer level ``ξ`` such that

    Σ_m max{ξ - b_m, 0} · μ_m  ≥  T.

The paper finds ``ξ`` by binary search with an O(|S|) feasibility walk
(complexity O(|S|·log T)).  We compute it in closed form after sorting:
for ``ξ`` in the half-open span above the ``i``-th smallest busy level,
capacity(ξ) = ξ·Σ_{j≤i}μ_j − Σ_{j≤i}b_j·μ_j is linear, so the minimal
integer level is a ceiling division — O(|S| log |S|) total and exact.
"""

from __future__ import annotations

import numpy as np

__all__ = ["water_level", "water_fill_alloc"]


def water_level(busy: np.ndarray, mu: np.ndarray, demand: int) -> int:
    """Minimal integer ``ξ`` with ``Σ_m max{ξ-b_m,0}·μ_m ≥ demand``.

    For ``demand <= 0`` the level stays at the minimum busy value (the
    device path's convention); empty server sets return 0.  A positive
    demand against zero total capacity raises :class:`ValueError`,
    mirroring :func:`repro_torch.core.wf_torch.check_group_capacity` — the device
    path clamps the divisor instead, so unguarded zero-μ inputs would
    silently diverge between the two.
    """
    busy = np.asarray(busy, dtype=np.int64)
    mu = np.asarray(mu, dtype=np.int64)
    if demand <= 0:
        return int(busy.min()) if busy.size else 0
    if busy.size == 0 or int(mu.sum()) <= 0:
        raise ValueError(
            f"infeasible water level: demand {int(demand)} with zero total "
            "capacity (empty server set or all-zero μ)"
        )
    order = np.argsort(busy, kind="stable")
    b = busy[order]
    w = mu[order]
    cum_w = np.cumsum(w)
    cum_bw = np.cumsum(b * w)
    n = b.shape[0]
    # capacity at level b[i] using servers 0..i-1: b[i]*cum_w[i-1] - cum_bw[i-1]
    for i in range(n):
        if cum_w[i] == 0:
            # a zero-μ prefix has no capacity at any level — no candidate
            # (and dividing by it would raise); matches the device path's
            # ``cw > 0`` validity mask
            continue
        # candidate level with servers 0..i participating:
        #   xi = ceil((demand + cum_bw[i]) / cum_w[i])
        xi = -(-(demand + cum_bw[i]) // cum_w[i])
        # valid if the level does not exceed the next busy value (else more
        # servers would participate and the linear segment changes)
        if i + 1 >= n or xi <= b[i + 1]:
            # also must exceed b[i] so that servers 0..i all participate
            # (xi >= b[i]+1 is implied when demand > 0 and capacities are
            # exact; clamp defensively)
            return int(max(xi, b[i] + 1))
    raise AssertionError("unreachable: last segment always admits a level")


def water_fill_alloc(
    busy: np.ndarray, mu: np.ndarray, demand: int, level: int | None = None
) -> tuple[np.ndarray, int]:
    """Allocate ``demand`` tasks at the water level, paper Alg. 2 lines 7-13.

    Servers with ``busy < ξ`` participate; each participating server gets
    ``(ξ - b_m)·μ_m`` tasks except the last (in ascending-busy order, stable
    by index), which receives the remainder.  Returns (alloc, ξ).
    """
    busy = np.asarray(busy, dtype=np.int64)
    mu = np.asarray(mu, dtype=np.int64)
    xi = water_level(busy, mu, demand) if level is None else level
    alloc = np.zeros_like(mu)
    part = np.flatnonzero(busy < xi)
    if demand <= 0 or part.size == 0:
        return alloc, int(xi)
    # ascending busy order, stable: the paper walks the sorted server list
    part = part[np.argsort(busy[part], kind="stable")]
    remaining = int(demand)
    for idx, m in enumerate(part):
        if idx == part.size - 1:
            take = remaining
        else:
            take = min(int((xi - busy[m]) * mu[m]), remaining)
        alloc[m] = take
        remaining -= take
        if remaining == 0:
            break
    if remaining != 0:
        raise AssertionError(
            f"water level {xi} under-allocates: {remaining} tasks left"
        )
    return alloc, int(xi)
