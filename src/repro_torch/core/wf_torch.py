"""Water-filling on torch tensors: the port of ``repro/core/wf_jax.py``.

The water level of one task group is a sort + prefix-sum + masked
ceiling division; its allocation is a prefix-sum clamp (paper eqs. 7/9
and Alg. 2).  Every call goes through one of two routes
(:func:`repro_torch.kernels.waterlevel.resolve_waterlevel`):

- ``cuda``: one launch of the fused water-filling kernel per call
  (:func:`repro_torch.kernels.waterlevel.wf_groups` for the group scan
  and the independent-problems batch, ``wf_chain`` for the eq. 2 burst
  chain), whatever its K or B; its plain version, the Python loop over
  the water-level function on padded rows, for CPU tensors;
- ``torch``: that loop on the unpadded rows, as the reference's jnp
  pipeline does (past the kernel's :data:`~repro_torch.kernels.
  waterlevel.MAX_LANES`, whatever was asked).

Both give bit-identical results; everything is int32, as in the
reference.  Each adapter brings its result to the host once.  Unlike the
reference, K and B are not padded to powers of two: that padding only
bounds a jit cache, and padded steps are no-ops.  ``CALLS`` counts the
adapter calls that reach the device.

Under an ambient :mod:`repro_torch.obs` session each adapter call is
profiled (``device.wf-groups`` / ``wf-batch`` / ``wf-chain``) after its
one host read, keyed by the kernelcheck signature of the variant it
reaches: ``(kind, lanes, K, route[, B])``.  The adapters declare the
``wf_torch.*`` geometry contracts (the fused kernel's block from
:func:`repro_torch.kernels.waterlevel.launch_config`), verified by
``python -m repro_torch.analysis.kernelcheck``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend
from ..analysis.contracts import Interval, RangeClaim, choice, contract, span
from ..kernels import waterlevel as wl
from ..obs.session import device_profiler as _obs_device
from .instance import Assignment, AssignmentProblem

__all__ = [
    "CALLS",
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

CALLS = {"adapter": 0}  # host adapter calls that reach the device


def _kernel_args(busy, mu, masks, demands) -> tuple[torch.Tensor, ...]:
    """int32 busy / μ / demands and bool masks, contiguous, as the fused
    kernel's wrappers take them."""
    return (busy.to(I32).contiguous(), mu.to(I32).contiguous(), masks.contiguous(),
            demands.to(I32).contiguous())


def _groups(route: str, busy, mu, masks, demands):
    args = _kernel_args(busy, mu, masks, demands)
    if route == "cuda":
        return wl.wf_groups(*args)
    return wl.wf_groups_plain(*args, padded=False)


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
    demand = torch.as_tensor(demand, dtype=I32, device=busy.device).reshape(1, 1)
    alloc, levels, _ = _groups(route, busy[None], mu[None], mask[None, None], demand)
    return alloc[0, 0], levels[0, 0]


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
    alloc, levels, phi = _groups(
        route, busy[None], mu[None], group_mask[None], demands[None]
    )
    return alloc[0], levels[0], phi[0]


def water_fill_batch(
    busy: torch.Tensor,
    mu: torch.Tensor,
    group_mask: torch.Tensor,
    demands: torch.Tensor,
    *,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """WF over B *independent* problems: (B, M) busy/mu, (B, K, M) masks,
    (B, K) demands → ((B, K, M) alloc, (B, K) levels, (B,) Φ), one block
    a problem.  The problems do not see each other's allocations;
    same-slot admission uses :func:`water_fill_chain`."""
    route = wl.resolve_waterlevel(impl, busy.shape[-1])
    return _groups(route, busy, mu, group_mask, demands)


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
    args = _kernel_args(busy, mu, group_mask, demands)
    if route == "cuda":
        alloc, _, phi, busy_out = wl.wf_chain(*args)
    else:
        alloc, _, phi, busy_out = wl.wf_chain_plain(*args, padded=False)
    return alloc, phi, busy_out


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


# ---------------------------------------------------------------------------
# kernelcheck geometry contracts (verified by repro_torch.analysis.kernelcheck)


def _wf_sig(kind: str, m: int, k: int, route: str, b: int | None = None) -> tuple:
    """The variant an adapter call reaches: the fused kernel's lane class
    on the ``cuda`` route (the unpadded width on ``torch``), K, the route,
    and B for the batch and the chain; the profiler's and the contracts'
    key."""
    lanes = wl.n_lanes_for(m) if route == "cuda" else m
    sig = (kind, lanes, k, route)
    return sig if b is None else sig + (b,)


def _wf_dispatch(geom: dict) -> str:
    return wl.resolve_waterlevel(geom["requested"], geom["m"])


def _wf_ranges(geom: dict) -> list:
    """The kernel's claims plus the adapter-level carry claims: evolved
    levels stay within the busy envelope (eq. 10 max / eq. 2 commit) and
    the burst preserves the kernel's Σ busy·μ precondition."""
    m = geom["m"]
    claims = wl.wl_range_claims(m)
    claims.append(
        RangeClaim(
            "eq. 10 / eq. 2 busy carry (levels fed back as busy)",
            Interval(0, wl.WL_BUSY0_MAX + wl.WL_TOTAL_DEMAND_MAX),
            bound=wl.WL_LEVEL_MAX,
        )
    )
    claims.append(
        RangeClaim(
            "Σ busy·μ preserved across the burst (kernel precondition)",
            Interval(
                0,
                wl.WL_BUSY0_MAX * wl.WL_MU_MAX * m
                + wl.WL_TOTAL_DEMAND_MAX
                + m * wl.WL_MU_MAX,
            ),
            bound=wl.WL_SUM_BMU_MAX,
        )
    )
    return claims


def _wf_signature(geom: dict, kind: str) -> tuple:
    return _wf_sig(kind, geom["m"], geom["k"], _wf_dispatch(geom), geom.get("b"))


def _wf_abstract(geom: dict, kind: str):
    """Zero-filled CPU inputs through the fused kernel's wrapper (its
    checks, then its plain loop)."""
    m, k = geom["m"], geom["k"]
    rows = geom.get("b", 1)
    i32 = torch.int32
    mu = torch.ones((rows, m), dtype=i32)
    masks = torch.zeros((rows, k, m), dtype=torch.bool)
    demands = torch.zeros((rows, k), dtype=i32)
    if kind == "wf-chain":
        return wl.wf_chain, (torch.zeros(m, dtype=i32), mu, masks, demands)
    return wl.wf_groups, (torch.zeros((rows, m), dtype=i32), mu, masks, demands)


_ROUTES = choice("requested", "auto", "torch", "cuda")


def _fused_smem(geom: dict):
    return wl.launch_config(wl.n_lanes_for(geom["m"]), fused=True)


def _fetch(alloc: torch.Tensor, phi: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """One device→host transfer for both results."""
    flat = torch.cat([alloc.reshape(-1), phi.reshape(-1)]).cpu().numpy()
    n = alloc.numel()
    return flat[:n].reshape(alloc.shape), flat[n:]


@contract(
    "wf_torch.groups",
    axes=(
        span(
            "m",
            1,
            wl.WL_M_MAX,
            boundaries=(wl.LANES, wl.FUSED_SMEM_MAX_LANES, wl.MAX_LANES),
        ),
        choice("k", 1, 3, 16, 128),
        _ROUTES,
    ),
    backends=("cuda", "torch"),
    device_backends=("cuda",),
    dispatch=_wf_dispatch,
    smem=_fused_smem,
    ranges=_wf_ranges,
    signature=lambda geom: _wf_signature(geom, "wf-groups"),
    max_signatures=32,  # fused lane classes × K
    abstract=lambda geom: _wf_abstract(geom, "wf-groups"),
    eval_points=4,
    notes="K-group scan adapter: one fused launch a call; rows past 8,192 "
    "lanes run on the L2 scratch, widths past MAX_LANES take the torch "
    "route (admissible, no past probes needed)",
)
def water_filling_torch(
    problem: AssignmentProblem, *, impl: str | None = None
) -> Assignment:
    """Host-facing WF with the water level on the device (registered as
    ``"wf_torch"``); same allocation and ``Φ_c`` as the host
    :func:`repro_torch.core.wf.water_filling`."""
    if not problem.groups:
        return Assignment(alloc=[], phi=0)  # parity with host water_filling
    CALLS["adapter"] += 1
    k = len(problem.groups)
    busy, mu, masks, demands = _dense_inputs([problem], k)
    prof = _obs_device()
    t0 = prof.start() if prof is not None else 0.0
    alloc, _, phi = water_fill_groups(
        *_to_device(busy[0], mu[0], masks[0], demands[0]), impl=impl
    )
    alloc, phi = _fetch(alloc, phi)
    if prof is not None:  # past the host read; sig = the kernelcheck key
        m = problem.n_servers
        prof.record("wf-groups", _wf_sig("wf-groups", m, k, wl.resolve_waterlevel(impl, m)), t0)
    return _to_assignment(problem, alloc, int(phi[0]))


@contract(
    "wf_torch.batch",
    axes=(
        choice("m", 1, 128, 4096, wl.FUSED_SMEM_MAX_LANES, wl.MAX_LANES, wl.WL_M_MAX),
        choice("k", 1, 16),
        choice("b", 1, 2, 7, 32),
        _ROUTES,
    ),
    backends=("cuda", "torch"),
    device_backends=("cuda",),
    dispatch=_wf_dispatch,
    smem=_fused_smem,  # one block a problem, each with its row
    ranges=_wf_ranges,
    signature=lambda geom: _wf_signature(geom, "wf-batch"),
    max_signatures=48,
    abstract=lambda geom: _wf_abstract(geom, "wf-batch"),
    eval_points=3,
    notes="independent-problems batch: one fused launch over B blocks",
)
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
    CALLS["adapter"] += 1
    prof = _obs_device()
    t0 = prof.start() if prof is not None else 0.0
    alloc, _, phi = water_fill_batch(*_to_device(busy, mu, masks, demands), impl=impl)
    alloc, phi = _fetch(alloc, phi)
    if prof is not None:  # past the host read; sig = the kernelcheck key
        route = wl.resolve_waterlevel(impl, m)
        prof.record("wf-batch", _wf_sig("wf-batch", m, k, route, len(problems)), t0)
    return [
        _to_assignment(p, alloc[i], int(phi[i])) for i, p in enumerate(problems)
    ]


@contract(
    "wf_torch.chain",
    axes=(
        choice("m", 1, 128, wl.FUSED_SMEM_MAX_LANES, wl.MAX_LANES, wl.WL_M_MAX),
        choice("k", 1, 16),
        choice("b", 1, 2, 7, 32, 64),
        _ROUTES,
    ),
    backends=("cuda", "torch"),
    device_backends=("cuda",),
    dispatch=_wf_dispatch,
    smem=_fused_smem,  # one block walks the burst
    ranges=_wf_ranges,
    signature=lambda geom: _wf_signature(geom, "wf-chain"),
    max_signatures=48,
    abstract=lambda geom: _wf_abstract(geom, "wf-chain"),
    eval_points=3,
    notes="same-slot burst chain: one fused launch, one block, eq. 2 "
    "committed between jobs in shared memory (on the L2 scratch past "
    "8,192 lanes)",
)
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
    CALLS["adapter"] += 1
    prof = _obs_device()
    t0 = prof.start() if prof is not None else 0.0
    alloc, phi, _ = water_fill_chain(
        *_to_device(busy[0], mu, masks, demands), impl=impl
    )
    alloc, phi = _fetch(alloc, phi)
    if prof is not None:  # past the host read; sig = the kernelcheck key
        route = wl.resolve_waterlevel(impl, m)
        prof.record("wf-chain", _wf_sig("wf-chain", m, k, route, len(problems)), t0)
    return [
        _to_assignment(p, alloc[i], int(phi[i])) for i, p in enumerate(problems)
    ]
