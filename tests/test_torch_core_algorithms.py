"""The port's exact assignment (OBTA, NLIP, the max-flow oracle), the RD
executable specification and RD+ against the reference's, on the
instances of ``tests/test_core_algorithms.py``.

Same seeded problem (numpy, through ``convert``) → the same allocation
arrays and Φ.  The port's ``rd_plus`` runs its RD phase through
``rd_torch`` (the step kernel's plain iteration on the CPU); the
reference's runs its host RD (``set_backend(rd="host")``).
"""

import numpy as np
import pytest
import torch

import repro.backend as ref_backend
import repro.core as ref_core
from repro.core.rd_plus import rebalance_1opt as ref_rebalance
from repro.core.rd_plus import replica_deletion_plus as ref_rd_plus
from repro.core.rd_reference import replica_deletion_reference as ref_rd_reference
from repro_torch import backend, convert, registry
from repro_torch.core import (
    feasible_assignment,
    nlip,
    obta,
    phi_bounds,
    replica_deletion,
    solve_exact,
    water_filling,
)
from repro_torch.core.rd_plus import rebalance_1opt, replica_deletion_plus
from repro_torch.core.rd_reference import replica_deletion_reference
from repro_torch.core.rd_torch import replica_deletion_torch
from repro_torch.runtime import make_policy


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with backend.set_backend(device="cpu"):
        yield
    torch.set_num_threads(threads)


@pytest.fixture
def pairs(rng, random_problem):
    """80 seeded reference problems (the reference suite's fixture), each
    with the port's copy."""
    out = []
    for _ in range(80):
        ref = random_problem(rng)
        out.append((ref, convert.from_reference_problem(ref)))
    return out


def _dense_pairs(seed: int, n: int = 5):
    """The reference suite's dense RD instances: many high-replication
    groups on 25 servers."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        busy = rng.integers(0, 30, 25)
        mu = rng.integers(3, 6, 25)
        groups = tuple(
            ref_core.TaskGroup(
                int(rng.integers(20, 80)),
                tuple(sorted(rng.choice(25, size=int(rng.integers(8, 13)),
                                        replace=False).tolist())),
            )
            for _ in range(6)
        )
        ref = ref_core.AssignmentProblem(busy=busy, mu=mu, groups=groups)
        out.append((ref, convert.from_reference_problem(ref)))
    return out


def _same(got, want):
    assert got.alloc == want.alloc
    assert got.phi == want.phi


@pytest.mark.parametrize("where", ["lower", "middle", "upper", "below"])
def test_feasible_assignment_matches_reference(pairs, where):
    """The max-flow oracle gives the reference's allocation (flow on the
    same edges in the same order), or None, at Φ⁻, between the bounds,
    at Φ⁺, and below Φ⁻."""
    for ref, prob in pairs:
        lo, hi = phi_bounds(prob)
        assert (lo, hi) == ref_core.phi_bounds(ref)
        phi = {"lower": lo, "middle": (lo + hi) // 2, "upper": hi,
               "below": max(lo - 1, 0)}[where]
        got = feasible_assignment(prob, phi)
        want = ref_core.feasible_assignment(ref, phi)
        assert (got is None) == (want is None)
        if got is not None:
            _same(got, want)


@pytest.mark.parametrize("solver,ref_solver", [
    (obta, ref_core.obta),
    (nlip, ref_core.nlip),
    (lambda p: solve_exact(p, narrow=False), lambda p: ref_core.solve_exact(p, narrow=False)),
], ids=["obta", "nlip", "solve_exact-wide"])
def test_exact_solvers_match_reference(pairs, solver, ref_solver):
    for ref, prob in pairs:
        _same(solver(prob), ref_solver(ref))


def test_obta_equals_nlip_and_bounds_wf(pairs):
    """Both are exact (narrowing keeps the optimum), and WF lies within
    the paper's factor: Φ_obta ≤ realized Φ_wf ≤ Φ_wf ≤ K_c · Φ_obta."""
    for _, prob in pairs:
        opt = obta(prob).phi
        assert nlip(prob).phi == opt
        wf = water_filling(prob)
        assert opt <= wf.realized_phi(prob) <= wf.phi <= len(prob.groups) * opt


@pytest.mark.parametrize("instances", ["random", "dense"])
def test_rd_reference_matches_reference(pairs, instances):
    cases = pairs[:40] if instances == "random" else _dense_pairs(0)
    for ref, prob in cases:
        got = replica_deletion_reference(prob)
        _same(got, ref_rd_reference(ref, 0))
        _same(replica_deletion(prob), got)  # the class-compressed host RD


def test_rd_torch_matches_the_executable_specification(pairs):
    """The device RD (its plain iteration here) ≡ the port's copy of the
    executable specification."""
    for _, prob in pairs[:8] + _dense_pairs(1, n=1):
        _same(replica_deletion_torch(prob), replica_deletion_reference(prob))


def test_rd_plus_through_rd_torch_matches_reference_host_rd_plus(pairs):
    with ref_backend.set_backend(rd="host"):
        for ref, prob in pairs[:10] + _dense_pairs(2, n=1):
            got = replica_deletion_plus(prob)
            _same(got, ref_rd_plus(ref, 0))
            assert got.phi <= replica_deletion(prob).realized_phi(prob)
            assert got.phi >= obta(prob).phi


def test_rebalance_1opt_matches_reference_from_any_start(pairs):
    """The 1-opt polish alone, from WF's assignment (host only): same
    moves, same ties broken by server id."""
    for ref, prob in pairs:
        _same(rebalance_1opt(prob, water_filling(prob)),
              ref_rebalance(ref, ref_core.water_filling(ref)))


def test_registry_names_the_exact_and_rd_plus_algorithms():
    names = registry.names("algorithm")
    assert {"obta", "nlip", "rd_plus", "wf", "wf_torch", "rd", "rd_torch"} <= set(names)
    assert set(names) >= set(ref_core.ALGORITHMS) - {"wf_jax"}
    assert registry.resolve("algorithm", "obta") is obta
    assert registry.resolve("algorithm", "nlip") is nlip
    # rd_plus commits eq. 2 on the polished result: no batch path
    assert "rd_plus" not in registry.names("batch_algorithm")
    assert make_policy("rd_plus").batch_assigner is None
    assert make_policy("obta").batch_assigner is None
