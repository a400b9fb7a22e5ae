"""The CUDA RD strip kernel against its plain version, on the card.

Needs a CUDA device (the kernel has no CPU mode), so it skips elsewhere;
run it on a GPU machine with
``python -m pytest -m gpu tests/test_torch_rd_card.py``.  It imports
only the port, so it runs where jax is not installed.  ``chip_smoke.py``
makes the same check at the main path's geometries and runs the RD main
path through the kernel; the last test here runs one job of that path's
trace with more tasks than the kernel has lanes (about a minute).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import AssignmentProblem, rd_torch
from repro_torch.core.rd import replica_deletion
from repro_torch.kernels import rd as rdk
from repro_torch.traces import generate

CASES = ("random", "ties", "no-candidates", "quota-past-total", "int32-extremes")


def _block(rng, n_rows, n_lanes, case):
    """A strip key block (masked -count, alt, packed words, group) with
    member counts and a quota, on the card."""
    keys = rng.integers(0, 4, (n_rows, n_lanes)).astype(np.int32)
    keys[0] = np.where(rng.random(n_lanes) < 0.3, -rng.integers(2, 5, n_lanes), rdk.BIG)
    size = rng.integers(0, 30, n_lanes).astype(np.int32)
    quota = np.array([rng.integers(1, 200)], np.int32)
    if case == "ties":  # every key row equal: only the lane breaks ties
        keys[:] = keys[:, :1]
        keys[0] = -3
    elif case == "no-candidates":
        keys[0] = rdk.BIG
    elif case == "quota-past-total":
        quota[0] = int(size.sum()) + 1000
    elif case == "int32-extremes":
        top = np.iinfo(np.int32).max - rng.integers(0, 3, (n_rows - 1, n_lanes))
        bottom = np.iinfo(np.int32).min + rng.integers(0, 3, (n_rows - 1, n_lanes))
        keys[1:] = np.where(rng.random((n_rows - 1, n_lanes)) < 0.5, top, bottom)
    return [torch.from_numpy(x).cuda() for x in (keys, size, quota)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(CASES.index(case))
    for n_lanes in (128, 1024, 4096, 8192, 16384):
        for n_rows in (4, 11, 24):
            args = _block(rng, n_rows, n_lanes, case)
            rdk.reset_counts()
            got = rdk.rd_strip_takes(*args)
            assert rdk.COUNTS == {"rd_strip": 1, "plain": 0}
            want = rdk.rd_strip_takes_plain(*args)
            torch.cuda.synchronize()
            for g, p in zip(got, want):
                assert torch.equal(g, p), (n_lanes, n_rows, case)


@pytest.mark.gpu
@pytest.mark.parametrize("past", ["lanes", "rows"])
def test_wrapper_rejects_a_cuda_block_past_the_ceilings(past):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_rows, n_lanes = (4, 2 * rdk.RD_MAX_C) if past == "lanes" else (
        rdk.RD_MAX_KEY_ROWS + 1,
        128,
    )
    keys = torch.full((n_rows, n_lanes), rdk.BIG, dtype=torch.int32, device="cuda")
    size = torch.zeros(n_lanes, dtype=torch.int32, device="cuda")
    quota = torch.ones(1, dtype=torch.int32, device="cuda")
    rdk.reset_counts()
    with pytest.raises(ValueError):
        rdk.rd_strip_takes(keys, size, quota)
    assert rdk.COUNTS == {"rd_strip": 0, "plain": 0}


@pytest.mark.gpu
def test_a_job_with_more_tasks_than_kernel_lanes_runs_on_the_card():
    """The first job of chip_smoke.py's 4096-server trace with more tasks
    than RD_MAX_C: its slot capacity stays within the kernel's lanes, and
    every strip launches the kernel, with no plain strip and no host
    re-run, for the host RD's assignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = 4096
    jobs = generate("bursty", n_servers=m, n_jobs=1000, total_tasks=4_655_227, seed=0)
    job = next(
        j
        for j in sorted(jobs, key=lambda j: (j.arrival, j.job_id))
        if j.n_tasks > rdk.RD_MAX_C
    )
    problem = AssignmentProblem(busy=np.zeros(m, np.int64), mu=job.mu, groups=job.groups)
    rdk.reset_counts()
    rd_torch.reset_counts()
    got = rd_torch.replica_deletion_torch(problem)
    assert rdk.COUNTS["rd_strip"] > 0 and rdk.COUNTS["plain"] == 0
    assert rd_torch.COUNTS["host_reruns"] == 0
    ((capacity, peak),) = rd_torch.SLOT_PEAKS
    assert capacity == rd_torch.rd_slot_capacity(problem) <= rdk.RD_MAX_C
    assert peak <= capacity
    want = replica_deletion(problem)
    assert got.alloc == want.alloc and got.phi == want.phi
