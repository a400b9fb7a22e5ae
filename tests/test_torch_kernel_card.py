"""The CUDA water-level kernel against its plain version, on the card.

Needs a CUDA device (the kernel has no CPU mode), so it skips elsewhere;
run it on a GPU machine with
``python -m pytest -m gpu tests/test_torch_kernel_card.py``.  It imports
only the port, so it runs where jax is not installed.  ``chip_smoke.py``
makes the same check at the main path's widths.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import waterlevel as wl


def _rows(rng, m, bsz, case):
    """Pre-masked, padded (B, n_lanes) rows; every row keeps one available
    lane with positive capacity."""
    busy = rng.integers(0, 25, (bsz, m))
    mu = rng.integers(0, 6, (bsz, m))
    mask = rng.random((bsz, m)) < 0.6
    demand = rng.integers(0, 12 * m + 50, bsz)
    rows = np.arange(bsz)
    if case == "ties":
        busy = rng.integers(0, 3, (bsz, m))
    elif case == "demand0":
        demand[:] = 0
    elif case == "boundary":  # busy just under the BIG sentinel
        busy[:, 0] = wl.BIG - rng.integers(1, 1000, bsz)
        mu[:] = 1
        mask[:] = True
        demand = rng.integers(0, 50, bsz)
    dead = ~(mask & (mu > 0)).any(axis=1)
    mask[rows[dead], 0] = True
    mu[rows[dead], 0] = np.maximum(1, mu[rows[dead], 0])
    n = wl.n_lanes_for(m)
    b = np.full((bsz, n), wl.BIG, np.int32)
    w = np.zeros((bsz, n), np.int32)
    b[:, :m] = np.where(mask, busy, wl.BIG)
    w[:, :m] = np.where(mask, mu, 0)
    return [torch.from_numpy(x).cuda() for x in (b, w, demand.astype(np.int32))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "ties", "demand0", "boundary"])
def test_kernel_matches_plain_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    for m in (1, 100, 4096, 16384, 32768):
        for bsz in (1, 4):
            args = _rows(rng, m, bsz, case)
            wl.reset_counts()
            got = wl.waterlevel_sorted(*args)
            assert wl.COUNTS["plain"] == 0
            want = wl.waterlevel_sorted_plain(*args)
            for g, p in zip(got, want):
                assert torch.equal(g, p), (m, bsz, case)


@pytest.mark.gpu
def test_wrapper_rejects_a_cuda_row_past_the_ceiling():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 2 * wl.MAX_LANES
    b = torch.full((1, n), wl.BIG, dtype=torch.int32, device="cuda")
    w = torch.zeros((1, n), dtype=torch.int32, device="cuda")
    d = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        wl.waterlevel_sorted(b, w, d)
