"""The water-level kernels' redesign, held on the CPU (tolerance 0: int32).

``csrc/waterlevel.cu`` sorts only the lanes whose busy is not ``BIG``:
the ``BIG`` lanes tie on busy, so in ``(busy, lane)`` order they form one
run already in lane order, with the lanes below ``BIG`` before it and
those above it after it.  Here a numpy mirror of that rule (the kernel's
slot assignment, its bitonic network whose compare-exchanges all put the
smaller key low, run on the next power of two of each segment with the
virtual lanes past it skipped, then steps 2-5) is held bit for bit
against ``waterlevel_sorted_plain`` and the reference's Pallas kernel in
interpret mode.  A mirror of the fused kernel's row loop (allocation
written in lane order, the demand <= 0 rule over the real lanes, eq. 10
and eq. 2) and the fused entry points' CPU route are held against
``wf_jax``.  The kernels themselves run on the card
(``tests/test_torch_wf_card.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backend as ref_backend
from repro.core import wf_jax
from repro.kernels.waterlevel import (
    _waterlevel_call_padded,
    _waterlevel_call_padded_batch,
)
from repro_torch import backend
from repro_torch.core import wf_torch
from repro_torch.kernels import waterlevel as wl

BIG = 2**30
CASES = ("random", "ties", "masked", "demand0", "boundary", "at-big", "above-big")

_ref_groups = jax.jit(wf_jax.water_fill_groups)
_ref_batch = jax.jit(wf_jax.water_fill_batch)
_ref_chain = jax.jit(wf_jax.water_fill_chain)


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with backend.set_backend(device="cpu"):
        yield
    torch.set_num_threads(threads)


def _i32(x):
    return np.asarray(x, dtype=np.int64).astype(np.int32)


# ---- the kernel's order rule, mirrored ----------------------------------------


def _network_sort(keys: np.ndarray) -> np.ndarray:
    """The kernel's bitonic network on one segment: a flip stage then
    half-cleaners per size, every compare-exchange ascending, over the
    next power of two of the segment (at least 32, the warp route's
    width), pairs that reach a virtual lane skipped."""
    keys = keys.copy()
    n = len(keys)
    if n <= 1:
        return keys
    p = 32
    while p < n:
        p *= 2

    def cx(lo, hi):
        ok = hi < n
        lo, hi = lo[ok], hi[ok]
        a, c = keys[lo], keys[hi]
        swap = a > c
        keys[lo[swap]], keys[hi[swap]] = c[swap], a[swap]

    t = np.arange(p // 2)
    size = 2
    while size <= p:
        hs = size // 2
        r = t & (hs - 1)
        cx(((t - r) << 1) + r, ((t - r) << 1) + size - 1 - r)
        j = hs // 2
        while j > 0:
            lo = ((t & ~(j - 1)) << 1) | (t & (j - 1))
            cx(lo, lo + j)
            j //= 2
        size *= 2
    return keys


def splice_order(b: np.ndarray) -> np.ndarray:
    """The lane order the kernel builds for one row: the slot of every
    lane from one scan (below-BIG lanes packed at the front, above-BIG at
    the back, BIG lanes at n_lo + their rank among BIG lanes), then the
    two end segments sorted by (busy, lane) keys."""
    b = b.astype(np.int64)
    n = len(b)
    lane = np.arange(n)
    lo, hi = b < BIG, b > BIG
    n_lo, n_hi = int(lo.sum()), int(hi.sum())
    lo_before = np.cumsum(lo) - lo
    hi_before = np.cumsum(hi) - hi
    pos = np.where(lo, lo_before, np.where(hi, n - n_hi + hi_before,
                                           n_lo + lane - lo_before - hi_before))
    slots = np.empty(n, np.int64)
    slots[pos] = lane
    assert sorted(pos.tolist()) == list(range(n))  # a permutation
    keys = (b[slots] + 2**31) * 2**32 + slots  # (busy, lane), unique
    keys[:n_lo] = _network_sort(keys[:n_lo])
    keys[n - n_hi:] = _network_sort(keys[n - n_hi:])
    return (keys % 2**32).astype(np.int64)


def mirror_row(b: np.ndarray, w: np.ndarray, demand: int):
    """Steps 2-5 on the spliced order, int32 wrapping as in the kernel."""
    idx = splice_order(b)
    bs = b.astype(np.int64)[idx]
    ws = w.astype(np.int64)[idx]
    cw = _i32(np.cumsum(ws)).astype(np.int64)
    cbw = _i32(np.cumsum(_i32(bs * ws).astype(np.int64))).astype(np.int64)
    xi = _i32(-(-_i32(demand + cbw).astype(np.int64) // np.maximum(cw, 1))).astype(np.int64)
    next_b = np.append(bs[1:], BIG)
    valid = (xi <= next_b) & (cw > 0)
    first = int(np.argmax(valid)) if valid.any() else 0
    level = int(max(xi[first], int(_i32(bs[first] + 1))))
    caps = _i32(np.maximum(_i32(level - bs).astype(np.int64), 0) * ws).astype(np.int64)
    prev = _i32(np.cumsum(caps) - caps).astype(np.int64)
    take = np.minimum(np.maximum(_i32(demand - prev).astype(np.int64), 0), caps)
    return level, _i32(take), _i32(idx)


def _rows(rng, m, bsz, case):
    """Pre-masked padded (B, n) rows and their demands; every row keeps one
    available lane with positive capacity."""
    busy = rng.integers(0, 25, (bsz, m)).astype(np.int64)
    mu = rng.integers(0, 6, (bsz, m))
    mask = rng.random((bsz, m)) < 0.6
    demand = rng.integers(0, 12 * m + 50, bsz)
    rows = np.arange(bsz)
    if case == "ties":
        busy = rng.integers(0, 3, (bsz, m)).astype(np.int64)
    elif case == "masked":
        mask[:] = False
        mask[rows, rng.integers(0, m, bsz)] = True
    elif case == "demand0":
        demand[:] = 0
    elif case == "boundary":  # busy just under BIG
        busy[:, 0] = BIG - rng.integers(1, 1000, bsz)
        mu[:] = 1
        mask[:] = True
        demand = rng.integers(0, 50, bsz)
    elif case == "at-big":  # masked-in lanes whose busy is exactly BIG
        busy[rng.random((bsz, m)) < 0.3] = BIG
        mu = rng.integers(1, 6, (bsz, m))
    elif case == "above-big":  # lanes raised past BIG, and some at it
        pick = rng.random((bsz, m))
        busy[pick < 0.3] = BIG + rng.integers(0, 40, int((pick < 0.3).sum()))
        busy[(pick >= 0.3) & (pick < 0.4)] = BIG
        mu = rng.integers(1, 6, (bsz, m))
        demand = rng.integers(0, 4 * m + 10, bsz)
    dead = ~(mask & (mu > 0)).any(axis=1)
    pick = rng.integers(0, m, bsz)
    mask[rows[dead], pick[dead]] = True
    mu[rows[dead], pick[dead]] = np.maximum(1, mu[rows[dead], pick[dead]])
    n = wl.n_lanes_for(m)
    b = np.full((bsz, n), BIG, np.int32)
    w = np.zeros((bsz, n), np.int32)
    b[:, :m] = np.where(mask, busy, BIG)
    w[:, :m] = np.where(mask, mu, 0)
    return b, w, demand.astype(np.int32)


def _reference(b, w, demand):
    if b.shape[0] == 1:
        out = _waterlevel_call_padded(
            jnp.asarray(b), jnp.asarray(w), jnp.asarray(demand.reshape(1, 1)),
            interpret=True,
        )
        level, take, idx = (np.asarray(x) for x in out)
        return level.reshape(1), take[None], idx[None]
    out = _waterlevel_call_padded_batch(
        jnp.asarray(b), jnp.asarray(w), jnp.asarray(demand.reshape(-1, 1)),
        interpret=True,
    )
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("m", [1, 3, 32, 33, 100, 300])
def test_splice_rule_matches_plain_and_reference_kernel(m, bsz, case):
    rng = np.random.default_rng(7000 + 100 * m + 10 * bsz + CASES.index(case))
    b, w, demand = _rows(rng, m, bsz, case)
    got = [mirror_row(b[r], w[r], int(demand[r])) for r in range(bsz)]
    level = np.array([g[0] for g in got], np.int32)
    take = np.stack([g[1] for g in got])
    idx = np.stack([g[2] for g in got])
    plain = wl.waterlevel_sorted_plain(*(torch.from_numpy(x) for x in (b, w, demand)))
    ref = _reference(b, w, demand)
    for name, mine, p, r in zip(("level", "take", "idx"), (level, take, idx), plain, ref):
        np.testing.assert_array_equal(mine, p.numpy(), err_msg=f"{name} vs plain")
        np.testing.assert_array_equal(mine, r, err_msg=f"{name} vs reference")


@pytest.mark.parametrize("live", [0, 1, 2, 31, 32, 33, 64, 65, 200])
def test_network_sort_on_any_segment_length(live):
    """The segment sort equals a stable argsort for every length,
    including the warp route's 32 and the shared-memory route's powers of
    two and one past them."""
    rng = np.random.default_rng(live)
    n = 512
    b = np.full(n, BIG, np.int64)
    lanes = rng.choice(n, live, replace=False)
    b[lanes] = rng.integers(0, 4, live) + np.where(rng.random(live) < 0.3, BIG + 1, 0)
    np.testing.assert_array_equal(splice_order(b), np.argsort(b, kind="stable"))


# ---- the fused kernel's one-warp step, mirrored ----------------------------------


def warp_step_applies(b: np.ndarray, w: np.ndarray) -> bool:
    """The kernel's test for its one-warp step: at most 32 lanes below BIG,
    none above it, and every lane at BIG with w = 0."""
    return (b < BIG).sum() <= 32 and not (b > BIG).any() and not ((b == BIG) & (w != 0)).any()


def mirror_warp_step(b: np.ndarray, w: np.ndarray, demand: int):
    """Steps 1-5 on the live lanes alone, as warp 0 runs them: the BIG run
    after them keeps their prefix sums, so the first valid position is a
    live one or none (then position 0).  Returns (level, takes in lane
    order, smallest live busy or BIG)."""
    live = np.flatnonzero(b < BIG)
    order = live[np.argsort(b[live].astype(np.int64) * 2**32 + live, kind="stable")]
    bs = b[order].astype(np.int64)
    ws = w[order].astype(np.int64)
    cw = _i32(np.cumsum(ws)).astype(np.int64)
    cbw = _i32(np.cumsum(_i32(bs * ws).astype(np.int64))).astype(np.int64)
    xi = _i32(-(-_i32(demand + cbw).astype(np.int64) // np.maximum(cw, 1))).astype(np.int64)
    valid = (xi <= np.append(bs[1:], BIG)) & (cw > 0)
    if len(order):
        first = int(np.argmax(valid)) if valid.any() else 0
        xi_sel, b_sel = int(xi[first]), int(bs[first])
    else:  # position 0 is a BIG lane with cw = cbw = 0
        xi_sel, b_sel = demand, BIG
    level = max(xi_sel, int(_i32(b_sel + 1)))
    caps = _i32(np.maximum(_i32(level - bs).astype(np.int64), 0) * ws).astype(np.int64)
    prev = _i32(np.cumsum(caps) - caps).astype(np.int64)
    take = np.minimum(np.maximum(_i32(demand - prev).astype(np.int64), 0), caps)
    alloc = np.zeros(len(b), np.int32)
    alloc[order] = take
    return level, alloc, int(bs[0]) if len(order) else BIG


@pytest.mark.parametrize("live", [0, 1, 2, 10, 31, 32])
@pytest.mark.parametrize("case", ["random", "ties", "demand0", "boundary", "zero-mu"])
def test_warp_step_equals_the_full_row_step(live, case):
    rng = np.random.default_rng(100 * live + len(case))
    n = 256
    for _ in range(20):
        b = np.full(n, BIG, np.int64)
        w = np.zeros(n, np.int64)
        lanes = rng.choice(n, live, replace=False)
        b[lanes] = rng.integers(0, 3 if case == "ties" else 300, live)
        if case == "boundary":
            b[lanes] = BIG - rng.integers(1, 5, live)
        w[lanes] = rng.integers(0 if case == "zero-mu" else 1, 6, live)
        demand = 0 if case == "demand0" else int(rng.integers(-3, 3000))
        assert warp_step_applies(b, w)
        level, take, idx = mirror_row(_i32(b), _i32(w), demand)
        full = np.zeros(n, np.int32)
        full[idx] = take
        got_level, got_alloc, b_first = mirror_warp_step(_i32(b), _i32(w), demand)
        assert got_level == level
        np.testing.assert_array_equal(got_alloc, full)
        assert b_first == int(b[idx[0]])


# ---- the fused kernel's row loop, mirrored --------------------------------------


def mirror_fused(busy, mu, masks, demands, chain):
    """The fused kernel's loops in numpy: per problem, per group, the
    masked padded row, its level and takes written in lane order, the
    demand <= 0 rule over the real lanes, eq. 10 between groups, and in
    chain mode eq. 2 between jobs."""
    p, k, m = masks.shape
    n = wl.n_lanes_for(m)
    alloc = np.zeros((p, k, m), np.int32)
    levels = np.zeros((p, k), np.int32)
    phi = np.zeros(p, np.int32)
    commit = busy.astype(np.int64).copy()
    for g in range(p):
        work = (commit if chain else busy[g].astype(np.int64)).copy()
        loads = np.zeros(m, np.int64)
        contribs = []
        for kk in range(k):
            mask, d = masks[g, kk], int(demands[g, kk])
            b = np.full(n, BIG, np.int64)
            w = np.zeros(n, np.int64)
            b[:m] = np.where(mask, work, BIG)
            w[:m] = np.where(mask, mu[g], 0)
            if warp_step_applies(b, w):  # the kernel's one-warp step
                level, row_alloc, b_first = mirror_warp_step(_i32(b), _i32(w), d)
                if d <= 0:
                    level = b_first
                alloc[g, kk] = row_alloc[:m]
            else:
                level, take, idx = mirror_row(_i32(b), _i32(w), d)
                if d <= 0:
                    n_hi = int((b > BIG).sum())
                    first = idx[0] if idx[0] < m else idx[n - n_hi]
                    level = int(b[first])
                real = idx < m
                alloc[g, kk, idx[real]] = take[real]
            levels[g, kk] = level
            contribs.append(level if d > 0 else 0)
            loads = _i32(loads + alloc[g, kk]).astype(np.int64)
            if d > 0:
                work = np.where(mask, np.maximum(work, level), work)
        phi[g] = max(contribs)
        if chain:
            mu_g = np.maximum(mu[g], 1)
            commit = _i32(commit + np.where(loads > 0, -(-loads // mu_g), 0)).astype(np.int64)
    return alloc, levels, phi, _i32(commit)


def _dense(rng, b, k, m, live=(1, 12), busy_hi=20):
    """(B, M) busy / μ, (B, K, M) masks with 1-12 live lanes a group, as in
    the bursty trace, and (B, K) demands; some groups idle (demand 0,
    empty mask), as padded groups are."""
    busy = rng.integers(0, busy_hi, (b, m)).astype(np.int32)
    mu = rng.integers(1, 6, (b, m)).astype(np.int32)
    masks = np.zeros((b, k, m), bool)
    for i in range(b):
        for kk in range(k):
            size = int(rng.integers(live[0], min(live[1], m) + 1))
            masks[i, kk, rng.choice(m, size, replace=False)] = True
    demands = rng.integers(1, 60, (b, k)).astype(np.int32)
    idle = rng.random((b, k)) < 0.2
    demands[idle] = 0
    masks[idle] = False
    return busy, mu, masks, demands


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("k,m", [(1, 3), (3, 100), (8, 100), (3, 4096), (8, 4096)])
def test_fused_groups_route_matches_wf_jax(k, m):
    rng = np.random.default_rng(10 * k + m)
    busy, mu, masks, demands = (x[0] for x in _dense(rng, 1, k, m))
    with ref_backend.set_backend(waterlevel="jnp"):
        want = _ref_groups(*_j(busy, mu, masks, demands))
    wl.reset_counts()
    got = wf_torch.water_fill_groups(*_t(busy, mu, masks, demands), impl="cuda")
    assert wl.COUNTS["plain"] == k and wl.COUNTS["wf_groups"] == 0  # CPU: plain loop
    mirror = mirror_fused(busy[None], mu[None], masks[None], demands[None], chain=False)
    for name, g, w, mi in zip(("alloc", "levels", "phi"), got, want, mirror):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(mi[0], np.asarray(w), err_msg=f"mirror {name}")


@pytest.mark.parametrize("b,k,m", [(1, 1, 3), (3, 3, 100), (4, 8, 100), (3, 8, 4096)])
def test_fused_batch_route_matches_wf_jax(b, k, m):
    rng = np.random.default_rng(500 + 10 * k + m)
    arrays = _dense(rng, b, k, m)
    with ref_backend.set_backend(waterlevel="jnp"):
        want = _ref_batch(*_j(*arrays))
    got = wf_torch.water_fill_batch(*_t(*arrays), impl="cuda")
    mirror = mirror_fused(*arrays, chain=False)
    for name, g, w, mi in zip(("alloc", "levels", "phi"), got, want, mirror):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(mi, np.asarray(w), err_msg=f"mirror {name}")


@pytest.mark.parametrize("b,k,m", [(1, 1, 3), (4, 3, 100), (8, 3, 100), (3, 8, 4096)])
def test_fused_chain_route_matches_wf_jax(b, k, m):
    rng = np.random.default_rng(900 + 10 * k + m)
    busy, mu, masks, demands = _dense(rng, b, k, m)
    with ref_backend.set_backend(waterlevel="jnp"):
        want = _ref_chain(*_j(busy[0], mu, masks, demands))
    got = wf_torch.water_fill_chain(*_t(busy[0], mu, masks, demands), impl="cuda")
    alloc, _, phi, busy_out = mirror_fused(busy[0], mu, masks, demands, chain=True)
    for name, g, w, mi in zip(("alloc", "phi", "busy_out"), got, want,
                              (alloc, phi, busy_out)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(mi, np.asarray(w), err_msg=f"mirror {name}")


@pytest.mark.parametrize("case", ["raised-past-big", "all-above-big-demand0"])
def test_fused_mirror_where_levels_reach_big(case):
    """Busy levels at and past BIG: eq. 10 raises a group's servers to a
    level above BIG, the next group sorts them after the BIG run; with
    every real lane above BIG and demand 0, the level is the real lanes'
    minimum, not a pad lane's BIG."""
    m, k = 5, 3
    busy = np.array([BIG - 3, BIG - 1, BIG, BIG + 2, BIG - 2], np.int32)
    mu = np.array([1, 2, 1, 3, 1], np.int32)
    masks = np.ones((k, m), bool)
    demands = np.array([20, 9, 0], np.int32)
    if case == "all-above-big-demand0":
        busy = np.array([BIG + 9, BIG + 4, BIG + 6, BIG + 1, BIG + 30], np.int32)
        demands = np.array([0, 5, 0], np.int32)
    with ref_backend.set_backend(waterlevel="jnp"):
        want = _ref_groups(*_j(busy, mu, masks, demands))
    got = wf_torch.water_fill_groups(*_t(busy, mu, masks, demands), impl="cuda")
    mirror = mirror_fused(busy[None], mu[None], masks[None], demands[None], chain=False)
    assert int(np.asarray(want[1]).max()) >= BIG
    for name, g, w, mi in zip(("alloc", "levels", "phi"), got, want, mirror):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(mi[0], np.asarray(w), err_msg=f"mirror {name}")


def test_fused_wrappers_take_the_plain_loops_on_the_cpu():
    rng = np.random.default_rng(11)
    busy, mu, masks, demands = _dense(rng, 3, 2, 40)
    args = _t(busy, mu, masks, demands)
    wl.reset_counts()
    wl.wf_groups(*args)
    wl.wf_chain(args[0][0].contiguous(), *args[1:])
    # CPU tensors take the plain loops: one water-level call per group step
    assert wl.COUNTS["plain"] == 2 + 3 * 2
    assert wl.COUNTS["wf_groups"] == wl.COUNTS["wf_chain"] == 0


@pytest.mark.parametrize(
    "bad", ["dtype", "mask_dtype", "shape", "k0", "noncontiguous", "device", "width"]
)
@pytest.mark.parametrize("entry", ["wf_groups", "wf_chain"])
def test_fused_wrappers_refuse_inputs_outside_the_contract(entry, bad):
    p, k, m = 2, 3, 16
    busy = torch.zeros((p, m) if entry == "wf_groups" else (m,), dtype=torch.int32)
    mu = torch.ones((p, m), dtype=torch.int32)
    masks = torch.ones((p, k, m), dtype=torch.bool)
    demands = torch.ones((p, k), dtype=torch.int32)
    if bad == "dtype":
        busy = busy.long()
    elif bad == "mask_dtype":
        masks = masks.to(torch.uint8)
    elif bad == "shape":
        demands = torch.ones((p, k + 1), dtype=torch.int32)
    elif bad == "k0":
        masks = masks[:, :0]
        demands = demands[:, :0]
    elif bad == "noncontiguous":
        mu = torch.ones((m, p), dtype=torch.int32).t()
    elif bad == "device":
        busy, mu, masks, demands = (t.to("meta") for t in (busy, mu, masks, demands))
    elif bad == "width":
        m = wl.MAX_LANES + 1
        busy = torch.zeros((p, m) if entry == "wf_groups" else (m,), dtype=torch.int32)
        mu = torch.ones((p, m), dtype=torch.int32)
        masks = torch.zeros((p, k, m), dtype=torch.bool)
    with pytest.raises((TypeError, ValueError)):
        getattr(wl, entry)(busy, mu, masks, demands)


def test_wf_torch_calls_count_adapter_calls():
    from repro_torch.core import AssignmentProblem, TaskGroup

    p = AssignmentProblem(busy=np.zeros(6), mu=np.ones(6),
                          groups=(TaskGroup(3, (0, 1)), TaskGroup(2, (2, 5))))
    wf_torch.CALLS["adapter"] = 0
    wf_torch.water_filling_torch(p)
    wf_torch.water_filling_torch_chain([p, p])
    wf_torch.water_filling_torch_batch([p, p, p])
    assert wf_torch.CALLS["adapter"] == 3
