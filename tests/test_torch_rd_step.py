"""Device RD's iteration (``repro_torch.kernels.rd``) on the CPU.

One call of ``rd_step`` is one iteration of the deletion or dedup loop:
the CUDA step kernel on the card, ``rd_step_plain`` for CPU state.  Here
the plain iteration drives whole RD runs against the host RD and the
reference's ``rd_jax`` (jnp route) on ``tests/test_torch_rd.py``'s
instances, the counted rule that sends holder rows past the kernel's
ceiling to the plain version is pinned, the XOR class hash is checked on
rows of up to 128 ids, and iterations past a loop's exit are shown to
move nothing.  All int32 (hashes int64): tolerance 0.
"""

import numpy as np
import pytest
import torch

from repro.core import rd as ref_rd
from repro.core import rd_jax
from repro_torch import backend, convert
from repro_torch.core import AssignmentProblem, TaskGroup
from repro_torch.core import rd as port_rd
from repro_torch.core import rd_torch
from repro_torch.kernels import rd as rdk

from test_torch_rd import _random_instance, _seeded, _twins

SLOT_BUFFERS = ("holders", "size", "cnt", "grp", "hash", "load", "multi", "busy_est")


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with backend.set_backend(device="cpu"):
        yield
    torch.set_num_threads(threads)


def _plain_rd(problem):
    """The whole RD on the plain iteration, decoded as ``rd_torch`` does."""
    st = rd_torch.run_rd(rd_torch.initial_rd_state(problem), step=rdk.rd_step_plain)
    parts, headroom = rd_torch._split(rd_torch._result(st).numpy())
    assert headroom >= 0
    return rd_torch._decode(problem, *parts)


def _instances():
    twins = _twins()
    return [(f"seeded-{i}", p) for i, p in enumerate(_seeded(6, seed=21))] + [
        (name, twins[name]) for name in sorted(twins)
    ]


@pytest.mark.parametrize("name,ref_problem", _instances(), ids=[n for n, _ in _instances()])
def test_plain_iteration_loop_matches_host_rd_and_rd_jax(name, ref_problem):
    want = ref_rd.replica_deletion(ref_problem)
    jnp_got = rd_jax.replica_deletion_jax(ref_problem)  # the jnp strip route
    got = _plain_rd(convert.from_reference_problem(ref_problem))
    for other in (jnp_got, got):
        assert other.alloc == want.alloc and other.phi == want.phi


@pytest.mark.parametrize(
    "device,row_ids,route",
    [
        ("cuda", 2, "kernel"),
        ("cuda", 16, "kernel"),
        ("cuda", rdk.RD_MAX_ROW_IDS, "kernel"),
        ("cuda", 2 * rdk.RD_MAX_ROW_IDS, "wide"),
        ("cuda", 8 * rdk.RD_MAX_ROW_IDS, "wide"),
        ("cpu", 16, "plain"),
        ("cpu", 2 * rdk.RD_MAX_ROW_IDS, "plain"),
    ],
)
def test_dispatch_rule_routes_past_the_row_ceiling_and_nowhere_else(device, row_ids, route):
    assert rdk.resolve_rd_step(device, row_ids) == route


def _wide_problem(width, m=160, seed=0):
    rng = np.random.default_rng(seed + width)
    groups = (
        TaskGroup(3, tuple(sorted(rng.choice(m, width, replace=False).tolist()))),
        TaskGroup(2, tuple(sorted(rng.choice(m, width // 2, replace=False).tolist()))),
        TaskGroup(4, tuple(sorted(rng.choice(m, 5, replace=False).tolist()))),
    )
    return AssignmentProblem(busy=rng.integers(0, 3, m), mu=rng.integers(1, 3, m),
                             groups=groups)


def test_cpu_state_past_the_row_ceiling_is_plain_not_wide():
    """Rows of 65+ ids on the CPU: the plain version because the state is
    on the CPU (counted ``plain``, never ``wide``), with host RD's result."""
    problem = _wide_problem(rdk.RD_MAX_ROW_IDS + 1)
    assert rd_torch._a_pad([problem]) > rdk.RD_MAX_ROW_IDS
    rdk.reset_counts()
    got = rd_torch.replica_deletion_torch(problem)
    want = port_rd.replica_deletion(problem)
    assert got.alloc == want.alloc and got.phi == want.phi
    assert rdk.COUNTS["plain"] > 0 and rdk.COUNTS["wide"] == 0 == rdk.COUNTS["rd_step"]


def _class_hash(st, words):
    rows = st.holders[:-1].numpy()
    grp = st.grp[:-1].numpy().astype(np.int64)
    out = np.bitwise_xor.reduce(words[rows], axis=1)
    return out ^ ((grp * rd_torch._GROUP_MULT) & rd_torch._HASH_MASK)


@pytest.mark.parametrize("width", [34, 64, 128])
def test_class_hash_survives_more_than_33_terms(width):
    """The class hash XORs one 57-bit word per holder: a row of ``width``
    ids (past the 33 terms an int64 sum was limited to) keeps every
    live slot's hash equal to its class's, after every iteration, so the
    lookup finds each class's live slot and no class holds two."""
    problem = _wide_problem(width)
    words = rd_torch._server_hash_words(problem.n_servers)
    # at 128 ids the int64 sum of this class's words would wrap
    total = int(words[np.asarray(problem.groups[0].servers)].astype(object).sum())
    assert total > 2**63 - 1 or width < 128
    checked = []

    def step(st, dedup):
        rdk.rd_step_plain(st, dedup)
        live = (st.size[:-1] > 0).numpy()
        np.testing.assert_array_equal(st.hash[:-1].numpy()[live], _class_hash(st, words)[live])
        keys = np.concatenate([st.grp[:-1].numpy()[:, None], st.holders[:-1].numpy()], 1)[live]
        assert len(np.unique(keys, axis=0)) == len(keys)
        checked.append(dedup)

    st = rd_torch.run_rd(rd_torch.initial_rd_state(problem), step=step)
    assert True in checked and False in checked
    parts, headroom = rd_torch._split(rd_torch._result(st).numpy())
    want = port_rd.replica_deletion(problem)
    got = rd_torch._decode(problem, *parts)
    assert headroom >= 0 and got.alloc == want.alloc and got.phi == want.phi


@pytest.mark.parametrize("seed", range(3))
def test_iterations_past_the_exit_move_nothing(seed):
    """After both loops have exited, further iterations of either loop
    (as ``_drive`` runs up to 15 of) leave every slot and server buffer
    as it was, and keep the exit flags set."""
    ref_problem = _random_instance(np.random.default_rng(seed), m=10, k_hi=4, size_hi=20,
                                   avail_hi=5)
    st = rd_torch.run_rd(rd_torch.initial_rd_state(convert.from_reference_problem(ref_problem)))
    before = {k: st.buffers()[k].clone() for k in SLOT_BUFFERS}
    for dedup in (True, False, True):
        rdk.rd_step_plain(st, dedup)
        assert int(st.stop) == 1
        for k in SLOT_BUFFERS:
            assert torch.equal(st.buffers()[k], before[k]), (dedup, k)


def test_plain_iteration_is_deterministic():
    """Two runs from clones of one state end bit for bit equal, spare row
    and lane included: the card's lockstep checks compare whole states."""
    ref_problem = _random_instance(np.random.default_rng(5), m=12, k_hi=5, size_hi=40,
                                   avail_hi=6)
    st = rd_torch.initial_rd_state(convert.from_reference_problem(ref_problem))
    twin = st.clone()
    rd_torch.run_rd(st, step=rdk.rd_step_plain)
    rd_torch.run_rd(twin, step=rdk.rd_step_plain)
    for name, buf in st.buffers().items():
        assert torch.equal(buf, twin.buffers()[name]), name
