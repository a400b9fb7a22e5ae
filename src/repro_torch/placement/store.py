"""The placement store: blocks → server replica sets, as mutable runtime state.

The port's copy of ``repro/placement/store.py``; each replica change is
recorded on the ambient :mod:`repro_torch.obs` session, as the
reference's is.

The paper treats a task group's available-server set as a given — frozen
into the trace when the job is generated.  This module makes that set
*derived state*: a :class:`PlacementStore` maps named blocks (data
blocks, model checkpoints, LoRA adapters) to the servers currently
holding a replica, and everything that used to bake server tuples in at
trace time now resolves them from the store at the moment they are
needed — job arrival (the engine re-resolves a :class:`PlacedJob`'s
groups against the live store), serve-layer routing
(:class:`repro_torch.serve.engine.ReplicaRouter` resolves eligible replicas by
model/adapter ID), and fault handling (an evicted replica strands queued
fragments exactly like a failed server).

Block naming is a flat namespace with conventional prefixes —
``data/j<job>/g<group>`` for trace data blocks, ``model/<name>`` and
``lora/<name>`` for checkpoint-derived serving blocks (helpers:
:func:`data_block`, :func:`model_block`, :func:`lora_block`).

Mutations go through a small event API (``add_replica`` / ``evict`` /
``server_join`` / ``server_leave`` / ``rebalance``); ``version`` bumps on
every effective mutation so callers can cache resolutions.  Re-replication
is pluggable (:mod:`repro_torch.placement.policies`): ``propose`` asks the
policy for a :class:`PlacementDelta` without mutating, ``apply`` commits
one, and ``rebalance`` does both — the scheduling engine uses the
propose/apply split so replica evictions can strand queued work through
its fault path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Job, TaskGroup
from ..obs.session import active as _obs_active

__all__ = [
    "PlacementDelta",
    "PlacementStore",
    "PlacedJob",
    "zipf_weights",
    "zipf_servers",
    "data_block",
    "model_block",
    "lora_block",
]


def data_block(job_id: int, group: int) -> str:
    return f"data/j{job_id}/g{group}"


def model_block(name: str) -> str:
    return f"model/{name}"


def lora_block(name: str) -> str:
    return f"lora/{name}"


def zipf_weights(n: int, alpha: float) -> np.ndarray:
    """Normalized Zipf(α) rank weights — the single implementation both
    trace-time and store-backed placement draw from."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha
    return w / w.sum()


def zipf_servers(
    n_servers: int,
    rng: np.random.Generator,
    zipf_alpha: float,
    avail_lo: int,
    avail_hi: int,
) -> tuple[int, ...]:
    """The paper's placement model (Sec. V-A): a Zipf(α)-ranked anchor
    server in a random permutation, then ``p ~ U{avail_lo..avail_hi}``
    consecutive servers (mod M) form the replica set.

    The seed-time placement every trace scenario draws
    (:func:`repro_torch.traces.placement.build_job`) — it lives here so
    the store can seed blocks with bit-identical RNG consumption.
    """
    perm = rng.permutation(n_servers)
    anchor = int(perm[rng.choice(n_servers, p=zipf_weights(n_servers, zipf_alpha))])
    p = int(rng.integers(avail_lo, avail_hi + 1))
    return tuple(sorted({(anchor + i) % n_servers for i in range(p)}))


@dataclasses.dataclass(frozen=True)
class PlacementDelta:
    """A proposed/applied set of replica mutations: (block, server) pairs."""

    added: tuple[tuple[str, int], ...] = ()
    evicted: tuple[tuple[str, int], ...] = ()

    def __bool__(self) -> bool:
        return bool(self.added or self.evicted)


@dataclasses.dataclass(frozen=True)
class PlacedJob(Job):
    """A job whose task groups reference placement blocks.

    ``blocks[g]`` names the data block group ``g`` reads; ``groups[g].
    servers`` is a *resolution snapshot* (taken when the job was built or
    last resolved).  The engine re-resolves against the live store at
    arrival, so placement churn between generation and arrival changes
    the eligible set — with a static store the snapshot already equals
    the live resolution and behavior is bit-identical to a plain
    :class:`~repro_torch.core.Job`.
    """

    blocks: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if len(self.blocks) != len(self.groups):
            raise ValueError(
                f"PlacedJob needs one block per group: "
                f"{len(self.blocks)} blocks vs {len(self.groups)} groups"
            )

    def subset(self, remaining) -> "PlacedJob":
        """Like :meth:`Job.subset`, keeping ``blocks`` aligned with the
        surviving groups."""
        if len(remaining) != len(self.groups):
            raise ValueError("remaining must align with groups")
        kept = [
            (TaskGroup(int(r), g.servers), b)
            for g, r, b in zip(self.groups, remaining, self.blocks)
            if int(r) > 0
        ]
        return dataclasses.replace(
            self,
            groups=tuple(g for g, _ in kept),
            blocks=tuple(b for _, b in kept),
        )

    def resolve(self, store: "PlacementStore") -> "PlacedJob | None":
        """Re-resolve every group's servers from the live store.

        Returns ``None`` if any group's block has lost all replicas (the
        job's data is gone — the engine marks it failed, exactly as when
        a server fault takes out a group's last live replica).
        """
        groups: list[TaskGroup] = []
        for grp, block in zip(self.groups, self.blocks):
            servers = store.replicas(block)
            if not servers:
                return None
            groups.append(TaskGroup(grp.size, servers))
        return dataclasses.replace(self, groups=tuple(groups))


class PlacementStore:
    """Mutable block → replica-set state over a fixed server universe.

    Servers are ``0..n_servers-1``; :meth:`server_leave` marks one
    inactive (its replicas are evicted), :meth:`server_join` re-activates
    it so the replication policy can repopulate it on the next
    rebalance.  ``version`` increments on every effective mutation.
    """

    def __init__(self, n_servers: int, *, policy=None):
        from .policies import make_replication_policy

        if n_servers <= 0:
            raise ValueError("placement store needs at least one server")
        self.n_servers = n_servers
        self.policy = make_replication_policy(policy)
        self.version = 0
        self.replicas_added = 0  # via add_replica (not initial registration)
        self.replicas_evicted = 0  # via evict / server_leave
        self._replicas: dict[str, set[int]] = {}
        self._access: dict[str, int] = {}
        self._active = np.ones(n_servers, dtype=bool)

    # ---- queries ---------------------------------------------------------

    def __contains__(self, block: str) -> bool:
        return block in self._replicas

    def blocks(self) -> list[str]:
        return sorted(self._replicas)

    def replicas(self, block: str) -> tuple[int, ...]:
        """Sorted servers holding ``block`` (empty tuple = data lost)."""
        try:
            return tuple(sorted(self._replicas[block]))
        except KeyError:
            raise KeyError(
                f"unknown block {block!r}; registered: {len(self._replicas)} blocks"
            ) from None

    def eligible(self, *blocks: str) -> tuple[int, ...]:
        """Servers holding a replica of *every* given block (sorted).

        This is the serve-layer contract: a replica can serve a
        (model, adapter) pair only if it holds both.  Raises
        :class:`ValueError` when the intersection is empty — no silent
        fallback to "anywhere", which would break data locality.
        """
        if not blocks:
            raise ValueError("eligible() needs at least one block")
        out: set[int] | None = None
        for block in blocks:
            holders = set(self._replicas.get(block, ()))
            if block not in self._replicas:
                raise KeyError(f"unknown block {block!r}")
            out = holders if out is None else out & holders
        assert out is not None
        if not out:
            raise ValueError(
                f"no server holds all of {blocks!r} — placement cannot "
                "satisfy the request (re-replicate or widen placement)"
            )
        return tuple(sorted(out))

    def blocks_on(self, server: int) -> list[str]:
        self._check_server(server)
        return sorted(b for b, reps in self._replicas.items() if server in reps)

    def active_servers(self) -> tuple[int, ...]:
        return tuple(int(m) for m in np.flatnonzero(self._active))

    def server_load(self) -> dict[int, int]:
        """Replica count hosted per active server (0 for empty servers)."""
        load = {m: 0 for m in self.active_servers()}
        for reps in self._replicas.values():
            for m in reps:
                if m in load:
                    load[m] += 1
        return load

    def access_count(self, block: str) -> int:
        return self._access.get(block, 0)

    def snapshot(self) -> dict[str, tuple[int, ...]]:
        return {b: tuple(sorted(reps)) for b, reps in self._replicas.items()}

    # ---- mutation --------------------------------------------------------

    def _check_server(self, server: int) -> None:
        if not 0 <= server < self.n_servers:
            raise ValueError(
                f"server {server} out of range 0..{self.n_servers - 1}"
            )

    def add_block(self, block: str, servers) -> tuple[int, ...]:
        """Register a new block with its initial replica set."""
        if not block or not isinstance(block, str):
            raise ValueError(f"block id must be a non-empty string, got {block!r}")
        if block in self._replicas:
            raise ValueError(f"block {block!r} already registered")
        servers = tuple(sorted({int(m) for m in servers}))
        if not servers:
            raise ValueError(f"block {block!r} needs at least one replica")
        for m in servers:
            self._check_server(m)
            if not self._active[m]:
                raise ValueError(f"server {m} is not active")
        self._replicas[block] = set(servers)
        self.version += 1
        return servers

    def place_block(
        self,
        block: str,
        rng: np.random.Generator,
        *,
        zipf_alpha: float,
        avail_lo: int,
        avail_hi: int,
    ) -> tuple[int, ...]:
        """Register ``block`` under the paper's Zipf placement model.

        Consumes ``rng`` exactly like the trace-time ``group_servers`` —
        seeding a trace through the store is bit-identical to the frozen
        tuples it replaces.
        """
        return self.add_block(
            block, zipf_servers(self.n_servers, rng, zipf_alpha, avail_lo, avail_hi)
        )

    def add_replica(self, block: str, server: int) -> bool:
        """Add a replica; returns False if the server already holds one."""
        self._check_server(server)
        if not self._active[server]:
            raise ValueError(f"server {server} is not active")
        reps = self._replicas.get(block)
        if reps is None:
            raise KeyError(f"unknown block {block!r}")
        if server in reps:
            return False
        reps.add(server)
        self.version += 1
        self.replicas_added += 1
        obs = _obs_active()
        if obs is not None:
            obs.placement_event(obs.sim_now, "add", block, server)
        return True

    def evict(self, block: str, server: int) -> bool:
        """Delete one replica; returns False if it wasn't there.

        Evicting the last replica is allowed — the block's data is then
        lost, and resolutions return an empty set (jobs depending on it
        fail, mirroring a fault that takes out the last live replica).
        """
        self._check_server(server)
        reps = self._replicas.get(block)
        if reps is None:
            raise KeyError(f"unknown block {block!r}")
        if server not in reps:
            return False
        reps.discard(server)
        self.version += 1
        self.replicas_evicted += 1
        obs = _obs_active()
        if obs is not None:
            obs.placement_event(obs.sim_now, "evict", block, server)
        return True

    def record_access(self, block: str, n: int = 1) -> None:
        """Count ``n`` accesses against ``block`` (drives hot-block
        re-replication; unknown blocks are ignored so serve-layer probes
        don't have to pre-register)."""
        if block in self._replicas:
            self._access[block] = self._access.get(block, 0) + int(n)

    def server_join(self, server: int) -> None:
        self._check_server(server)
        if not self._active[server]:
            self._active[server] = True
            self.version += 1
            obs = _obs_active()
            if obs is not None:
                obs.placement_event(obs.sim_now, "join", "", server)

    def server_leave(self, server: int) -> list[str]:
        """Deactivate a server, evicting every replica it holds; returns
        the affected blocks (callers re-place stranded work per block)."""
        self._check_server(server)
        affected = self.blocks_on(server)
        for block in affected:
            self._replicas[block].discard(server)
            self.replicas_evicted += 1
        if self._active[server] or affected:
            self.version += 1
        self._active[server] = False
        obs = _obs_active()
        if obs is not None:
            obs.placement_event(
                obs.sim_now, "leave", f"{len(affected)} blocks", server
            )
        return affected

    # ---- re-replication --------------------------------------------------

    def propose(self, rng: np.random.Generator | None = None) -> PlacementDelta:
        """Ask the replication policy for a rebalance delta (no mutation)."""
        rng = np.random.default_rng(0) if rng is None else rng
        return self.policy.rebalance(self, rng)

    def apply(self, delta: PlacementDelta) -> None:
        """Commit a delta (idempotent per pair: stale entries are no-ops)."""
        for block, server in delta.added:
            if block in self._replicas:
                self.add_replica(block, server)
        for block, server in delta.evicted:
            if block in self._replicas:
                self.evict(block, server)

    def rebalance(self, rng: np.random.Generator | None = None) -> PlacementDelta:
        """Propose + apply in one step (standalone use; the scheduling
        engine uses the split so evictions strand queued work)."""
        delta = self.propose(rng)
        self.apply(delta)
        return delta
