"""Locality-aware input pipeline.

The port's copy of ``repro/data/pipeline.py``, on the port's
:mod:`repro_torch.core` (``AssignmentProblem``, ``group_tasks``, the host
``water_filling``; any assignment function of the registry, such as
``wf_torch``, may be passed as ``assign``).  Batches come out as torch
tensors on the device the loader is given.

Training data lives in shards replicated across data hosts (GFS/HDFS-style
R-way placement) — exactly the paper's data chunks.  Every epoch the
loader must schedule "read shard s" tasks onto hosts that hold a replica;
the paper's algorithms do this with host queues as busy times:

  hosts = servers, shards = tasks, replica placement = ``S^r``,
  host read throughput = ``μ``, pending reads = ``b_m`` (eq. 2).

Shard groups (tasks sharing a replica set) arise naturally because
placement assigns consecutive shards to the same host window.

The loader is deterministic and resumable: batches are a pure function of
(seed, epoch, step), so restart-after-failure replays identically; a dead
host's shards are re-scheduled onto surviving replicas
(:meth:`ShardStore.fail_host`), mirroring the simulator's fault path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from ..core import AssignmentProblem, group_tasks, water_filling

__all__ = ["ShardStore", "LocalityAwareLoader"]


@dataclasses.dataclass
class ShardStore:
    """Synthetic token shards with replicated placement."""

    n_shards: int
    n_hosts: int
    replicas: int = 3
    tokens_per_shard: int = 4096
    vocab: int = 32000
    seed: int = 0

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        # R-way placement: anchor + consecutive hosts (the paper's window)
        anchors = rng.integers(0, self.n_hosts, self.n_shards)
        self.placement = [
            tuple(sorted({(a + i) % self.n_hosts for i in range(self.replicas)}))
            for a in anchors
        ]
        self.alive = np.ones(self.n_hosts, bool)

    def fail_host(self, host: int) -> None:
        self.alive[host] = False

    def live_placement(self, shard: int) -> tuple[int, ...]:
        servers = tuple(m for m in self.placement[shard] if self.alive[m])
        if not servers:
            raise IOError(f"shard {shard}: all replicas lost")
        return servers

    def read(self, shard: int, host: int) -> np.ndarray:
        """Deterministic synthetic shard contents (host arg models the
        locality-constrained read; contents depend only on the shard)."""
        if host not in self.live_placement(shard):
            raise IOError(f"host {host} holds no replica of shard {shard}")
        rng = np.random.default_rng(self.seed * 1_000_003 + shard)
        return rng.integers(
            0, self.vocab, self.tokens_per_shard, dtype=np.int32
        )


class LocalityAwareLoader:
    """Epoch-wise shard scheduling + deterministic batch assembly."""

    def __init__(
        self,
        store: ShardStore,
        *,
        batch_tokens: int,
        seq_len: int,
        reads_per_tick: int = 4,
        assign: Callable = water_filling,
        seed: int = 0,
        device: str | torch.device = "cpu",
    ):
        self.store = store
        self.batch_tokens = batch_tokens
        self.seq_len = seq_len
        self.mu = np.full(store.n_hosts, reads_per_tick, np.int64)
        self.assign = assign
        self.seed = seed
        self.device = torch.device(device)
        self.host_backlog = np.zeros(store.n_hosts, np.int64)

    def schedule_epoch(self, epoch: int) -> dict[int, list[int]]:
        """Assign every shard to a host for this epoch (the paper's task
        assignment: one job whose task groups are the shard groups)."""
        order = np.random.default_rng(self.seed + epoch).permutation(
            self.store.n_shards
        )
        placements = [self.store.live_placement(int(s)) for s in order]
        groups = group_tasks(placements)
        busy = -(-self.host_backlog // self.mu)
        prob = AssignmentProblem(busy=busy, mu=self.mu, groups=groups)
        assignment = self.assign(prob)
        assignment.validate(prob)
        # map group allocations back to concrete shard ids deterministically
        by_set: dict[tuple[int, ...], list[int]] = {}
        for s, pl in zip(order, placements):
            by_set.setdefault(pl, []).append(int(s))
        host_shards: dict[int, list[int]] = {}
        for g, per_server in zip(groups, assignment.alloc):
            pool = by_set[g.servers]
            idx = 0
            for host, cnt in sorted(per_server.items()):
                for _ in range(cnt):
                    host_shards.setdefault(host, []).append(pool[idx])
                    idx += 1
        return host_shards

    def batches(self, epoch: int) -> Iterator[torch.Tensor]:
        """Yield (B, seq_len) int32 token batches for one epoch, on the
        loader's device.

        Batch contents follow the epoch permutation of shards — a pure
        function of (seed, epoch) — so training replays identically no
        matter which hosts actually serve the reads (locality changes
        throughput, never data order)."""
        host_shards = self.schedule_epoch(epoch)
        shard_host = {s: h for h, shards in host_shards.items() for s in shards}
        order = np.random.default_rng(self.seed + epoch).permutation(
            self.store.n_shards
        )
        buffers = [self.store.read(int(s), shard_host[int(s)]) for s in order]
        stream = np.concatenate(buffers) if buffers else np.zeros(0, np.int32)
        bsz = self.batch_tokens // self.seq_len
        per_batch = bsz * self.seq_len
        for i in range(len(stream) // per_batch):
            chunk = stream[i * per_batch : (i + 1) * per_batch]
            yield torch.from_numpy(chunk.reshape(bsz, self.seq_len)).to(self.device)
