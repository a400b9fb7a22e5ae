"""Serving engine: prefill/decode steps + continuous batching.

The port's counterpart of ``repro/serve/engine.py``.  ``ServeEngine``
keeps a fixed-capacity decode batch; requests join at free slots (their
prompt fed into the shared cache at the slot's rows, token by token)
and leave on EOS/length.  Request→replica routing for multi-replica
deployments uses the paper's WF (each inference replica = a server; its
queued tokens = busy time) via :class:`ReplicaRouter`; with
``policy="wf_torch"`` the water level runs on the card.

With ``placement=`` (a :class:`repro_torch.placement.PlacementStore`)
the router resolves eligible replicas by model / adapter ID.  As in the
reference, ``ServeEngine(debug=True)`` arms the buffer-aliasing guard
(:class:`repro_torch.analysis.runtime.BufferGuard`) around every decode
step, and an ambient :mod:`repro_torch.obs` session profiles each decode
step (``device.serve-decode.*``) and counts each routing
(``serve.routed``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import backend
from ..analysis import runtime as sanitizers
from ..core import AssignmentProblem, TaskGroup
from ..models import LM, ModelConfig, decode_step, init_decode_cache, prefill
from ..obs.session import active as _obs_active
from ..obs.session import device_profiler as _obs_device
from ..placement.store import lora_block, model_block
from ..runtime.policies import AssignFn, get_assigner

__all__ = [
    "make_prefill_step",
    "make_decode_step",
    "Request",
    "ServeEngine",
    "ReplicaRouter",
    "RoutedServePool",
]


def make_prefill_step(cfg: ModelConfig, *, max_len: int | None = None) -> Callable:
    def step(params, batch):
        return prefill(params, cfg, batch, max_len=max_len)

    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def step(params, tokens, cache):
        return decode_step(params, cfg, tokens, cache)

    return step


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)  # new only
    done: bool = False
    _last: int = -1  # last token fed to the model (prompt tail, then new)


class ServeEngine:
    """Single-replica continuous batching over a shared decode cache.

    Runs on :func:`repro_torch.backend.device` (``cuda`` unless scoped);
    ``params`` (any family the port runs) must already live there.  The
    cache is updated in place by every decode step.

    As the reference's, every decode step feeds every slot: a prompt is
    fed one token at a time with pad token 0 in the other slots, and
    free slots get token 0 too.  A KV cache masks those tokens out by the
    slots' positions; a Mamba2 state does not — each pad token advances
    every other slot's conv and SSM state, and a reused slot keeps the
    state its last request left.  The port keeps this so that its tokens
    equal the reference's.

    ``debug=True`` (or a process-wide :func:`repro_torch.analysis.runtime.
    enable`) arms the buffer-aliasing sanitizer: every decode step
    snapshots the position buffer at the handoff and re-checks it after
    the step's host read, catching the zero-copy aliasing race (a view of
    the live ``_pos`` handed to the step) the moment it is reintroduced.
    """

    def __init__(
        self,
        params: LM,
        cfg: ModelConfig,
        *,
        batch_slots: int = 8,
        max_len: int = 512,
        eos_token: int = 0,
        debug: bool = False,
    ):
        self.params = params
        self.cfg = cfg
        self.device = backend.device()
        self.slots: list[Request | None] = [None] * batch_slots
        self.max_len = max_len
        self.eos = eos_token
        self.cache = init_decode_cache(params, cfg, batch_slots, max_len)
        self._pos = np.zeros(batch_slots, np.int32)
        self._pending: list[Request] = []
        self.debug = debug or sanitizers.enabled()
        self._guard = sanitizers.BufferGuard() if self.debug else None

    def submit(self, req: Request) -> None:
        self._pending.append(req)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is not None or not self._pending:
                continue
            req = self._pending.pop(0)
            # prefill the prompt into this slot's cache rows, token by token
            # (batched prompt prefill for a single slot of a shared cache)
            toks = req.prompt
            for t in toks[:-1]:
                self._step_single(i, int(t))
            req._last = int(toks[-1])
            self.slots[i] = req

    def _decode(self, tokens: np.ndarray) -> torch.Tensor:
        tokens = torch.from_numpy(tokens).to(self.device)
        logits, self.cache = decode_step(self.params, self.cfg, tokens, self._with_pos())
        return logits

    def _step_single(self, slot: int, token: int) -> int:
        """Advance one slot by one token (other slots fed a pad token —
        masked out of a KV cache by per-slot positions, not out of a
        Mamba2 state; see the class docstring)."""
        tokens = np.zeros((len(self.slots), 1), np.int32)
        tokens[slot, 0] = token
        prof = _obs_device()
        t0 = prof.start() if prof is not None else 0.0
        logits = self._decode(tokens)
        # only commit slot's position advance
        self._pos[slot] += 1
        nxt = int(logits[slot, 0].argmax())
        if prof is not None:  # past the host read: the step's whole wall time
            prof.record("serve-decode", (len(self.slots),), t0)
        if self._guard is not None:  # the step has completed above
            self._guard.verify()
        return nxt

    def _with_pos(self) -> dict:
        cache = dict(self.cache)
        # torch.tensor copies: _step_single / step mutate self._pos in
        # place right after dispatch, so the step must not read a view of
        # it (torch.from_numpy would share the buffer — the reference's
        # PR 5 race, shifted decode outputs under load)
        cache["pos"] = torch.tensor(self._pos, device=self.device)
        if self._guard is not None:
            self._guard.capture("pos", self._pos, cache["pos"])
        return cache

    def step(self) -> list[Request]:
        """One decode step over all active slots; returns finished requests."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return []
        tokens = np.zeros((len(self.slots), 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slots[i]._last
        prof = _obs_device()
        t0 = prof.start() if prof is not None else 0.0
        logits = self._decode(tokens)
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
        if prof is not None:  # past the host read: the step's whole wall time
            prof.record("serve-decode", (len(self.slots),), t0)
        if self._guard is not None:  # the step has completed above
            self._guard.verify()
        finished = []
        for i in active:
            req = self.slots[i]
            self._pos[i] += 1
            req.generated.append(int(nxt[i]))
            req._last = int(nxt[i])
            if (
                int(nxt[i]) == self.eos
                or len(req.generated) >= req.max_new_tokens
                or self._pos[i] >= self.max_len - 1
            ):
                req.done = True
                finished.append(req)
                self.slots[i] = None
        return finished


class ReplicaRouter:
    """Route request batches across inference replicas with a registered
    assignment policy (the paper's WF by default).

    Replicas = servers; a request batch = a single-group job whose
    available servers are the replicas holding the requested model/LoRA;
    busy time = queued tokens / replica throughput (eq. 2 analogue).
    ``policy`` is any name the port's
    :func:`~repro_torch.runtime.policies.get_assigner` knows (``"wf"``,
    ``"wf_torch"``, ``"obta"``, ``"rd_torch"``, …) or a callable
    assignment function.

    With ``placement`` (a :class:`repro_torch.placement.PlacementStore`
    holding ``model/<name>`` and ``lora/<name>`` blocks), callers stop
    passing ``eligible`` by hand: ``route(n, model="qwen", adapter="x")``
    resolves the replicas holding *both* the model and the adapter, and
    records the access so hot-model re-replication can widen the set on
    the next rebalance.
    """

    def __init__(
        self,
        n_replicas: int,
        tokens_per_step: int = 1024,
        *,
        policy: str | AssignFn = "wf",
        placement=None,
    ):
        self.n = n_replicas
        self.rate = np.full(n_replicas, tokens_per_step, np.int64)
        self.queued = np.zeros(n_replicas, np.int64)
        self.assign = get_assigner(policy) if isinstance(policy, str) else policy
        if placement is not None and placement.n_servers != n_replicas:
            raise ValueError(
                f"placement store spans {placement.n_servers} servers, "
                f"router has {n_replicas} replicas"
            )
        self.placement = placement

    def _resolve_eligible(
        self, n_tokens: int, model: str | None, adapter: str | None
    ) -> tuple[int, ...] | None:
        if model is None and adapter is None:
            return None
        if self.placement is None:
            raise ValueError(
                "routing by model/adapter ID needs a placement store "
                "(pass placement= to ReplicaRouter)"
            )
        blocks = []
        if model is not None:
            blocks.append(model_block(model))
        if adapter is not None:
            blocks.append(lora_block(adapter))
        eligible = self.placement.eligible(*blocks)
        for block in blocks:
            self.placement.record_access(block, n_tokens)
        return eligible

    def route(
        self,
        n_tokens: int,
        eligible: tuple[int, ...] | None = None,
        *,
        model: str | None = None,
        adapter: str | None = None,
    ) -> dict[int, int]:
        """Assign ``n_tokens`` of work; returns {replica: tokens}.

        ``eligible`` may be given explicitly or derived from placement
        via ``model``/``adapter`` IDs; without either, every replica is
        eligible.
        """
        if eligible is None:
            eligible = self._resolve_eligible(n_tokens, model, adapter)
        eligible = eligible or tuple(range(self.n))
        busy = -(-self.queued // self.rate)  # slots, eq. 2
        prob = AssignmentProblem(
            busy=busy,
            mu=self.rate,
            groups=(TaskGroup(n_tokens, eligible),),
        )
        assignment = self.assign(prob)
        out: dict[int, int] = {}
        for per in assignment.alloc:
            for m, cnt in per.items():
                self.queued[m] += cnt
                out[m] = out.get(m, 0) + cnt
        obs = _obs_active()
        if obs is not None:
            obs.serve_routed(len(out))
        return out

    def drain(self) -> None:
        """One time step: each replica consumes up to its rate."""
        self.queued = np.maximum(self.queued - self.rate, 0)


class RoutedServePool:
    """A fleet of :class:`ServeEngine` replicas behind one
    :class:`ReplicaRouter`.

    Each request is costed at ``len(prompt) + max_new_tokens`` tokens,
    routed by the registered policy over the replicas holding its
    model/LoRA (live placement store) or the eligible replicas, and
    admitted to the replica that received the bulk of the routed tokens.
    One :meth:`step` is one slot: every replica decodes once; driving it
    from a :class:`repro_torch.runtime.loop.ControlPlane` heartbeat puts
    decode progress on the same event timeline as cluster scheduling.
    """

    def __init__(self, engines: dict[int, ServeEngine], router: ReplicaRouter):
        if router.n < 1 + max(engines, default=0) or not engines:
            raise ValueError("router must span every replica id in engines")
        self.engines = engines
        self.router = router

    def submit(
        self,
        req: Request,
        *,
        model: str | None = None,
        adapter: str | None = None,
        eligible: tuple[int, ...] | None = None,
    ) -> int:
        """Route ``req`` and admit it to a replica; returns the replica id."""
        if eligible is None and model is None and adapter is None:
            eligible = tuple(self.engines)
        cost = len(req.prompt) + req.max_new_tokens
        out = self.router.route(cost, eligible, model=model, adapter=adapter)
        # a discrete request runs on ONE replica: the one the policy gave
        # the bulk of its tokens (splits only arise at the water level)
        routed = [kv for kv in out.items() if kv[0] in self.engines]
        if not routed:
            raise ValueError(
                f"request {req.request_id} routed to replicas {sorted(out)} "
                f"but no engine serves any of them"
            )
        replica = max(routed, key=lambda kv: (kv[1], -kv[0]))[0]
        self.engines[replica].submit(req)
        return replica

    def step(self) -> list[Request]:
        """One slot: every replica decodes once, the router drains once."""
        finished: list[Request] = []
        for engine in self.engines.values():
            finished.extend(engine.step())
        self.router.drain()
        return finished

    def busy(self) -> bool:
        return (
            bool(self.router.queued.any())
            or any(e._pending for e in self.engines.values())
            or any(
                slot is not None
                for e in self.engines.values()
                for slot in e.slots
            )
        )
