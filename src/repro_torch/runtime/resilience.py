"""Overload-hardening config + feedback state for the control plane.

The port's copy of ``repro/runtime/resilience.py``.  Every tunable
threshold the online mechanisms consult lives in one frozen dataclass,
:class:`ResilienceConfig` — reprolint rule **R009** enforces that no lag
budget, speculation cap, steal gain, or retry limit appears as a
scattered numeric literal anywhere else in the runtime (the rule's
exemption names the reference's module, so each threshold
here carries an inline pragma).  The degradation ladder the knobs
parameterize (documented in ``docs/RESILIENCE.md``) is:

1. **steal** — idle servers pull ~half a backlogged donor's eq. 2 cost
   in locality-eligible fragments (dask-style half-split), subject to a
   minimum-gain threshold and exponential backoff on donors that keep
   yielding nothing;
2. **speculate** — straggling head fragments are cloned, but only
   within a global budget of concurrent shadow pairs and a per-job
   quota; the budget adapts from the observed clone win rate;
3. **defer** — when the eq. 2 service clock falls behind the arrival
   clock past ``lag_defer_budget``, new jobs wait in a bounded pending
   queue instead of being enqueued;
4. **shed** — past ``lag_shed_budget`` (or a full pending queue) jobs
   are dropped outright, recorded on ``SimResult.shed_jobs`` with their
   would-be arrival slots, keeping the event heap bounded at ρ > 1;
5. **retry** — a job that loses its last live replica mid-flight
   (server or rack failure) parks its stranded fragment and retries
   placement with exponential backoff instead of failing immediately,
   up to ``retry_limit`` attempts.

:class:`ResilienceState` is the runtime side: per-server service-rate
EWMAs for progress-based straggler detection, donor backoff clocks,
the adaptive speculation budget, the deferred/shed/parked job books —
and a **private** :class:`repro_torch.obs.metrics.Metrics` registry.
The private registry is the load-bearing design point: budget
adaptation *reads back* spec win/loss counters, so those counters must
exist whatever observes the run — feeding decisions from an ambient
observability session would make schedules depend on whether
observability is on (the reference pins on ≡ off in
``tests/test_obs.py``).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from ..obs.metrics import Metrics

__all__ = ["ResilienceConfig", "ResilienceState"]


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """All thresholds the resilience mechanisms consult (R009: the one
    sanctioned home for these numbers).  Defaults keep every *gating*
    feature off: admission and retry must be opted into, and the steal /
    speculation knobs only matter once ``stealing=True`` /
    ``speculation=True`` is requested on the plane."""

    # -- cost-based work-stealing -----------------------------------------
    # minimum donor-side eq. 2 cost a steal must move to be worth the
    # re-placement call; below it the donor counts as a miss
    steal_min_gain: int = 1
    # consecutive-miss backoff: wait base << misses slots, capped
    steal_backoff_base: int = 2  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    steal_backoff_max: int = 32  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    # -- budgeted speculation ---------------------------------------------
    # a head fragment is a straggler when the best peer serving the same
    # job (or the best idle eligible target) progresses at >= spec_factor
    # times this server's observed rate
    spec_factor: float = 2.0  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    # concurrent shadow-pair cap, adapted within [min, max] from the
    # observed clone win rate every spec_adapt_every service ticks
    spec_budget: int = 4  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    spec_budget_min: int = 1
    spec_budget_max: int = 16  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    spec_adapt_every: int = 64  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    # resolved pairs needed before adapting
    spec_adapt_samples: int = 8  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    # clone win rate that grows the budget
    spec_raise_rate: float = 0.5  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    # clone win rate that shrinks it
    spec_lower_rate: float = 0.2  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    # clone launches per job, lifetime
    spec_job_quota: int = 2  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    # progress-based detection: a server must have served the same head
    # job for this many consecutive ticks before its EWMA rate counts
    spec_detect_window: int = 4  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    spec_ewma_alpha: float = 0.5  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    # -- admission control / load shedding --------------------------------
    admission: bool = False
    # defer new arrivals once max eq. 2 backlog exceeds this many slots
    lag_defer_budget: int = 64  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    # shed them outright past this lag (or once the pending queue fills)
    lag_shed_budget: int = 256  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    defer_queue_cap: int = 512  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    # -- retry-with-backoff on data loss ----------------------------------
    retry: bool = False
    retry_limit: int = 3  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    retry_backoff_base: int = 4  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home
    retry_backoff_max: int = 64  # reprolint: disable=R009 the port's ResilienceConfig is its thresholds' one home

    def needs_state(self, stealing: bool, speculation: bool) -> bool:
        """Whether a plane with these flags needs a ResilienceState at
        all — False keeps the default path allocation-free."""
        return stealing or speculation or self.admission or self.retry


class ResilienceState:
    """Mutable feedback state for one :class:`ControlPlane` run."""

    def __init__(self, cfg: ResilienceConfig, n_servers: int):
        self.cfg = cfg
        # private registry (see module docstring): decision inputs live
        # here so they exist whatever observes the run
        self.metrics = Metrics()
        # per-server observed service: EWMA tasks/tick, the head job it
        # was measured against, and the consecutive-tick streak on it
        self.rate = np.zeros(n_servers, dtype=np.float64)
        self.head_job = np.zeros(n_servers, dtype=np.int64)
        self.head_streak = np.zeros(n_servers, dtype=np.int64)
        self.ticks = 0
        # adaptive speculation budget + per-job launch quota accounting
        self.spec_budget = cfg.spec_budget
        self.spec_launched: dict[int, int] = {}
        self._adapted_at = 0
        self._wins_seen = 0
        self._resolved_seen = 0
        # donor backoff: consecutive misses and the next slot a steal
        # from that donor may be attempted
        self.steal_miss: dict[int, int] = {}
        self.steal_wait: dict[int, int] = {}
        # admission books
        self.deferred: deque = deque()
        self.deferred_peak = 0
        self.shed: dict[int, int] = {}  # job_id -> would-be arrival slot
        # retry books: stranded fragments parked per job + attempt counts
        self.parked: dict[int, dict[int, int]] = {}
        self.retry_due: set[int] = set()
        self.retry_attempts: dict[int, int] = {}

    # ---- progress observation (straggler detection input) ----------------

    def observe_service(self, cluster) -> None:
        """Fold one service tick's per-server progress
        (:attr:`ClusterState.last_progress` / ``last_head_job``) into the
        rate EWMAs.  A server restarts its streak whenever the head job
        changes or it sat idle, so :attr:`rate` always describes the
        fragment currently in service."""
        a = self.cfg.spec_ewma_alpha
        prog = cluster.last_progress
        served = prog > 0
        head = cluster.last_head_job
        same = served & (self.head_job == head) & (self.head_streak > 0)
        fresh = prog.astype(np.float64)
        self.rate = np.where(same, (1.0 - a) * self.rate + a * fresh, fresh)
        self.head_streak = np.where(
            same, self.head_streak + 1, served.astype(np.int64)
        )
        self.head_job = np.where(served, head, self.head_job)
        self.ticks += 1

    # ---- speculation budget ----------------------------------------------

    def record_spec_outcome(self, name: str) -> None:
        """Mirror a pair resolution (``spec.won_clone`` /
        ``spec.won_original`` / ``spec.aborted``) into the private
        registry the budget adaptation reads."""
        self.metrics.inc(name)

    def adapted_spec_budget(self) -> int:
        """Current concurrent-pair cap; every ``spec_adapt_every`` ticks
        the observed clone win rate moves it one step within
        ``[spec_budget_min, spec_budget_max]``."""
        cfg = self.cfg
        if self.ticks - self._adapted_at < cfg.spec_adapt_every:
            return self.spec_budget
        self._adapted_at = self.ticks
        m = self.metrics
        wins = m.counter("spec.won_clone")
        resolved = (
            wins + m.counter("spec.won_original") + m.counter("spec.aborted")
        )
        d_resolved = resolved - self._resolved_seen
        if d_resolved < cfg.spec_adapt_samples:
            return self.spec_budget
        win_rate = (wins - self._wins_seen) / d_resolved
        self._wins_seen, self._resolved_seen = wins, resolved
        if win_rate >= cfg.spec_raise_rate:
            self.spec_budget = min(self.spec_budget + 1, cfg.spec_budget_max)
        elif win_rate <= cfg.spec_lower_rate:
            self.spec_budget = max(self.spec_budget - 1, cfg.spec_budget_min)
        m.set_gauge("spec.budget", float(self.spec_budget))
        return self.spec_budget

    # ---- steal backoff -----------------------------------------------------

    def steal_ready(self, donor: int, now: int) -> bool:
        return self.steal_wait.get(donor, 0) <= now

    def steal_missed(self, donor: int, now: int) -> None:
        miss = self.steal_miss.get(donor, 0)
        wait = min(
            self.cfg.steal_backoff_base << miss, self.cfg.steal_backoff_max
        )
        self.steal_miss[donor] = miss + 1
        self.steal_wait[donor] = now + wait
        self.metrics.inc("steal.rejected")

    def steal_won(self, donor: int) -> None:
        self.steal_miss.pop(donor, None)
        self.steal_wait.pop(donor, None)
