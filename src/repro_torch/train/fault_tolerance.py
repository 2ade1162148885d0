"""Fault tolerance for long multi-host runs: heartbeats, straggler
mitigation, elastic re-meshing (the port's own copy of
``repro/train/fault_tolerance.py``; pure Python).

The multi-host control plane is written against an abstract host feed and
simulated in tests — the policies (what to do on a dead host, how to
shrink the mesh, when to declare a straggler) are the deliverable; the
transport is a thin injection point.  Every time source is injectable
(``clock=``), so virtual-clock tests never mix time scales.

Policies implemented:

  * Heartbeat monitor — a host missing ``dead_after`` consecutive beats is
    declared dead and triggers an elastic plan.
  * Straggler detection — per-step durations are tracked per host with a
    robust (median + MAD) outlier rule; persistent stragglers are evicted.
  * Elastic re-mesh — on host loss, choose the largest data-parallel extent
    that keeps every model-parallel group whole, and emit the new mesh
    shape + the checkpoint step to restore from.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class HostInfo:
    host_id: int
    chips: int = 4                   # chips per host
    last_beat: float = 0.0
    missed: int = 0
    alive: bool = True


class HeartbeatMonitor:
    """``clock`` is the injectable time source (default
    ``time.monotonic``); virtual-clock tests must pass their own so beat
    and sweep timestamps never mix time scales."""

    def __init__(self, n_hosts: int, interval_s: float = 10.0,
                 dead_after: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        # last_beat starts at the construction-time clock reading, NOT
        # the HostInfo default of 0.0: against a monotonic clock,
        # now - 0.0 is the machine uptime, so a fresh monitor's first
        # sweep() would declare every host dead before any beat arrived.
        now = clock()
        self.hosts = {i: HostInfo(i, last_beat=now) for i in range(n_hosts)}
        self.interval = interval_s
        self.dead_after = dead_after

    def beat(self, host_id: int, t: Optional[float] = None) -> None:
        h = self.hosts[host_id]
        h.last_beat = self.clock() if t is None else t
        h.missed = 0
        h.alive = True

    def sweep(self, now: Optional[float] = None) -> List[int]:
        """Returns newly-dead host ids."""
        now = self.clock() if now is None else now
        newly_dead = []
        for h in self.hosts.values():
            if not h.alive:
                continue
            if now - h.last_beat > self.interval:
                h.missed = int((now - h.last_beat) // self.interval)
                if h.missed >= self.dead_after:
                    h.alive = False
                    newly_dead.append(h.host_id)
        return newly_dead

    @property
    def alive_hosts(self) -> List[int]:
        return [h.host_id for h in self.hosts.values() if h.alive]


class StragglerDetector:
    """Median + MAD outlier rule over a sliding window of step times.

    ``clock`` is the injectable time source (same convention as
    :class:`HeartbeatMonitor`).  ``stale_after`` (seconds, optional)
    drops hosts whose last sample is older than that from ``classify``:
    a dead host otherwise keeps its final step time in the window
    forever, polluting the median every call."""

    def __init__(self, window: int = 32, threshold: float = 4.0,
                 evict_after: int = 16,
                 clock: Callable[[], float] = time.monotonic,
                 stale_after: Optional[float] = None):
        self.window = window
        self.threshold = threshold
        self.evict_after = evict_after
        self.clock = clock
        self.stale_after = stale_after
        self.times: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=window))
        self.last_seen: Dict[int, float] = {}
        self.strikes: Dict[int, int] = defaultdict(int)

    def record(self, host_id: int, step_time_s: float,
               t: Optional[float] = None) -> None:
        self.times[host_id].append(step_time_s)
        self.last_seen[host_id] = self.clock() if t is None else t

    def classify(self, now: Optional[float] = None
                 ) -> Tuple[List[int], List[int]]:
        """Returns (stragglers, evictions)."""
        import statistics
        latest = {h: t[-1] for h, t in self.times.items() if t}
        if self.stale_after is not None:
            now = self.clock() if now is None else now
            latest = {h: v for h, v in latest.items()
                      if now - self.last_seen.get(h, now) <= self.stale_after}
        if len(latest) < 3:
            return [], []
        med = statistics.median(latest.values())
        mad = statistics.median(abs(v - med) for v in latest.values()) or 1e-9
        stragglers = [h for h, v in latest.items()
                      if (v - med) / mad > self.threshold]
        evictions = []
        for h in self.times:
            if h in stragglers:
                self.strikes[h] += 1
                if self.strikes[h] >= self.evict_after:
                    evictions.append(h)
            else:
                self.strikes[h] = max(0, self.strikes[h] - 1)
        return stragglers, evictions


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_chips: int
    restore_step: Optional[int]
    dropped_hosts: Tuple[int, ...]


def plan_remesh(alive_chips: int, *, model_parallel: int,
                pods: int = 1, chips_per_pod: Optional[int] = None,
                restore_step: Optional[int] = None,
                dropped_hosts: Tuple[int, ...] = ()) -> ElasticPlan:
    """Largest mesh that keeps TP groups whole.

    data' = floor(alive_chips / (pods · model_parallel)); requires ≥ 1.
    The batch is re-split over data'."""
    per_pod = alive_chips // max(pods, 1)
    data = per_pod // model_parallel
    if data < 1:
        raise RuntimeError(
            f"cannot keep TP groups of {model_parallel} with "
            f"{alive_chips} chips")
    if pods > 1:
        return ElasticPlan((pods, data, model_parallel),
                           ("pod", "data", "model"),
                           pods * data * model_parallel,
                           restore_step, dropped_hosts)
    return ElasticPlan((data, model_parallel), ("data", "model"),
                       data * model_parallel, restore_step, dropped_hosts)


class FaultTolerantRunner:
    """Glue: monitor + detector + checkpoint directory -> elastic restart
    loop.  Call ``on_step`` every step with per-host timings; it raises
    ``ElasticRestart`` carrying the new plan when the world must change."""

    class ElasticRestart(Exception):
        def __init__(self, plan: ElasticPlan):
            super().__init__(f"elastic restart -> {plan}")
            self.plan = plan

    def __init__(self, n_hosts: int, model_parallel: int, pods: int = 1,
                 chips_per_host: int = 4, ckpt_dir: str = "",
                 clock: Callable[[], float] = time.monotonic):
        self.monitor = HeartbeatMonitor(n_hosts, clock=clock)
        self.detector = StragglerDetector(clock=clock)
        self.model_parallel = model_parallel
        self.pods = pods
        self.chips_per_host = chips_per_host
        self.ckpt_dir = ckpt_dir

    def on_step(self, step: int, host_times: Dict[int, float],
                now: Optional[float] = None) -> None:
        for h, t in host_times.items():
            self.monitor.beat(h, now)
            self.detector.record(h, t, now)
        dead = self.monitor.sweep(now)
        _, evict = self.detector.classify()
        if dead or evict:
            dropped = tuple(sorted(set(dead) | set(evict)))
            for h in dropped:
                self.monitor.hosts[h].alive = False
            alive = len(self.monitor.alive_hosts) * self.chips_per_host
            from .checkpoint import latest_step
            plan = plan_remesh(
                alive, model_parallel=self.model_parallel, pods=self.pods,
                restore_step=latest_step(self.ckpt_dir) if self.ckpt_dir
                else None,
                dropped_hosts=dropped)
            raise FaultTolerantRunner.ElasticRestart(plan)
