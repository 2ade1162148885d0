"""The port's fault-tolerance policies (``repro_torch/train/
fault_tolerance.py``) against the JAX package's: under one virtual clock
the heartbeat deaths, the straggler classes and evictions, the re-mesh
plans and ``FaultTolerantRunner``'s ``ElasticRestart`` plan are equal,
event for event."""
import os
import tempfile

import numpy as np
import pytest

from repro.train import checkpoint as JC
from repro.train import fault_tolerance as J
from repro_torch.train import checkpoint as TC
from repro_torch.train import fault_tolerance as T


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _beats(seed, n_hosts, steps):
    """Per step: the hosts that beat (some stop for good, some skip)."""
    rng = np.random.default_rng(seed)
    dies = {int(h): int(rng.integers(2, steps)) for h in
            rng.choice(n_hosts, size=max(1, n_hosts // 4), replace=False)}
    out = []
    for step in range(steps):
        out.append([h for h in range(n_hosts)
                    if dies.get(h, steps) > step and rng.random() > 0.1])
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("interval,dead_after", [(1.0, 2), (10.0, 3)])
def test_heartbeat_deaths_match_jax(seed, interval, dead_after):
    cj, ct = Clock(), Clock()
    mj = J.HeartbeatMonitor(8, interval_s=interval, dead_after=dead_after,
                            clock=cj)
    mt = T.HeartbeatMonitor(8, interval_s=interval, dead_after=dead_after,
                            clock=ct)
    assert mt.sweep() == mj.sweep() == []
    for step, alive in enumerate(_beats(seed, 8, 30)):
        cj.t = ct.t = 1000.0 + 0.7 * interval * (step + 1)
        for h in alive:
            mj.beat(h)
            mt.beat(h)
        assert mt.sweep() == mj.sweep()
        assert mt.alive_hosts == mj.alive_hosts
        assert [(h.missed, h.alive, h.last_beat) for h in mt.hosts.values()] \
            == [(h.missed, h.alive, h.last_beat) for h in mj.hosts.values()]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("stale_after", [None, 3.0])
def test_straggler_classes_match_jax(seed, stale_after):
    rng = np.random.default_rng(seed)
    cj, ct = Clock(0.0), Clock(0.0)
    kw = dict(window=8, threshold=3.0, evict_after=3,
              stale_after=stale_after)
    dj = J.StragglerDetector(clock=cj, **kw)
    dt = T.StragglerDetector(clock=ct, **kw)
    slow = int(rng.integers(0, 6))
    gone = int(rng.integers(0, 6))
    for step in range(20):
        cj.t = ct.t = float(step)
        for h in range(6):
            if h == gone and step > 10:
                continue
            x = 1.0 + (2.5 if h == slow else 0.0) + 0.05 * rng.random()
            dj.record(h, x)
            dt.record(h, x)
        assert dt.classify() == dj.classify()
        assert dict(dt.strikes) == dict(dj.strikes)


@pytest.mark.parametrize("alive,mp,pods", [(28, 4, 1), (32, 8, 2),
                                           (7, 1, 1), (64, 4, 4)])
def test_plan_remesh_matches_jax(alive, mp, pods):
    assert T.plan_remesh(alive, model_parallel=mp, pods=pods,
                         restore_step=5, dropped_hosts=(1,)).__dict__ == \
        J.plan_remesh(alive, model_parallel=mp, pods=pods,
                      restore_step=5, dropped_hosts=(1,)).__dict__
    with pytest.raises(RuntimeError):
        T.plan_remesh(3, model_parallel=4)


@pytest.mark.parametrize("with_ckpt", [False, True])
def test_runner_elastic_restart_plan_matches_jax(with_ckpt):
    with tempfile.TemporaryDirectory() as d:
        jd, td = os.path.join(d, "j"), os.path.join(d, "t")
        if with_ckpt:
            for s in (3, 7):
                JC.save(jd, s, {"a": np.int32(s)})
                TC.save(td, s, {"a": np.int32(s)})
        plans = []
        for mod, ckpt_dir in ((J, jd), (T, td)):
            r = mod.FaultTolerantRunner(
                n_hosts=8, model_parallel=4, chips_per_host=4,
                ckpt_dir=ckpt_dir if with_ckpt else "", clock=Clock(100.0))
            r.on_step(0, {h: 1.0 for h in range(8)}, now=100.0)
            times = {h: 1.0 for h in range(8) if h != 3}
            with pytest.raises(mod.FaultTolerantRunner.ElasticRestart) as ei:
                for i in range(1, 10):
                    r.on_step(i, times, now=100.0 + 40 * i)
            plans.append((i, ei.value.plan.__dict__))
        assert plans[0] == plans[1]
        step, plan = plans[1]
        assert 3 in plan["dropped_hosts"]
        assert plan["restore_step"] == (7 if with_ckpt else None)


def test_first_sweep_does_not_declare_hosts_dead():
    mon = T.HeartbeatMonitor(4, interval_s=10.0, dead_after=3)
    assert mon.sweep() == []
    assert mon.alive_hosts == [0, 1, 2, 3]
