"""horovod_tpu_torch's fleet service (``fleet/``) against horovod_tpu's.

The pure parts through both packages: ``JobSpec`` validation and its JSON
round trip (a spec or a record written by one package is read by the
other), the reference's ``plan()`` goldens (tests/test_fleet.py:192-279),
and the durable queue, whose file either package's gateway reloads, an
unreadable one sidelined.  The scheduler's reference cases
(tests/test_fleet.py:281-478) run over the port's gateway with the
reference's fake runner; the card-set cases show that shrink, grow,
preempt and requeue on a 4-card host never give one card to two jobs,
and that a job's ``ElasticDriver`` maps its slot ``host:i`` to the i-th
card of its set.  Over HTTP, the port's client against the reference's
gateway and the reference's client against the port's: submit, status,
cancel, unsigned → 403, the tuning ``GET``/``PUT`` and the observe
``POST``/``GET``.  The submit CLI, ``hvdrun-torch --submit``, the
rendezvous port held by a gateway, the knobs, a host observer pushing to
a gateway, and a gloo drill: two jobs on one slot, a stop preemption and
a resume from the committed step bit-equal to the uninterrupted run."""

import glob
import json
import os
import socket
import sys
import time

import numpy as np
import pytest
import torch

import horovod_tpu.fleet as ref_fleet
from horovod_tpu.fleet.policy import JobView as RefJobView
from horovod_tpu.runner.hosts import HostInfo as RefHostInfo
import horovod_tpu_torch.fleet as fleet
from horovod_tpu_torch.fleet.job import JobRecord, JobSpec
from horovod_tpu_torch.fleet.policy import JobView, plan
from horovod_tpu_torch.runner.hosts import HostInfo

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


# ---------------------------------------------------------------------------
# Helpers (the reference's fake runner, and one that takes card sets)
# ---------------------------------------------------------------------------

class FakeRunner:
    """Scheduler-facing runner double: no processes, full control."""

    def __init__(self, rec, env):
        self.rec = rec
        self.env = env
        self.hosts = None
        self.np_now = 0
        self.resizes = []
        self.cancelled = False
        self.preempted = False
        self._rc = None
        self._commit = None

    def start(self, hosts):
        self.hosts = list(hosts)
        self.np_now = sum(h.slots for h in hosts)

    def resize(self, hosts, np, reason):
        self.hosts = list(hosts)
        self.np_now = np
        self.resizes.append((np, reason))
        return True

    def announce_resize(self):
        self.announced = getattr(self, "announced", 0) + 1
        return time.time()

    def preempt(self, reason):
        self.preempted = True
        self._rc = 78
        return True

    def cancel(self, reason):
        self.cancelled = True
        self._rc = 78
        return True

    def commit_now(self):
        gen = (self._commit or {}).get("generation", 0) + 1
        self._commit = {"ts": time.time(), "generation": gen}

    def last_commit(self):
        return self._commit

    def finish(self, rc):
        self._rc = rc

    def result(self):
        return self._rc

    def join(self, timeout=None):
        pass


class CardRunner(FakeRunner):
    """A fake runner that also takes the cards its job may use, as
    ``ElasticJobRunner`` hands them to its driver."""

    def __init__(self, rec, env):
        super().__init__(rec, env)
        self.cards = {}

    def seed_cards(self, card_sets):
        self.cards = {h: list(c) for h, c in card_sets.items()}


def _gateway(tmp_path, hosts, runner=FakeRunner, mod=fleet, **kw):
    """Ephemeral-port gateway whose scheduler is driven by tick()."""
    runners = {}

    def factory(rec, env):
        r = runner(rec, env)
        runners[rec.id] = r
        return r

    kw.setdefault("runner_factory", factory)
    kw.setdefault("preempt_grace_s", 5.0)
    gw = mod.FleetGateway(hosts, port=0, fleet_dir=str(tmp_path / "fl"),
                          tick_s=0.05, **kw)
    gw.start()
    return gw, f"127.0.0.1:{gw.port}", runners


def _fleet_events():
    from horovod_tpu_torch.debug import flight
    return [e for e in flight.snapshot()
            if str(e.get("kind", "")).startswith("fleet.")]


# ---------------------------------------------------------------------------
# Job spec and records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_job_spec_validation_and_roundtrip(pkg):
    S = JobSpec if pkg == "port" else ref_fleet.JobSpec
    assert S(command=[]).validate()
    assert S(command=["x"], min_np=0).validate()
    assert S(command=["x"], min_np=4, max_np=2).validate()
    assert S(command=["x"], tenant="").validate()
    assert S(command=["x"], kind="cron").validate()
    assert S(command=["x"], env={"A": 1}).validate()
    spec = S(command=["python", "t.py"], min_np=2, max_np=8, priority=3,
             tenant="research", env={"A": "1"}, checkpoint_dir="/ckpt",
             max_queue_s=60.0, kind="service")
    assert spec.validate() is None
    assert S.from_dict(spec.to_dict()) == spec
    d = spec.to_dict()
    d["future_field"] = True
    assert S.from_dict(d) == spec
    s = S(command=["x"], min_np="2", max_np="4", priority="5",
          max_queue_s="1.5")
    assert (s.min_np, s.max_np, s.priority, s.max_queue_s) == (2, 4, 5, 1.5)
    with pytest.raises((ValueError, TypeError)):
        S(command=["x"], priority="high")


def test_specs_and_records_cross_packages():
    spec = JobSpec(command=["python", "t.py"], min_np=2, max_np=8,
                   priority=3, tenant="research", env={"A": "1"},
                   max_queue_s=60.0, kind="service")
    ref = ref_fleet.JobSpec.from_dict(json.loads(json.dumps(spec.to_dict())))
    assert ref.to_dict() == spec.to_dict()
    rec = JobRecord(id="abc", spec=spec, state=fleet.PREEMPTED,
                    submit_seq=4, submitted_at=1.5, preemptions=2,
                    preempt_generation=7, reason="preempted by x")
    back = ref_fleet.JobRecord.from_dict(json.loads(json.dumps(
        rec.to_dict())))
    assert back.to_dict() == rec.to_dict()
    assert JobRecord.from_dict(back.to_dict()) == rec
    assert (fleet.ACTIVE_STATES, fleet.TERMINAL_STATES) == \
        (ref_fleet.ACTIVE_STATES, ref_fleet.TERMINAL_STATES)


# ---------------------------------------------------------------------------
# plan() goldens through both packages
# ---------------------------------------------------------------------------

def _qv(V, id, seq, prio=0, min_np=1, max_np=None, tenant="t",
        max_queue_s=0.0):
    return V(id=id, tenant=tenant, priority=prio, min_np=min_np,
             max_np=max_np, submit_seq=seq, state="queued",
             max_queue_s=max_queue_s)


def _rv(V, id, seq, np, prio=0, min_np=1, max_np=None, tenant="t",
        state="running"):
    return V(id=id, tenant=tenant, priority=prio, min_np=min_np,
             max_np=max_np, submit_seq=seq, state=state, np=np)


GOLDENS = {
    "priority_then_fifo": (lambda V: [
        _qv(V, "lo", 1, prio=0, min_np=2, max_np=2),
        _qv(V, "hi", 2, prio=5, min_np=2, max_np=2),
        _qv(V, "mid", 3, prio=1, min_np=2, max_np=2)], 4, {},
        [("start", "hi", 2), ("start", "mid", 2)]),
    "fair_share_and_slo": (lambda V: [
        _rv(V, "r", 1, np=3, tenant="busy"),
        _qv(V, "b2", 2, tenant="busy", min_np=1, max_np=1),
        _qv(V, "i2", 3, tenant="idle", min_np=1, max_np=1,
            max_queue_s=60.0),
        _qv(V, "i1", 4, tenant="idle", min_np=1, max_np=1,
            max_queue_s=5.0)], 6, {},
        [("start", "i1", 1), ("start", "i2", 1), ("start", "b2", 1)]),
    "quota": (lambda V: [
        _rv(V, "r", 1, np=3, tenant="a"),
        _qv(V, "q1", 2, tenant="a", min_np=2),
        _qv(V, "q2", 3, tenant="b", min_np=2, max_np=4)], 10,
        {"quota_slots": 4},
        [("quota_wait", "q1", "a"), ("start", "q2", 4)]),
    "admission_denial": (lambda V: [_qv(V, "big", 1, min_np=4)], 2, {},
                         [("deny", "big",
                           "healthy capacity 2 < min_np 4 (health hints "
                           "exclude part of the fleet)")]),
    "admission_denial_zero": (lambda V: [_qv(V, "big", 1, min_np=4)], 0,
                              {}, [("deny", "big",
                                    "healthy capacity 0 < min_np 4 "
                                    "(health hints exclude the whole "
                                    "fleet)")]),
    "shrink_newest_first": (lambda V: [
        _rv(V, "old", 1, np=2, prio=0, min_np=1),
        _rv(V, "new", 2, np=2, prio=0, min_np=1),
        _qv(V, "hi", 3, prio=9, min_np=2, max_np=2)], 4, {},
        [("shrink", "new", 1, "hi"), ("shrink", "old", 1, "hi")]),
    "stop_when_shrink_cannot": (lambda V: [
        _rv(V, "a", 1, np=2, prio=0, min_np=2),
        _qv(V, "hi", 2, prio=9, min_np=2, max_np=2)], 2, {},
        [("stop", "a", "hi")]),
    "never_equal_or_higher": (lambda V: [
        _rv(V, "a", 1, np=2, prio=5, min_np=1),
        _qv(V, "same", 2, prio=5, min_np=2),
        _qv(V, "lower", 3, prio=1, min_np=2)], 2, {}, []),
    "no_preemption": (lambda V: [
        _rv(V, "a", 1, np=2, prio=0, min_np=1),
        _qv(V, "hi", 2, prio=9, min_np=2)], 2, {"preemption": False}, []),
    "grow_higher_first": (lambda V: [
        _rv(V, "lo", 1, np=1, prio=0, min_np=1, max_np=4),
        _rv(V, "hi", 2, np=1, prio=5, min_np=1, max_np=4)], 4, {},
        [("grow", "hi", 3)]),
    "grow_both": (lambda V: [
        _rv(V, "lo", 1, np=1, prio=0, min_np=1, max_np=4),
        _rv(V, "hi", 2, np=1, prio=5, min_np=1, max_np=4)], 8, {},
        [("grow", "hi", 4), ("grow", "lo", 4)]),
    "preempting_hold_slots": (lambda V: [
        _rv(V, "v", 1, np=4, prio=0, min_np=1, state="preempting"),
        _qv(V, "hi", 2, prio=9, min_np=2)], 4, {}, []),
}


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_plan_goldens_both_packages(case):
    views, healthy, kw, want = GOLDENS[case]
    got = plan(views(JobView), healthy, **kw)
    ref = ref_fleet.plan(views(RefJobView), healthy, **kw)
    if case == "quota":
        assert set(want) <= set(got)
    else:
        assert got == want
    assert got == ref


# ---------------------------------------------------------------------------
# The durable queue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_durable_queue_crosses_packages(writer, reader, tmp_path):
    mods = {"port": fleet, "ref": ref_fleet}
    W, R = mods[writer], mods[reader]
    q = W.DurableJobQueue(str(tmp_path))
    a = q.submit(W.JobSpec(command=["a"]))
    b = q.submit(W.JobSpec(command=["b"], priority=5, kind="service"))
    q.update(b.id, lambda r: setattr(r, "state", W.RUNNING))
    # The other package's gateway over the same directory: the queue,
    # a RUNNING job requeued (its driver died with the old gateway).
    q2 = R.DurableJobQueue(str(tmp_path))
    recs = {r.id: r for r in q2.list()}
    assert recs[a.id].state == R.QUEUED and recs[a.id].spec.command == ["a"]
    assert recs[b.id].state == R.QUEUED and recs[b.id].resumes == 1
    assert "gateway restart" in recs[b.id].reason
    assert recs[b.id].spec.kind == "service"
    assert q2.submit(R.JobSpec(command=["c"])).submit_seq == 3
    assert [r.spec.command for r in W.DurableJobQueue(
        str(tmp_path)).list()] == [["a"], ["b"], ["c"]]


def test_durable_queue_sidelines_unreadable_file(tmp_path):
    q = fleet.DurableJobQueue(str(tmp_path))
    q.submit(JobSpec(command=["a"]))
    with open(os.path.join(str(tmp_path), "jobs.json"), "w") as f:
        f.write("{not json")
    q2 = fleet.DurableJobQueue(str(tmp_path))
    assert q2.list() == []
    assert [p for p in os.listdir(str(tmp_path))
            if p.startswith("jobs.json.unreadable-")]


# ---------------------------------------------------------------------------
# The scheduler's reference cases over fake runners
# ---------------------------------------------------------------------------

def test_scheduler_multiplex_shrink_preemption(tmp_path):
    gw, addr, runners = _gateway(tmp_path, [HostInfo("localhost", 4)])
    try:
        a = gw.submit(JobSpec(command=["A"], min_np=1, max_np=4,
                              tenant="t1"))
        gw.scheduler.tick()
        assert gw.store.get(a.id).state == fleet.RUNNING
        assert runners[a.id].np_now == 4
        b = gw.submit(JobSpec(command=["B"], min_np=2, max_np=2,
                              priority=9, tenant="t2"))
        d1 = gw.scheduler.tick()
        assert ("shrink", a.id, 2, b.id) in d1
        runners[a.id].commit_now()
        gw.scheduler.tick()
        assert runners[a.id].np_now == 2
        assert gw.store.get(a.id).preemptions == 1
        gw.scheduler.tick()
        assert gw.store.get(b.id).state == fleet.RUNNING
        assert runners[b.id].np_now == 2
        runners[b.id].finish(0)
        gw.scheduler.tick()
        gw.scheduler.tick()
        assert gw.store.get(b.id).state == fleet.DONE
        assert runners[a.id].np_now == 4
        from horovod_tpu_torch.metrics.registry import registry
        snap = registry().snapshot()
        assert snap["hvd_fleet_preemptions_total"]["series"][0][
            "value"] >= 1
        kinds = {e["kind"] for e in _fleet_events()}
        assert {"fleet.submit", "fleet.schedule", "fleet.preempt",
                "fleet.resume"} <= kinds
    finally:
        gw.close()


def test_scheduler_commit_gates_preemption(tmp_path):
    gw, addr, runners = _gateway(tmp_path, [HostInfo("localhost", 2)],
                                 preempt_grace_s=30.0)
    try:
        a = gw.submit(JobSpec(command=["A"], min_np=1, max_np=2))
        gw.scheduler.tick()
        b = gw.submit(JobSpec(command=["B"], min_np=1, max_np=1,
                              priority=9))
        gw.scheduler.tick()
        for _ in range(3):
            gw.scheduler.tick()
        assert runners[a.id].np_now == 2
        assert gw.store.get(a.id).state == fleet.PREEMPTING
        assert gw.store.get(b.id).state == fleet.QUEUED
        runners[a.id].commit_now()
        gw.scheduler.tick()
        assert runners[a.id].np_now == 1
        gw.scheduler.tick()
        assert gw.store.get(b.id).state == fleet.RUNNING
    finally:
        gw.close()


def test_scheduler_preempt_grace_expiry_forces(tmp_path):
    gw, addr, runners = _gateway(tmp_path, [HostInfo("localhost", 2)],
                                 preempt_grace_s=0.15)
    try:
        a = gw.submit(JobSpec(command=["A"], min_np=1, max_np=2))
        gw.scheduler.tick()
        gw.submit(JobSpec(command=["B"], min_np=1, priority=9))
        gw.scheduler.tick()
        assert gw.store.get(a.id).state == fleet.PREEMPTING
        time.sleep(0.2)
        gw.scheduler.tick()
        assert runners[a.id].np_now == 1
    finally:
        gw.close()


def test_scheduler_stop_preemption_requeues_and_resumes(tmp_path):
    gw, addr, runners = _gateway(tmp_path, [HostInfo("localhost", 2)])
    try:
        a = gw.submit(JobSpec(command=["A"], min_np=2, max_np=2))
        gw.scheduler.tick()
        b = gw.submit(JobSpec(command=["B"], min_np=2, max_np=2,
                              priority=9))
        d = gw.scheduler.tick()
        assert ("stop", a.id, b.id) in d
        runners[a.id].commit_now()
        gw.scheduler.tick()
        assert runners[a.id].preempted
        gw.scheduler.tick()
        rec = gw.store.get(a.id)
        assert rec.state in (fleet.PREEMPTED, fleet.RUNNING)
        assert rec.preemptions == 1
        gw.scheduler.tick()
        assert gw.store.get(b.id).state == fleet.RUNNING
        runners[b.id].finish(0)
        gw.scheduler.tick()
        gw.scheduler.tick()
        rec = gw.store.get(a.id)
        assert rec.state == fleet.RUNNING and rec.resumes == 1
        assert any(e["kind"] == "fleet.resume" and e.get("name") == a.id
                   for e in _fleet_events())
    finally:
        gw.close()


def test_scheduler_inventory_glitch_never_denies(tmp_path):
    calls = {"fail": False}

    def provider():
        if calls["fail"]:
            raise RuntimeError("discovery glitch")
        return [HostInfo("localhost", 4)]

    gw, addr, runners = _gateway(tmp_path, provider)
    try:
        a = gw.submit(JobSpec(command=["A"], min_np=3, max_np=3))
        assert a.state == fleet.QUEUED
        calls["fail"] = True
        gw.scheduler.tick()
        assert gw.store.get(a.id).state == fleet.RUNNING
        b = gw.submit(JobSpec(command=["B"], min_np=2, max_np=2))
        gw.scheduler.tick()
        assert gw.store.get(b.id).state == fleet.QUEUED
        calls["fail"] = False
        gw.scheduler.tick()
        assert gw.store.get(b.id).state == fleet.QUEUED
    finally:
        gw.close()

    def always_fail():
        raise RuntimeError("no inventory yet")

    gw2 = fleet.FleetGateway(always_fail, port=0,
                             fleet_dir=str(tmp_path / "fl2"),
                             runner_factory=lambda r, e: FakeRunner(r, e),
                             tick_s=0.05)
    gw2.start()
    try:
        rec = gw2.submit(JobSpec(command=["x"], min_np=8))
        assert rec.state == fleet.QUEUED
        gw2.scheduler.tick()
        assert gw2.store.get(rec.id).state == fleet.QUEUED
    finally:
        gw2.close()


def test_scheduler_denies_queued_job_when_health_degrades(tmp_path):
    excluded = []
    gw, addr, runners = _gateway(
        tmp_path, [HostInfo("h1", 2), HostInfo("h2", 2)],
        health_hook=lambda: excluded)
    try:
        a = gw.submit(JobSpec(command=["A"], min_np=3, max_np=3))
        assert a.state == fleet.QUEUED
        excluded.append("h2")
        gw.scheduler.tick()
        rec = gw.store.get(a.id)
        assert rec.state == fleet.DENIED
        assert "healthy capacity 2 < min_np 3" in rec.reason
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# Card sets: no card ever hosts two jobs' workers
# ---------------------------------------------------------------------------

def _check_cards(gw, runners):
    """Every running job's cards are disjoint per host, and each runner
    holds exactly the cards the scheduler gave it."""
    sets = gw.scheduler.card_sets()
    seen = {}
    for job, by_host in sets.items():
        assert runners[job].cards == by_host, (job, runners[job].cards)
        assert sum(len(c) for c in by_host.values()) == runners[job].np_now
        for host, cards in by_host.items():
            assert len(set(cards)) == len(cards)
            for c in cards:
                assert (host, c) not in seen, (host, c, job, seen)
                seen[(host, c)] = job
    return sets


def test_card_sets_shrink_grow_preempt_requeue(tmp_path):
    gw, addr, runners = _gateway(tmp_path, [HostInfo("node", 4)],
                                 runner=CardRunner)
    try:
        tick = gw.scheduler.tick
        a = gw.submit(JobSpec(command=["A"], min_np=1, max_np=4))
        tick()
        assert _check_cards(gw, runners)[a.id] == {"node": [0, 1, 2, 3]}
        # B shrinks A to 2: A keeps its first two cards, B takes the tail.
        b = gw.submit(JobSpec(command=["B"], min_np=2, max_np=2,
                              priority=9))
        tick()
        _check_cards(gw, runners)
        runners[a.id].commit_now()
        tick()
        assert _check_cards(gw, runners)[a.id] == {"node": [0, 1]}
        tick()
        sets = _check_cards(gw, runners)
        assert sets[b.id] == {"node": [2, 3]}
        # C, a small job, takes a card the moment one frees: A's card 1
        # after A shrinks to 1 for it.
        c = gw.submit(JobSpec(command=["C"], min_np=1, max_np=1,
                              priority=9))
        tick()
        runners[a.id].commit_now()
        tick()
        tick()
        sets = _check_cards(gw, runners)
        assert sets[a.id] == {"node": [0]} and sets[c.id] == {"node": [1]}
        # B ends: A regrows onto B's freed cards, its slot 0 still on
        # card 0; the set is no longer contiguous.
        runners[b.id].finish(0)
        tick()
        tick()
        sets = _check_cards(gw, runners)
        assert sets[a.id] == {"node": [0, 2, 3]}
        # D (np 4, top priority) stops A and C outright; both requeue and
        # are reseated after D, on whatever is free.
        d = gw.submit(JobSpec(command=["D"], min_np=4, max_np=4,
                              priority=20))
        tick()
        runners[a.id].commit_now()
        runners[c.id].commit_now()
        for _ in range(3):
            tick()
            _check_cards(gw, runners)
        assert gw.store.get(d.id).state == fleet.RUNNING
        assert gw.scheduler.card_sets()[d.id] == {"node": [0, 1, 2, 3]}
        assert runners[a.id].preempted and runners[c.id].preempted
        runners[d.id].finish(0)
        for _ in range(3):
            tick()
            _check_cards(gw, runners)
        sets = gw.scheduler.card_sets()
        assert set(sets) == {a.id, c.id}
        assert gw.store.get(a.id).resumes == 1
        assert sorted(x for s in sets.values() for x in s["node"]) == \
            [0, 1, 2, 3]
    finally:
        gw.close()


def test_card_sets_on_two_hosts_fill_in_inventory_order(tmp_path):
    gw, addr, runners = _gateway(
        tmp_path, [HostInfo("h1", 2), HostInfo("h2", 2)], runner=CardRunner)
    try:
        a = gw.submit(JobSpec(command=["A"], min_np=3, max_np=3))
        gw.scheduler.tick()
        assert _check_cards(gw, runners)[a.id] == {"h1": [0, 1], "h2": [0]}
        b = gw.submit(JobSpec(command=["B"], min_np=1, max_np=1))
        gw.scheduler.tick()
        assert _check_cards(gw, runners)[b.id] == {"h2": [1]}
    finally:
        gw.close()


def test_elastic_driver_maps_slots_to_its_card_set(monkeypatch):
    """``ElasticDriver.seed_cards``: slot ``host:i`` takes the i-th card of
    the job's set, named as the host names its cards; a host pinned to
    the CPU ignores the set."""
    from horovod_tpu_torch.runner import chips
    from horovod_tpu_torch.runner.elastic_driver import (ElasticDriver,
                                                         FixedHosts)
    from horovod_tpu_torch.runner.hosts import SlotInfo
    names = ["GPU-a", "GPU-b", "GPU-c", "GPU-d"]
    monkeypatch.setattr(chips, "host_cards", lambda h: (
        (4, names) if h == "node" else (0, None)))
    d = ElasticDriver(FixedHosts([]), ["true"], min_np=1, max_np=4)
    try:
        d.seed_cards({"node": [3, 1], "cpuhost": [0]})
        slots = [SlotInfo(hostname="node", rank=i, local_rank=i,
                          cross_rank=0, size=2, local_size=2, cross_size=1)
                 for i in range(2)]
        envs = d._plan_round(slots)
        assert [envs[d._slot_id(s)]["CUDA_VISIBLE_DEVICES"]
                for s in slots] == ["GPU-d", "GPU-b"]
        assert [envs[d._slot_id(s)][chips.PARTITION_ENV]
                for s in slots] == ["0/2", "1/2"]
        # A slot beyond the set is refused, as a slot beyond the cards.
        with pytest.raises(ValueError, match="beyond"):
            d._plan_round(slots + [SlotInfo(
                hostname="node", rank=2, local_rank=2, cross_rank=0,
                size=3, local_size=3, cross_size=1)])
        d._cards.clear()
        cpu = [SlotInfo(hostname="cpuhost", rank=0, local_rank=0,
                        cross_rank=0, size=1, local_size=1, cross_size=1)]
        assert d._plan_round(cpu)[d._slot_id(cpu[0])][
            "HVD_TPU_WORKER_PLATFORM"] == "cpu"
    finally:
        d._rendezvous.stop()


# ---------------------------------------------------------------------------
# HTTP: each package's client against the other's gateway
# ---------------------------------------------------------------------------

PAIRS = [("port_client", "ref_gateway"), ("ref_client", "port_gateway")]


def _pair(which, tmp_path, secret="tok", **kw):
    client = ref_fleet if which[0] == "ref_client" else fleet
    gw_mod = fleet if which[1] == "port_gateway" else ref_fleet
    H = HostInfo if gw_mod is fleet else RefHostInfo
    gw, addr, runners = _gateway(tmp_path, [H("localhost", 4)],
                                 mod=gw_mod, secret=secret, **kw)
    return client, gw, addr


@pytest.mark.parametrize("which", PAIRS)
def test_http_submit_status_cancel_crosses(which, tmp_path):
    client, gw, addr = _pair(which, tmp_path)
    try:
        assert client.detect_gateway(addr)["service"] == "horovod_tpu_fleet"
        rec = client.submit_job(client.JobSpec(
            command=["python", "t.py"], min_np=1, max_np=2,
            kind="service"), addr=addr, secret="tok")
        assert rec.state == client.QUEUED
        assert client.get_job(rec.id, addr=addr, secret="tok").id == rec.id
        assert [r.id for r in client.list_jobs(addr=addr, secret="tok")] \
            == [rec.id]
        gw.scheduler.tick()
        from importlib import import_module
        status = import_module(client.__name__ + ".client")._request(
            "GET", addr, "status", secret="tok")
        assert (status["services"], status["total_slots"]) == (1, 4)
        out = client.cancel_job(rec.id, addr=addr, secret="tok")
        assert out.id == rec.id
        with pytest.raises(RuntimeError, match="404"):
            client.get_job("nope", addr=addr, secret="tok")
    finally:
        gw.close()


@pytest.mark.parametrize("which", PAIRS)
def test_http_unsigned_is_403_across(which, tmp_path):
    client, gw, addr = _pair(which, tmp_path)
    try:
        for secret in (None, "wrong"):
            with pytest.raises(PermissionError, match="signature"):
                client.submit_job(client.JobSpec(command=["x"]), addr=addr,
                                  secret=secret)
        import urllib.error
        import urllib.request
        from horovod_tpu_torch.runner.rendezvous import _signature
        req = urllib.request.Request(f"http://{addr}/fleet/jobs/abc",
                                     method="DELETE")
        req.add_header("X-HVD-Signature",
                       _signature("tok", "GET", "fleet", "jobs"))
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 403
    finally:
        gw.close()


@pytest.mark.parametrize("which", PAIRS)
def test_http_tuning_get_put_across(which, tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_FLEET_SECRET", "tok")
    client, gw, addr = _pair(which, tmp_path)
    from importlib import import_module
    T = import_module(client.__name__ + ".tuning")
    try:
        store = T.GatewayTuningStore(addr)
        assert store.get("k") is None
        rec = T.make_record({"fusion_bytes": 1 << 24}, 5.0, ("a", "b"))
        stored = store.put("k", rec)
        assert stored["config"] == rec["config"]
        assert store.get("k", dims=("a", "b"))["score"] == 5.0
        with pytest.raises(T.TuningSchemaMismatch):
            store.get("k", dims=("a",))
        # The gateway keeps it beside its queue, in the store's format.
        assert T.LocalTuningStore(str(tmp_path / "fl")).keys() == ["k"]
    finally:
        gw.close()


def _snapshot(round_idx):
    """A rank's wire snapshot from seeded step times."""
    from horovod_tpu_torch.metrics import digest as D
    rng = np.random.default_rng(round_idx)
    times = [float(0.1 + 0.01 * z) for z in rng.standard_normal(8)]
    return {"rank": 0, "step": 8 * round_idx, "step_time_sum": sum(times),
            "step_count": 8, "data_wait_sum": 0.0, "data_wait_count": 8,
            "sketch": D.QuantileSketch.of(times).to_dict(),
            "attr": {"steps": 8.0, "flops": 0.0, "wall": sum(times),
                     "compute": sum(times), "comm_exposed": 0.0,
                     "input": 0.0, "checkpoint": 0.0, "host": 0.0},
            "scalars": {"hvd_steps_total": 8.0}}


def _digest(round_idx, host="h0"):
    from horovod_tpu_torch.metrics import digest as D
    d = D.snapshot_digest([_snapshot(round_idx)], host=host)
    d["round"] = round_idx
    return d


@pytest.mark.parametrize("which", PAIRS)
def test_http_observe_post_get_across(which, tmp_path):
    client, gw, addr = _pair(which, tmp_path)
    try:
        for r in (1, 2):
            client.push_observation("jobA", _digest(r), addr=addr,
                                    secret="tok")
        series = client.get_observation("jobA", addr=addr, secret="tok")
        assert series["job"] == "jobA" and len(series["series"]) == 2
        assert series["series"][0]["round"] == 1
        assert series["series"][1].get("open") is True
        assert client.get_observation("nojob", addr=addr,
                                      secret="tok") is None
        assert client.list_observed_jobs(addr=addr, secret="tok") == \
            ["jobA"]
        import urllib.request
        with urllib.request.urlopen(f"http://{addr}/fleet/metrics",
                                    timeout=5) as resp:
            text = resp.read().decode()
        assert 'hvd_fleet_job_ranks{job="jobA"} 1.0' in text
    finally:
        gw.close()


def test_observe_store_equals_reference():
    got, ref = fleet.FleetSeriesStore(retain=4), \
        ref_fleet.FleetSeriesStore(retain=4)
    for r in (1, 1, 2, 3, 1, 9):
        d = _digest(r, host=f"h{r % 2}")
        for s in (got, ref):
            s.ingest("j", json.loads(json.dumps(d)), now=float(r))
    assert got.series("j") == ref.series("j")
    assert got.stats() == ref.stats()
    assert got.render_prometheus() == ref.render_prometheus()
    with pytest.raises(ValueError):
        got.ingest("j", {"v": 99})


# ---------------------------------------------------------------------------
# The submit CLI, hvdrun-torch --submit, the taken rendezvous port, knobs
# ---------------------------------------------------------------------------

def test_submit_cli_and_hvdrun_submit(tmp_path, capsys):
    gw, addr, _ = _gateway(tmp_path, [HostInfo("localhost", 4)])
    try:
        from horovod_tpu_torch.fleet import submit as submit_cli
        rc = submit_cli.main(["--gateway", addr, "-np", "2", "--priority",
                              "3", "--tenant", "ml", "--", "python",
                              "train.py"])
        assert rc == 0 and "queued" in capsys.readouterr().out
        jobs = fleet.list_jobs(addr=addr)
        assert jobs[0].spec.max_np == 2 and jobs[0].spec.priority == 3
        from horovod_tpu_torch.runner import launch
        rc = launch.main(["--submit", "--gateway", addr, "-np", "1",
                          "--priority", "7", "--tenant", "t2",
                          "--fusion-threshold-mb", "4", "--", "python",
                          "train.py"])
        assert rc == 0
        jobs = fleet.list_jobs(addr=addr)
        assert len(jobs) == 2
        assert (jobs[1].spec.priority, jobs[1].spec.tenant) == (7, "t2")
        assert jobs[1].spec.env["HVD_TPU_FUSION_THRESHOLD"] == \
            str(4 * 1024 * 1024)
    finally:
        gw.close()


def test_rendezvous_port_conflict_points_at_fleet_mode(tmp_path):
    from horovod_tpu_torch.runner import launch
    gw, addr, _ = _gateway(tmp_path, [HostInfo("localhost", 2)])
    try:
        with pytest.raises(SystemExit, match="fleet mode is active") as e:
            launch.bind_rendezvous(gw.port)
        assert "--submit" in str(e.value)
    finally:
        gw.close()
    s = socket.socket()
    s.bind(("0.0.0.0", 0))
    s.listen(1)
    try:
        with pytest.raises(SystemExit, match="already bound"):
            launch.bind_rendezvous(s.getsockname()[1])
    finally:
        s.close()


@pytest.mark.parametrize("env", [
    {},
    {"HVD_TPU_FLEET_QUOTA_SLOTS": "8", "HVD_TPU_FLEET_PREEMPTION": "0",
     "HVD_TPU_FLEET_TICK_S": "0.01", "HVD_TPU_FLEET_PREEMPT_GRACE_S": "7",
     "HVD_TPU_FLEET_OBSERVE_RETAIN": "3"},
    {"HOROVOD_FLEET_QUOTA_SLOTS": "2", "HVD_TPU_FLEET_PREEMPTION": "yes"}])
def test_fleet_knobs_read_as_the_reference(env, monkeypatch, tmp_path):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = fleet.Scheduler(fleet.DurableJobQueue(str(tmp_path / "a")),
                          lambda: [])
    ref = ref_fleet.Scheduler(ref_fleet.DurableJobQueue(str(tmp_path / "b")),
                              lambda: [])
    assert (got._quota, got._preemption, got._grace_s, got._tick_s) == \
        (ref._quota, ref._preemption, ref._grace_s, ref._tick_s)
    assert fleet.FleetSeriesStore().retain == \
        ref_fleet.FleetSeriesStore().retain
    assert fleet.default_addr() == ref_fleet.default_addr()
    from horovod_tpu.core.config import Config
    from horovod_tpu_torch.core import config
    cfg = Config.from_env()
    assert (config.fleet_port(), config.fleet_dir()) == \
        (cfg.fleet_port, cfg.fleet_dir)


# ---------------------------------------------------------------------------
# A host observer pushing to the gateway
# ---------------------------------------------------------------------------

def test_host_observer_pushes_to_the_gateway(tmp_path):
    from horovod_tpu_torch.metrics import observer as OB
    from horovod_tpu_torch.metrics.registry import registry
    gw, addr, _ = _gateway(tmp_path, [HostInfo("localhost", 1)])
    ob = OB.HostObserver("hP", [0], job_id="jobP", gateway_addr=addr,
                         push_interval_s=0.05).start()
    try:
        before = registry().counter(
            "hvd_observe_pushes_total",
            "Host digests pushed to the fleet gateway").value
        for r in (1, 2):
            ob.submit_snapshot(r, _snapshot(r))
            ob.fleet_digest(min_round=r, wait_s=5)
            deadline = time.time() + 5
            while time.time() < deadline and r not in [
                    s["round"] for s in gw.observe.series("jobP")]:
                time.sleep(0.05)
        rounds = [s["round"] for s in gw.observe.series("jobP")]
        assert rounds == [1, 2], rounds
        # The push thread counts a push once push_observation has
        # returned, which can be after the gateway holds its round.
        pushes = registry().counter(
            "hvd_observe_pushes_total",
            "Host digests pushed to the fleet gateway")
        deadline = time.time() + 5
        while time.time() < deadline and pushes.value < before + 2:
            time.sleep(0.05)
        after = pushes.value
        assert after - before == 2
    finally:
        ob.stop()
        gw.close()


def test_gateway_process_leaves_cuda_alone(tmp_path):
    gw, addr, runners = _gateway(tmp_path, [HostInfo("localhost", 2)],
                                 runner=CardRunner)
    try:
        gw.submit(JobSpec(command=["A"], min_np=1, max_np=2))
        gw.scheduler.tick()
        fleet.list_jobs(addr=addr)
    finally:
        gw.close()
    assert not torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# The gloo drill: two jobs on one slot, a stop preemption, the resume
# ---------------------------------------------------------------------------

DRILL_A_STEPS, DRILL_B_STEPS = 8, 2


def _events(prefix):
    out = []
    for path in glob.glob(prefix + ".*"):
        with open(path) as f:
            out += [json.loads(line) for line in f]
    return sorted(out, key=lambda e: e["t"])


def _wait(pred, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.mark.timeout(60)
def test_fleet_stop_preemption_drill_on_gloo(tmp_path, monkeypatch):
    """Job A (priority 0) holds the one slot; B (priority 10) arrives and
    stops A through a checkpoint-mediated preemption; B runs to DONE; A
    is reseated, restores its committed step from the disk and ends DONE
    with the losses of an uninterrupted run, bit for bit."""
    import _torch_port_elastic_workers as W
    import horovod_tpu_torch as hvd
    monkeypatch.setenv("HVD_TPU_ELASTIC_DISCOVERY_INTERVAL", "0.2")
    hvd.init(device="cpu")
    try:
        clean = W.fleet_steps(torch, hvd, ckpt=str(tmp_path / "clean"),
                              steps=DRILL_A_STEPS)
    finally:
        hvd.shutdown()
    worker = os.path.join(HERE, "_torch_port_elastic_workers.py")

    def cmd(tag, steps, pace):
        return [sys.executable, worker, "fleet", json.dumps({
            "log": str(tmp_path / f"log_{tag}"),
            "ckpt": str(tmp_path / f"ckpt_{tag}"), "steps": steps,
            "pace": pace})]

    gw = fleet.FleetGateway([HostInfo("localhost", 1)], port=0,
                            fleet_dir=str(tmp_path / "fleet"), tick_s=0.2,
                            preempt_grace_s=30.0)
    gw.serve()
    addr = f"127.0.0.1:{gw.port}"
    log_a = str(tmp_path / "log_a")
    try:
        a = fleet.submit_job(JobSpec(command=cmd("a", DRILL_A_STEPS, 0.4),
                                     min_np=1, max_np=1), addr=addr)
        _wait(lambda: sum(e["event"] == "step" for e in _events(log_a)) >= 2,
              60, "job A's second committed step")
        b = fleet.submit_job(JobSpec(command=cmd("b", DRILL_B_STEPS, 0.0),
                                     min_np=1, max_np=1, priority=10),
                             addr=addr)
        b_rec = fleet.wait_job(b.id, addr=addr, timeout=60, poll_s=0.2)
        assert b_rec.state == fleet.DONE, b_rec.reason
        a_rec = fleet.wait_job(a.id, addr=addr, timeout=60, poll_s=0.2)
        assert a_rec.state == fleet.DONE, a_rec.reason
    finally:
        gw.close(cancel_jobs=True)
    assert a_rec.preemptions == 1 and a_rec.resumes == 1
    ev = _events(log_a)
    syncs = [e for e in ev if e["event"] == "sync"]
    assert len({e["pid"] for e in syncs}) == 2          # stopped, reseated
    # The disk step the reseated worker restored: at least the commit the
    # scheduler acted on (a commit racing the stop may land after it).
    resumed_at = syncs[1]["step"]
    assert resumed_at >= a_rec.preempt_generation >= 2
    losses = {}
    for e in ev:
        if e["event"] == "step":
            assert losses.setdefault(e["step"], e["loss"]) == e["loss"]
    assert [losses[i] for i in range(DRILL_A_STEPS)] == \
        [clean[i] for i in range(DRILL_A_STEPS)]
    # B ran between A's two processes.
    b_steps = [e["t"] for e in _events(str(tmp_path / "log_b"))
               if e["event"] == "step"]
    assert syncs[0]["t"] < b_steps[0] and b_steps[-1] < syncs[1]["t"]
