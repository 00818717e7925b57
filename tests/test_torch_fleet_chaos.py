"""The port's serve fleet under faults: the reference's fleet chaos suite
(``tests/test_fleet_chaos.py``) cut small, on the CPU.

Every scenario drives six studies through the port's in-process
:class:`~hyperopt_tpu_torch.serve.fleet.Fleet` and
:class:`~hyperopt_tpu_torch.serve.router.FleetRouter` with a client that
retries as a protocol client does (a crashed router is restarted, asks go
again with ``recover=True``, tells with their vals), and ends with ZERO
lost and ZERO duplicated tells (the live buffers, the WALs and a cold
audit from nothing but the root) and every stream bitwise the port's
same-seed run without faults: a replica killed mid-batch under a storm of
file faults, every ``FLEET_CRASH_POINTS`` point, a partitioned zombie
that never serves twice, a heal and rejoin, and a rolling restart.

The last test is the reference's network storm
(``tests/test_netstorm.py``'s acceptance scenario) over the port's
``RouterServer`` and three replica fronts, real sockets end to end.  Each
replica serves one round in-process before the router takes traffic, so
no first round (the stacked state's allocation) runs behind the 5 s read
deadline; no deadline miss is absorbed by an uncounted retry.
"""

import json
import threading

import numpy as np
import pytest

from hyperopt_tpu_torch.client import RemoteStudy
from hyperopt_tpu_torch.distributed.faults import (
    FLEET_CRASH_POINTS,
    FaultPlan,
    NetFaultPlan,
    SimulatedCrash,
)
from hyperopt_tpu_torch.exceptions import Overloaded, OwnershipLost
from hyperopt_tpu_torch.serve import Fleet, FleetRouter, HashRing, SuggestService
from hyperopt_tpu_torch.serve.fleet import StudyClaim, fleet_salt
from hyperopt_tpu_torch.serve.router import RouterServer, _Backend
from hyperopt_tpu_torch.serve.service import serve_forever

from test_torch_serve import ALGO_KW, SPACE, loss_fn


@pytest.fixture(autouse=True)
def _lockdep_armed(monkeypatch):
    # the runtime lockdep sanitizer rides every scenario here: each
    # BatchScheduler built runs with its lock and condition wrapped, an
    # observed lock-order inversion raises where it is acquired, and the
    # teardown assert catches the non-raising (Condition re-acquire) path
    from hyperopt_tpu_torch.analysis import lockdep

    dep = lockdep.arm_scheduler_class(monkeypatch)
    yield dep
    assert dep.inversions == 0, dep.errors


KW = dict(max_batch=8, n_startup_jobs=2, snapshot_cadence=4, device="cpu", **ALGO_KW)
REPLICAS = ("r0", "r1", "r2")
NAMES = tuple(f"s{i:02d}" for i in range(6))
R = 4  # tells per study the workload ends with, exactly


def victim_rid(name="s00"):
    """The replica the ring places ``name`` on."""
    return HashRing(REPLICAS, salt=fleet_salt("tpe", SPACE)).owner(name)


def make_fleet(root, storm_rate=0.0, arm_victim=None, seed=0, fs=None, plans=None):
    plans = plans if plans is not None else {
        rid: FaultPlan(seed=seed * 100 + i, rate=storm_rate) for i, rid in enumerate(REPLICAS)}
    if arm_victim is not None:
        point, at = arm_victim
        plans[victim_rid()].arm(point, at=at)
    return Fleet(SPACE, root, replica_ids=list(REPLICAS), plans=plans,
                 fs=fs if fs is not None else FaultPlan(seed=seed).fs(), **KW)


class Client:
    """A protocol client's retries: a crashed router is restarted and the
    op sent again, asks with ``recover=True``, tells with their vals."""

    def __init__(self, fleet, router_fs=None):
        self.fleet = fleet
        self.router = FleetRouter(fleet) if router_fs is None else FleetRouter(fleet, fs=router_fs)
        self.crashes = 0

    def _restart(self):
        self.crashes += 1
        self.router = FleetRouter(self.fleet)

    def create(self, name, seed):
        while True:
            try:
                return self.router.create_study(name, seed=seed)
            except SimulatedCrash:
                self._restart()

    def ask(self, name):
        recover = False
        while True:
            try:
                return self.router.ask(name, timeout=30, recover=recover)
            except SimulatedCrash:
                self._restart()
                recover = True

    def tell(self, name, tid, loss, vals):
        while True:
            try:
                return self.router.tell(name, tid, loss, vals=vals)
            except SimulatedCrash:
                self._restart()


def open_all(client):
    for i, n in enumerate(NAMES):
        client.create(n, seed=100 + i)
    return {n: [] for n in NAMES}


def drive(client, streams, rounds):
    for _ in range(rounds):
        for n in NAMES:
            tid, vals = client.ask(n)
            client.tell(n, tid, loss_fn(vals), vals)
            streams[n].append((tid, tuple(sorted(vals.items()))))


def final_state(fleet):
    out = {}
    for n in NAMES:
        st = fleet.replicas[fleet.route(n)].service.scheduler.study(n)
        buf = st.buf
        out[n] = {"count": int(buf.count), "tids": buf.tids[: buf.count].tolist(),
                  "losses": buf.losses[: buf.count].tolist(),
                  "values": buf.values[:, : buf.count].copy(),
                  "wal_total_tells": st.persist.wal.total_tells}
    return out


def assert_exact(state, root):
    """Zero lost and zero duplicated tells, live and in a cold audit that
    restores every study from the root alone."""
    for n, d in state.items():
        assert d["count"] == R and len(set(d["tids"])) == R, (n, d["tids"])
        assert d["wal_total_tells"] == R, (n, d["wal_total_tells"])
    audit = SuggestService(SPACE, root=root, owner="audit", background=False, max_batch=16,
                           n_startup_jobs=2, device="cpu", **ALGO_KW)
    try:
        for n in NAMES:
            h = audit.create_study(n, takeover=True)
            assert h.n_tells == R, (n, h.n_tells)
            assert audit.scheduler.study(n).buf.tids[:R].tolist() == state[n]["tids"], n
    finally:
        audit.shutdown()


def assert_bitwise(streams, state, clean):
    clean_streams, clean_state = clean
    assert streams == clean_streams
    for n in NAMES:
        assert state[n]["tids"] == clean_state[n]["tids"], n
        assert state[n]["losses"] == clean_state[n]["losses"], n
        np.testing.assert_array_equal(state[n]["values"], clean_state[n]["values"])


@pytest.fixture(scope="module")
def clean_run(tmp_path_factory):
    """The same-seed run without faults every scenario is held to."""
    fleet = make_fleet(str(tmp_path_factory.mktemp("fleet-clean")))
    client = Client(fleet)
    streams = open_all(client)
    drive(client, streams, R)
    state = final_state(fleet)
    fleet.shutdown()
    return streams, state


def test_replica_kill_mid_batch_under_storm(tmp_path, clean_run):
    """The victim dies in its second round under a 10% errno storm: it is
    failed over, every stream (the failed-over ones too: their in-flight
    asks are served again from their logged seeds) is the clean run's."""
    root = str(tmp_path / "kill")
    fleet = make_fleet(root, storm_rate=0.10, arm_victim=("serve_mid_batch", 2), seed=7)
    victim = victim_rid()
    client = Client(fleet)
    streams = open_all(client)
    drive(client, streams, R)
    assert fleet.replicas[victim].dead and victim not in fleet.ring.nodes
    assert fleet.recovery_ms is not None and fleet.recovery_ms > 0
    state = final_state(fleet)
    fleet.shutdown()
    assert_exact(state, root)
    assert_bitwise(streams, state, clean_run)


@pytest.mark.parametrize("point,at", [
    ("fleet_router_after_forward_before_ack", 19),  # round 2's first ask ack
    ("fleet_router_after_forward_before_ack", 20),  # ... and its tell ack
    ("fleet_migrate_after_snapshot_before_handoff", 1),
    ("fleet_migrate_after_handoff_before_restore", 1),
    ("fleet_claim_tmp_before_rename", 1),
])
def test_every_fleet_crash_point_is_exact(tmp_path, clean_run, point, at):
    """Each ``FLEET_CRASH_POINTS`` point fires once: the router dies
    between a replica's op and its ack (the retry is idempotent); a drain
    migration dies between snapshot and handoff (the source keeps the
    study, the drain runs again) or between handoff and restore (the
    target adopts it); a claim publish dies before its rename during a
    failover's adoption (the old claim stays visible, the next adoption
    wins)."""
    root = str(tmp_path / "point")
    victim = victim_rid()
    plans = {rid: FaultPlan(seed=i) for i, rid in enumerate(REPLICAS)}
    fleet_plan = FaultPlan(seed=2)
    router_fs = None
    if point == "fleet_router_after_forward_before_ack":
        router_fs = FaultPlan(seed=1).arm(point, at=at).fs()
    elif point == "fleet_migrate_after_snapshot_before_handoff":
        plans[victim].arm(point, at=at)
    elif point == "fleet_migrate_after_handoff_before_restore":
        fleet_plan.arm(point, at=at)
    fleet = make_fleet(root, plans=plans, fs=fleet_plan.fs())
    client = Client(fleet, router_fs=router_fs)
    streams = open_all(client)
    drive(client, streams, 2)
    fired = 0
    if point.startswith("fleet_migrate"):
        fleet.begin_drain(victim, timeout=5.0)
        while victim in fleet.replicas:
            try:
                fleet.complete_drain(victim)
            except SimulatedCrash:
                fired += 1  # the coordinator died: run the drain again
        assert victim not in fleet.ring.nodes
    elif point == "fleet_claim_tmp_before_rename":
        adopter = HashRing(set(REPLICAS) - {victim}, salt=fleet_salt("tpe", SPACE)).owner("s00")
        plans[adopter].arm(point, at=at)
        fleet.kill_replica(victim)
    drive(client, streams, R - 2)
    if point.startswith("fleet_migrate"):
        assert fired == 1, f"{point} never fired"
    elif point == "fleet_claim_tmp_before_rename":
        assert plans[adopter].stats[f"crash:{point}"] == 1
        assert client.crashes == 1
        assert StudyClaim.read(root, "s00")["replica"] == adopter
    else:
        assert client.crashes == 1, "the router crash never fired"
    state = final_state(fleet)
    fleet.shutdown()
    assert_exact(state, root)
    assert_bitwise(streams, state, clean_run)


def test_partitioned_zombie_never_double_serves(tmp_path, clean_run):
    """A replica cut off from the router keeps running while its studies
    fail over: every fenced op it tries raises ``OwnershipLost``, and the
    streams are the clean run's (the zombie added nothing)."""
    root = str(tmp_path / "zombie")
    fleet = make_fleet(root)
    client = Client(fleet)
    streams = open_all(client)
    drive(client, streams, 2)
    victim = victim_rid()
    zombie = fleet.replicas[victim]
    fleet.partition(victim)
    drive(client, streams, 1)
    znames = [n for n in NAMES if n in zombie.service.studies()]
    assert znames, "the zombie should still hold its old handles"
    for n in znames:
        with pytest.raises(OwnershipLost):
            zombie.ask(n, timeout=5)
        with pytest.raises(OwnershipLost):
            zombie.ask_async(n)
        with pytest.raises(OwnershipLost):
            zombie.tell(n, 99, 0.5, vals={"x": 0.1, "lr": 0.5, "q": 3.0, "c": 0})
    drive(client, streams, 1)
    state = final_state(fleet)
    fleet.shutdown()
    assert_exact(state, root)
    assert_bitwise(streams, state, clean_run)


def test_partition_heals_and_the_zombie_rejoins(tmp_path, clean_run):
    """The partition lifts: the replica rejoins the ring, its first routed
    op per study raises ``OwnershipLost`` (its claims are stale), and the
    router's adoption re-claims the study from the root unseen by the
    client."""
    root = str(tmp_path / "heal")
    fleet = make_fleet(root)
    client = Client(fleet)
    streams = open_all(client)
    drive(client, streams, 1)
    victim = victim_rid()
    fleet.partition(victim)
    drive(client, streams, 1)
    assert victim not in fleet.ring.nodes and not fleet.replicas[victim].dead
    fleet.heal(victim)
    assert victim in fleet.ring.nodes and not fleet.replicas[victim].partitioned
    owned = [n for n in NAMES if fleet.route(n) == victim]
    assert owned, "the heal routed nothing back"
    with pytest.raises(OwnershipLost):
        fleet.replicas[victim].ask(owned[0], timeout=5)
    drive(client, streams, R - 2)
    state = final_state(fleet)
    assert all(fleet.route(n) == victim for n in owned)
    fleet.shutdown()
    assert_exact(state, root)
    assert_bitwise(streams, state, clean_run)


def test_rolling_restart_drains_and_migrates(tmp_path, clean_run):
    """Drain a replica (clients see only ``Overloaded(reason="draining",
    retry_after=<time left>)``), migrate its studies, add a fresh replica
    that takes back its ring share by migration: the streams are the
    clean run's."""
    root = str(tmp_path / "roll")
    fleet = make_fleet(root)
    client = Client(fleet)
    streams = open_all(client)
    drive(client, streams, 2)
    victim = victim_rid()
    owned = [n for n in NAMES if fleet.route(n) == victim]
    fleet.begin_drain(victim, timeout=7.5)
    with pytest.raises(Overloaded) as ei:
        client.router.ask(owned[0], timeout=5)
    assert ei.value.reason == "draining" and 0 < ei.value.retry_after <= 7.5
    assert fleet.complete_drain(victim) == sorted(owned)
    assert victim not in fleet.replicas
    drive(client, streams, 1)  # the refused submit drew no seed
    before = {n: fleet.route(n) for n in NAMES}
    fleet.add_replica("r9")
    after = {n: fleet.route(n) for n in NAMES}
    moved = [n for n in NAMES if before[n] != after[n]]
    assert all(after[n] == "r9" for n in moved) and len(moved) < len(NAMES)
    drive(client, streams, 1)
    state = final_state(fleet)
    fleet.shutdown()
    assert_exact(state, root)
    assert_bitwise(streams, state, clean_run)


def test_claim_publish_crash_before_rename(tmp_path):
    """The claim's tmp is fsynced but never renamed: no claim is visible,
    and a restarted replica's acquire wins cleanly."""
    root = str(tmp_path / "claims")
    plan = FaultPlan(seed=7).arm("fleet_claim_tmp_before_rename", at=1)
    with pytest.raises(SimulatedCrash):
        StudyClaim.acquire(root, "s00", "r0", fs=plan.fs())
    assert StudyClaim.read(root, "s00") is None
    claim = StudyClaim.acquire(root, "s00", "r1")
    assert claim.is_live() and StudyClaim.read(root, "s00")["replica"] == "r1"
    assert set(FLEET_CRASH_POINTS) == {
        "fleet_router_after_forward_before_ack", "fleet_migrate_after_snapshot_before_handoff",
        "fleet_migrate_after_handoff_before_restore", "fleet_claim_tmp_before_rename"}


# ---------------------------------------------------------------------------
# the network storm over the port's router and replica fronts
# ---------------------------------------------------------------------------

STORM_NAMES = ("s00", "s01", "s02")


def _spawn(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def _storm_fleet(root, router_plan=None):
    """Three replica fronts on one root, warmed by an in-process round,
    behind one RouterServer."""
    services, servers, backends = {}, {}, []
    for rid in REPLICAS:
        svc = SuggestService(SPACE, root=root, owner=rid, background=True, max_batch=8,
                             n_startup_jobs=2, device="cpu", **ALGO_KW)
        warm = svc.create_study(f"warm-{rid}", seed=1)
        warm.ask(timeout=60)
        svc.close_study(warm.name)
        srv = serve_forever(svc, port=0)
        _spawn(srv)
        services[rid], servers[rid] = svc, srv
        backends.append(_Backend(rid, *srv.server_address[:2]))
    router = RouterServer(backends, salt=fleet_salt("tpe", SPACE), read_timeout=5.0,
                          probe_timeout=2.0, net_plan=router_plan)
    rsrv = router.serve_forever(port=0)
    _spawn(rsrv)
    return services, servers, router, rsrv


def _storm_scenario(root, client_plan=None, router_plan=None):
    services, servers, router, rsrv = _storm_fleet(root, router_plan=router_plan)
    host, port = rsrv.server_address[:2]
    victim = router.ring.owner(STORM_NAMES[0])
    if client_plan is not None:
        client_plan.slow_loris(f"client/{STORM_NAMES[-1]}")
    clients, streams = {}, {n: [] for n in STORM_NAMES}
    try:
        for i, n in enumerate(STORM_NAMES):
            clients[n] = RemoteStudy(host, port, n, seed=100 + i, net_plan=client_plan,
                                     read_timeout=5.0)

        def round_():
            for n in STORM_NAMES:
                tid, vals = clients[n].ask(timeout=30)
                clients[n].tell(tid, loss_fn(vals), vals)
                streams[n].append((tid, json.dumps(vals, sort_keys=True)))

        round_()
        if router_plan is not None:
            router_plan.partition(victim)
        round_()  # the black-holed backend: NetworkTimeout, failover
        if router_plan is not None:
            assert victim in router._alive_excluded()
            assert router_plan.stats["net:blackhole_read"] > 0
            router_plan.heal(victim)
            router.probe_backends()  # the probe brings it back to the ring
            assert victim not in router._alive_excluded()
        for _ in range(R - 2):
            round_()  # the healed zombie re-claims by takeover adoption
        state, stats = {}, {}
        for n in STORM_NAMES:
            rid = router.ring.owner(n, exclude=router._alive_excluded())
            st = services[rid].scheduler.study(n)
            state[n] = {"count": int(st.buf.count), "tids": st.buf.tids[: st.buf.count].tolist(),
                        "losses": st.buf.losses[: st.buf.count].tolist(),
                        "wal_total_tells": st.persist.wal.total_tells}
        for c in clients.values():
            for k, v in c.stats.items():
                stats[k] = stats.get(k, 0) + v
    finally:
        for c in clients.values():
            c.close()
        rsrv.shutdown()
        rsrv.server_close()
        for rid in REPLICAS:
            servers[rid].shutdown()
            servers[rid].server_close()
            services[rid].shutdown()
    return streams, state, stats


def test_fleet_storm_over_the_ports_router(tmp_path):
    """Resets, latency, truncation and a slow-loris client against the
    clients, a black-hole partition of one backend behind the router, then
    its heal: zero lost and zero duplicated tells (live and in a cold
    audit), only typed backpressure visible, streams bitwise the clean
    run's through the same topology."""
    clean_streams, clean_state, clean_stats = _storm_scenario(str(tmp_path / "clean"))
    assert clean_stats.get("transport_errors", 0) == 0
    client_plan = NetFaultPlan(seed=18, reset_rate=0.10, latency=0.002, truncate_rate=0.05,
                               burst=2)
    router_plan = NetFaultPlan(seed=180)
    root = str(tmp_path / "storm")
    streams, state, stats = _storm_scenario(root, client_plan=client_plan,
                                            router_plan=router_plan)
    assert client_plan.stats["net:reset"] > 0 and stats["retries"] > 0
    assert not {k for k in stats if k.startswith("typed:")} - {"typed:Overloaded"}, stats
    for n in STORM_NAMES:
        d = state[n]
        assert d["count"] == R and len(set(d["tids"])) == R and d["wal_total_tells"] == R, (n, d)
    audit = SuggestService(SPACE, root=root, owner="audit", background=False, max_batch=16,
                           n_startup_jobs=2, device="cpu", **ALGO_KW)
    try:
        for n in STORM_NAMES:
            assert audit.create_study(n, takeover=True).n_tells == R
            assert audit.scheduler.study(n).buf.tids[:R].tolist() == state[n]["tids"]
    finally:
        audit.shutdown()
    assert streams == clean_streams
    for n in STORM_NAMES:
        assert state[n]["tids"] == clean_state[n]["tids"]
        assert state[n]["losses"] == clean_state[n]["losses"]
