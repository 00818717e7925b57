"""The port's autoscaler and traffic replay against the JAX reference's,
on the CPU.

``summarize_rows`` and ``FleetPilot.decide`` give the reference's
``PilotSample`` and ``PilotDecision`` (action, replica, reason) tick for
tick on the same scrape rows, scripted ones and the port fleet's own; the
control discipline (hysteresis, cooldown, bounds, the down-backend veto,
an absorbed refusal) is the reference's suite's.  Both
``PILOT_CRASH_POINTS`` points and a kill during a scale-out under a file
fault storm leave zero lost and zero duplicated tells and every stream
bitwise the port's run without faults, and the recorded flight log
replays bitwise against a fresh service.  Last, the port's fleet and the
reference's fleet, driven alike through a failover, serve the same
streams up to a near-tie (the reference's own llr margin below
``NEAR_TIE`` at the first pick that differs, as
``test_torch_serve_batched.py`` holds the services).
"""

import math

import numpy as np
import pytest

from hyperopt_tpu.jax_trials import ObsBuffer as JObsBuffer, host_key
from hyperopt_tpu.ops import kernels as JK
from hyperopt_tpu.serve import Fleet as JFleet
from hyperopt_tpu.serve import FleetRouter as JRouter
from hyperopt_tpu.serve.pilot import FleetPilot as JPilot
from hyperopt_tpu.serve.pilot import PilotConfig as JConfig
from hyperopt_tpu.serve.pilot import summarize_rows as j_summarize
from hyperopt_tpu_torch.distributed.faults import (
    PILOT_CRASH_POINTS,
    FaultPlan,
    SimulatedCrash,
)
from hyperopt_tpu_torch.obs.flightrec import FlightRecorder
from hyperopt_tpu_torch.serve import (
    Fleet,
    FleetPilot,
    FleetRouter,
    HashRing,
    PilotConfig,
    SuggestService,
)
from hyperopt_tpu_torch.serve.fleet import fleet_salt
from hyperopt_tpu_torch.serve.pilot import summarize_rows
from hyperopt_tpu_torch.serve.replay import (
    ServiceTarget,
    load_workload,
    replay_fidelity,
    replay_workload,
    stream_hash,
)

from test_torch_serve import ALGO_KW, NEAR_TIE, SPACE, loss_fn
from test_torch_serve_batched import (  # noqa: F401 (spaces is a fixture)
    J_SPACE,
    PRIOR_LOG_RTOL,
    picks_differ,
    ref_margins,
    spaces,
)

KW = dict(max_batch=8, n_startup_jobs=2, snapshot_cadence=4, **ALGO_KW)
REPLICAS = ("r0", "r1")
NAMES = tuple(f"s{i:02d}" for i in range(6))
R = 4


# ---------------------------------------------------------------------------
# the controller against the reference's, on the same rows
# ---------------------------------------------------------------------------


def _rows(replicas, queue=0.0, shed=0.0, occ_sum=0.0, occ_count=0.0, down=0,
          lat_buckets=None):
    rows = []
    for i, rid in enumerate(sorted(replicas)):
        n = len(replicas)
        rows += [{"name": "serve_queue_depth", "labels": {"replica": rid}, "value": queue / n},
                 {"name": "serve_shed_total", "labels": {"replica": rid}, "value": shed / n},
                 {"name": "serve_batch_occupancy", "labels": {"replica": rid}, "buckets": [],
                  "sum": occ_sum / n, "count": occ_count / n}]
        if lat_buckets and i == 0:
            rows.append({"name": "serve_ask_latency_seconds", "labels": {"replica": rid},
                         "buckets": [{"le": le, "count": c} for le, c in lat_buckets],
                         "sum": 0.0, "count": sum(c for _, c in lat_buckets)})
    rows += [{"name": "router_backend_up", "labels": {"backend": f"d{j}"}, "value": 0}
             for j in range(down)]
    return rows


def _sample_tuple(s):
    return (s.replicas, s.queue_depth, s.ask_p99_s, s.shed_total, s.admitted_total,
            s.occupancy_sum, s.occupancy_count, s.backends_down)


def test_summarize_rows_equals_the_references():
    rows = _rows(("r0", "r1"), queue=10.0, shed=4.0, occ_sum=1.5, occ_count=2.0, down=1,
                 lat_buckets=[(0.005, 90), (0.05, 8), (float("inf"), 2)])
    ours = summarize_rows(rows)
    assert _sample_tuple(ours) == _sample_tuple(j_summarize(rows))
    assert ours.replicas == ("r0", "r1") and ours.ask_p99_s == pytest.approx(0.05)
    assert _sample_tuple(summarize_rows([])) == _sample_tuple(j_summarize([]))


SCRIPT = (  # per tick: replicas, queue, shed, occupancy (sum, count), backends down, p99
    [(("r0",), 0, 0, (0, 0), 0, None)] + [(("r0",), 20, 0, (2, 4), 0, None)] * 3
    + [(("r0", "p0"), 20, 3, (3, 6), 0, 0.2)] * 3 + [(("r0", "p0"), 0, 3, (3, 6), 1, None)] * 3
    + [(("r0", "p0"), 0, 3, (3.5, 12), 0, None)] * 5 + [(("p0",), 9, 3, (4, 13), 0, None)] * 2
)


@pytest.mark.parametrize("cfg", [
    dict(min_replicas=1, max_replicas=2, queue_high=8.0, breach_ticks=2, clear_ticks=3,
         cooldown_ticks=2),
    dict(min_replicas=1, max_replicas=3, queue_high=8.0, p99_high_s=0.1, shed_high=2.0,
         breach_ticks=1, clear_ticks=2, cooldown_ticks=0),
])
def test_decisions_equal_the_references_tick_for_tick(cfg):
    """A scripted scrape (pressure, a scale-out's new replica, sheds, a
    down backend, quiet, the p99): both pilots decide the same action,
    replica and reason on every tick."""
    ours = FleetPilot(None, config=PilotConfig(**cfg), scrape=lambda: [])
    theirs = JPilot(None, config=JConfig(**cfg), scrape=lambda: [])
    decisions = []
    for reps, queue, shed, (o_sum, o_n), down, p99 in SCRIPT:
        lat = [(p99, 100)] if p99 is not None else None
        rows = _rows(reps, queue=queue, shed=shed, occ_sum=o_sum, occ_count=o_n, down=down,
                     lat_buckets=lat)
        a = ours.decide(summarize_rows(rows))
        b = theirs.decide(j_summarize(rows))
        assert (a.action, a.rid, a.reason) == (b.action, b.rid, b.reason)
        decisions.append(a.action)
        if a.action != "hold":  # what actuate does to the streaks
            for p in (ours, theirs):
                p._cooldown, p._breach, p._clear = p.config.cooldown_ticks, 0, 0
    assert {"scale_out", "scale_in", "hold"} <= set(decisions)


def test_the_fleets_own_scrape_decides_as_the_references(tmp_path):
    """The rows a port fleet serves (every replica's series, tagged) read
    the same through both packages' ``summarize_rows``."""
    fleet = Fleet(SPACE, str(tmp_path / "root"), replica_ids=list(REPLICAS), device="cpu", **KW)
    router = FleetRouter(fleet)
    for i, n in enumerate(NAMES):
        router.create_study(n, seed=i)
    for n, (tid, vals) in router.ask_batch(NAMES).items():
        router.tell(n, tid, loss_fn(vals), vals=vals)
    fleet.replicas[fleet.route(NAMES[0])].ask_async(NAMES[0])  # queued, not pumped
    rows = fleet.metrics_rows()
    assert _sample_tuple(summarize_rows(rows)) == _sample_tuple(j_summarize(rows))
    assert summarize_rows(rows).replicas == REPLICAS and summarize_rows(rows).queue_depth == 1
    fleet.shutdown()


def _pilot(tmp_path, replica_ids, cfg, scrape_of):
    fleet = Fleet(SPACE, str(tmp_path / "root"), replica_ids=list(replica_ids), device="cpu",
                  **KW)
    return fleet, FleetPilot(fleet, config=PilotConfig(**cfg), scrape=lambda: scrape_of(fleet))


def test_scale_out_hysteresis_cooldown_and_max(tmp_path):
    state = {"queue": 0.0}
    fleet, pilot = _pilot(tmp_path, ["r0"], dict(max_replicas=2, queue_high=8.0, breach_ticks=2,
                                                 clear_ticks=3, cooldown_ticks=2),
                          lambda f: _rows(sorted(f.replicas), queue=state["queue"]))
    assert pilot.tick().action == "hold"
    state["queue"] = 20.0
    assert pilot.tick().action == "hold", "one noisy scrape must never scale"
    d = pilot.tick()
    assert d.action == "scale_out" and d.rid == "p0" and set(fleet.replicas) == {"r0", "p0"}
    assert [pilot.tick().reason for _ in range(2)] == ["cooldown"] * 2
    for _ in range(4):
        assert pilot.tick().action == "hold"
    assert set(fleet.replicas) == {"r0", "p0"}
    rows = {r["name"]: r for r in pilot.metrics_rows() if not r.get("labels")}
    assert rows["pilot_scale_outs_total"]["value"] == 1 and rows["pilot_scale_out_ms"]["value"] >= 0
    assert fleet.replicas["p0"].service.device.type == "cpu"  # the fleet's service_kw
    fleet.shutdown()


def test_scale_in_quiet_min_bound_and_the_down_veto(tmp_path):
    state = {"queue": 0.0, "down": 0}
    fleet, pilot = _pilot(tmp_path, ["r0", "r1"],
                          dict(max_replicas=3, queue_high=8.0, queue_low=1.0, breach_ticks=2,
                               clear_ticks=2, cooldown_ticks=0),
                          lambda f: _rows(sorted(f.replicas), queue=state["queue"],
                                          down=state["down"]))
    state["down"] = 1
    for _ in range(4):
        assert pilot.tick().action == "hold"
    state["queue"] = 20.0
    pilot.tick()
    assert pilot.tick().action == "scale_out"
    state.update(queue=0.0, down=0)
    drained = [d.rid for d in (pilot.tick() for _ in range(10)) if d.action == "scale_in"]
    assert drained == ["r1", "r0"] and set(fleet.replicas) == {"p0"}
    fleet.shutdown()


def test_a_refused_actuation_is_absorbed_not_retried(tmp_path):
    fleet, pilot = _pilot(tmp_path, ["r0"], dict(max_replicas=4, queue_high=8.0, breach_ticks=1,
                                                 cooldown_ticks=0),
                          lambda f: _rows(["r0"], queue=20.0))
    fleet.add_replica("p0", migrate=False)  # another path took the pilot's name
    d = pilot.tick()
    assert d.action == "scale_out" and d.rid == "p0"
    assert pilot.metrics.counter("pilot_actuation_errors_total").value == 1
    d2 = pilot.tick()
    assert d2.rid == "p1" and "p1" in fleet.replicas
    fleet.shutdown()


# ---------------------------------------------------------------------------
# the crash points, a kill during a scale-out, record and replay
# ---------------------------------------------------------------------------


def victim_rid(name="s00"):
    return HashRing(REPLICAS, salt=fleet_salt("tpe", SPACE)).owner(name)


def make_fleet(root, storm_rate=0.0, arm_victim=None, fs=None, recorder=None, seed=0):
    plans = {rid: FaultPlan(seed=seed * 100 + i, rate=storm_rate)
             for i, rid in enumerate(REPLICAS)}
    if arm_victim is not None:
        plans[victim_rid()].arm(*arm_victim)
    kw = dict(KW, device="cpu")
    if recorder is not None:
        kw["recorder"] = recorder
    return Fleet(SPACE, root, replica_ids=list(REPLICAS), plans=plans,
                 fs=fs if fs is not None else FaultPlan(seed=seed).fs(), **kw)


class Client:
    def __init__(self, fleet):
        self.fleet, self.router = fleet, FleetRouter(fleet)

    def ask(self, name):
        recover = False
        while True:
            try:
                return self.router.ask(name, timeout=30, recover=recover)
            except SimulatedCrash:
                self.router, recover = FleetRouter(self.fleet), True

    def tell(self, name, tid, loss, vals):
        self.router.tell(name, tid, loss, vals=vals)


def open_all(client):
    for i, n in enumerate(NAMES):
        client.router.create_study(n, seed=100 + i)
    return {n: [] for n in NAMES}


def drive(client, streams, rounds):
    for _ in range(rounds):
        for n in NAMES:
            tid, vals = client.ask(n)
            client.tell(n, tid, loss_fn(vals), vals)
            streams[n].append((tid, dict(vals)))


def build_pressure(fleet):
    """Queue load the scrape sees: two unregistered studies per live
    replica, two asks each, not pumped."""
    for rid in sorted(fleet.replicas):
        rep = fleet.replicas[rid]
        if rep.dead or rep.partitioned:
            continue
        for j in range(2):
            name = f"zz-load-{rid}-{j}"
            if name not in rep.service.studies():
                rep.open_study(name, seed=900 + j)
            for _ in range(2):
                rep.ask_async(name)


def assert_exact(fleet, root, streams, clean):
    for n in NAMES:
        st = fleet.replicas[fleet.route(n)].service.scheduler.study(n)
        assert int(st.buf.count) == R and st.persist.wal.total_tells == R, n
        assert len(set(st.buf.tids[:R].tolist())) == R
    fleet.shutdown()
    audit = SuggestService(SPACE, root=root, owner="audit", background=False, max_batch=16,
                           n_startup_jobs=2, device="cpu", **ALGO_KW)
    for n in NAMES:
        assert audit.create_study(n, takeover=True).n_tells == R, n
    audit.shutdown()
    assert streams == clean


@pytest.fixture(scope="module")
def clean_streams(tmp_path_factory):
    fleet = make_fleet(str(tmp_path_factory.mktemp("pilot-clean")))
    client = Client(fleet)
    streams = open_all(client)
    drive(client, streams, R)
    fleet.shutdown()
    return streams


def test_pilot_crash_between_decision_and_actuation(tmp_path, clean_streams):
    """The pilot dies with its decision recorded and the fleet untouched; a
    restarted pilot decides the same from the same scrape and acts."""
    root = str(tmp_path / "dw")
    fleet = make_fleet(root)
    client = Client(fleet)
    streams = open_all(client)
    drive(client, streams, 2)
    build_pressure(fleet)
    cfg = dict(min_replicas=2, max_replicas=3, queue_high=6.0, breach_ticks=1)
    crashed = FleetPilot(fleet, config=PilotConfig(**cfg), fs=FaultPlan(seed=3).arm(
        "pilot_after_decision_before_actuate", at=1).fs())
    with pytest.raises(SimulatedCrash):
        crashed.tick()
    assert crashed.metrics.counter("pilot_decisions_total").labels(
        action="scale_out").value == 1
    assert set(fleet.replicas) == set(REPLICAS)
    d = FleetPilot(fleet, config=PilotConfig(**cfg)).tick()
    assert d.action == "scale_out" and d.rid == "p0" and "p0" in fleet.replicas
    drive(client, streams, R - 2)
    assert_exact(fleet, root, streams, clean_streams)


def test_pilot_mid_scale_out_crash_heals_by_lazy_adoption(tmp_path, clean_streams):
    """The coordinator dies after the first remapped study moved: the ring
    holds the new replica, the rest are stranded behind it until their
    first routed request adopts them; ``add_replica`` again is refused."""
    root = str(tmp_path / "ms")
    fleet = make_fleet(root, fs=FaultPlan(seed=4).arm("pilot_mid_scale_out", at=1).fs())
    client = Client(fleet)
    streams = open_all(client)
    drive(client, streams, 2)
    build_pressure(fleet)
    pilot = FleetPilot(fleet, config=PilotConfig(min_replicas=2, max_replicas=3, queue_high=6.0,
                                                 shed_high=0, breach_ticks=1))
    with pytest.raises(SimulatedCrash):
        pilot.tick()
    assert "p0" in fleet.replicas and "p0" in fleet.ring.nodes
    remapped = [n for n in NAMES if fleet.route(n) == "p0"]
    resident = set(fleet.replicas["p0"].service.studies()) & set(NAMES)
    assert len(resident) == 1 and set(remapped) - resident, (remapped, resident)
    with pytest.raises(ValueError):
        fleet.add_replica("p0")
    drive(client, streams, R - 2)
    assert set(fleet.replicas["p0"].service.studies()) >= set(remapped)
    assert_exact(fleet, root, streams, clean_streams)


def test_kill_during_a_scale_out_replays_bitwise(tmp_path, clean_streams):
    """Under a 10% file-fault storm the pilot, fed only by the scrape,
    scales out; then the victim dies mid-batch.  Zero lost and zero
    duplicated tells, the clean run's streams, and the flight log replayed
    against a fresh service gives them again (fidelity 1.0)."""
    assert set(PILOT_CRASH_POINTS) == {"pilot_after_decision_before_actuate",
                                       "pilot_mid_scale_out"}
    root = str(tmp_path / "kill")
    log = str(tmp_path / "flight.jsonl")
    recorder = FlightRecorder(path=log)
    fleet = make_fleet(root, storm_rate=0.10, arm_victim=("serve_mid_batch", 8), seed=7,
                       recorder=recorder)
    victim = victim_rid()
    pilot = FleetPilot(fleet, config=PilotConfig(min_replicas=2, max_replicas=3,
                                                 queue_high=6.0, shed_high=0, breach_ticks=2,
                                                 clear_ticks=50, cooldown_ticks=2))
    assert pilot.scrape == fleet.metrics_rows
    client = Client(fleet)
    streams = open_all(client)
    drive(client, streams, 1)
    assert pilot.tick().action == "hold"
    build_pressure(fleet)
    assert [pilot.tick().action for _ in range(2)] == ["hold", "scale_out"]
    drive(client, streams, R - 1)
    pilot.tick()
    assert fleet.replicas[victim].dead and fleet.recovery_ms > 0
    assert_exact(fleet, root, streams, clean_streams)
    recorder.flush()
    target = ServiceTarget(SuggestService(SPACE, background=False, max_batch=16,
                                          n_startup_jobs=2, device="cpu", **ALGO_KW))
    replayed = replay_workload(load_workload(log), target)
    target.service.shutdown()
    mine = {n: replayed[n] for n in NAMES}
    assert replay_fidelity(streams, mine) == 1.0 and stream_hash(mine) == stream_hash(streams)


def test_a_flight_log_records_then_replays_bitwise(tmp_path):
    log = str(tmp_path / "flight.jsonl")
    svc = SuggestService(SPACE, background=False, max_batch=4, n_startup_jobs=2,
                         recorder=FlightRecorder(path=log), device="cpu", **ALGO_KW)
    handles = {f"m{i}": svc.create_study(f"m{i}", seed=30 + i) for i in range(3)}
    recorded = {n: [] for n in handles}
    for _ in range(3):
        for n, h in handles.items():
            tid, vals = h.ask()
            h.tell(tid, loss_fn(vals), vals=vals)
            recorded[n].append((tid, dict(vals)))
    svc.recorder.flush()
    svc.shutdown()
    target = ServiceTarget(SuggestService(SPACE, background=False, max_batch=16,
                                          n_startup_jobs=2, device="cpu", **ALGO_KW))
    replayed = replay_workload(load_workload(log), target)
    target.service.shutdown()
    assert replayed == recorded and replay_fidelity(recorded, replayed) == 1.0
    assert stream_hash(dict(reversed(list(recorded.items())))) == stream_hash(replayed)


# ---------------------------------------------------------------------------
# the port's fleet against the reference's fleet
# ---------------------------------------------------------------------------


def _fleet_log(fleet, router):
    """Six studies, four rounds through the router, the victim killed after
    the second: each study's (history count, vals) per ask."""
    for i, n in enumerate(NAMES):
        router.create_study(n, seed=100 + i)
    log = {n: [] for n in NAMES}
    for r in range(R):
        if r == 2:
            fleet.kill_replica(fleet.route(NAMES[0]))
        for n in NAMES:
            tid, vals = router.ask(n, timeout=60)
            log[n].append((len(log[n]), dict(vals)))
            router.tell(n, tid, loss_fn(vals), vals=vals)
    fleet.shutdown()
    return log


def test_fleet_streams_match_the_references_up_to_a_near_tie(tmp_path, spaces):
    jps, tps = spaces
    jfleet = JFleet(J_SPACE, str(tmp_path / "j"), replica_ids=["r0", "r1", "r2"], **KW)
    jlog = _fleet_log(jfleet, JRouter(jfleet))
    tfleet = Fleet(SPACE, str(tmp_path / "t"), replica_ids=["r0", "r1", "r2"], device="cpu",
                   **KW)
    tlog = _fleet_log(tfleet, FleetRouter(tfleet))
    n_tpe = 0
    for n in NAMES:
        rng = np.random.default_rng(100 + NAMES.index(n))
        history = []
        for (k, jvals), (_, tvals) in zip(jlog[n], tlog[n]):
            seed = int(rng.integers(2**31 - 1))
            if k < KW["n_startup_jobs"]:  # a prior draw
                assert {l: v for l, v in jvals.items() if l != "lr"} == \
                       {l: v for l, v in tvals.items() if l != "lr"}, (n, k)
                assert math.isclose(jvals["lr"], tvals["lr"], rel_tol=PRIOR_LOG_RTOL)
            else:
                n_tpe += 1
                jv = np.array([jvals[l] for l in jps.labels], np.float32)
                tv = np.array([tvals[l] for l in jps.labels], np.float32)
                differ = picks_differ(tps, jv, tv)
                if differ.any():  # the first divergence must be the reference's near-tie
                    buf = JObsBuffer(jps)
                    for vals, loss in history:
                        buf.add(dict(vals), loss)
                    arrays = tuple(a[..., : buf._device_bucket(JK.DEFAULT_ABOVE_CAP)]
                                   for a in buf.arrays())
                    margins = ref_margins(jps, arrays, host_key(seed % (2**31 - 1)))
                    assert np.all(margins[differ] < NEAR_TIE), (n, k, margins, differ)
                    break
            history.append((jvals, loss_fn(jvals)))
    assert n_tpe >= len(NAMES)  # the TPE rounds were compared
