"""The port's serve fleet against the JAX reference's, on the CPU.

What the two packages must share exactly, because replicas and routers of
either package serve one fleet: the ring's placement key for key
(``HashRing``, blake2b), the salt (``fleet_salt``, the study family's
guard), the claim file's bytes through acquire, takeover, release and the
handoff mark, and the issue kinds, details and JSON of
``hyperopt-tpu-torch-fsck`` beside the reference's ``fsck`` audits on one
root.  A port replica and a reference replica fence each other over one
root; the reference's ``RouterServer`` fronts the port's backends.

The port's own fleet surfaces: the TCP router in front of two backends
(routing, failover by adoption from the shared root, the drain
broadcast, the probe backoff), the console scripts as processes
(``--owner`` replicas on the CPU behind ``hyperopt-tpu-torch-router``,
one SIGKILLed, then ``hyperopt-tpu-torch-fsck``), ``RemoteStudy``'s
draining backoff and its keyed ask across a failover, and a fleet scrape
that counts each replica's own kernel launches.
"""

import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
import uuid

import pytest

from hyperopt_tpu import hp as jhp
from hyperopt_tpu.distributed import fsck as jfsck
from hyperopt_tpu.serve import HashRing as JRing
from hyperopt_tpu.serve import SuggestService as JService
from hyperopt_tpu.serve.fleet import StudyClaim as JClaim
from hyperopt_tpu.serve.fleet import fleet_salt as j_salt
from hyperopt_tpu.serve.router import RouterServer as JRouter
from hyperopt_tpu.serve.router import _Backend as JBackend
from hyperopt_tpu_torch.client import RemoteStudy
from hyperopt_tpu_torch.distributed import fsck
from hyperopt_tpu_torch.exceptions import Overloaded, OwnershipLost
from hyperopt_tpu_torch.models.synthetic import mixed_space
from hyperopt_tpu_torch.obs.flightrec import FlightRecorder
from hyperopt_tpu_torch.ops import gmm_scores as G
from hyperopt_tpu_torch.serve import Fleet, FleetRouter, HashRing, StudyClaim, SuggestService
from hyperopt_tpu_torch.serve.fleet import fleet_salt
from hyperopt_tpu_torch.serve.router import RouterServer, _Backend
from hyperopt_tpu_torch.serve.service import RETRY_AFTER_CAP, _serve_error_reply, serve_forever

from test_torch_serve import ALGO_KW, SPACE, loss_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_SPACE = {
    "x": jhp.uniform("x", -5, 5),
    "lr": jhp.loguniform("lr", -5, 0),
    "q": jhp.quniform("q", 0, 10, 1),
    "c": jhp.choice("c", [0, 1, 2]),
}
KW = dict(max_batch=8, n_startup_jobs=2, device="cpu", **ALGO_KW)
KEYS = [f"study-{i:04d}" for i in range(2000)]
NODES = [f"r{i}" for i in range(5)]
VALS = {"x": 0.1, "lr": 0.5, "q": 3.0, "c": 0}


def service(root=None, owner=None, **kw):
    return SuggestService(SPACE, root=root, owner=owner, background=False,
                          **{**KW, **kw})


def crash(svc):
    """A replica's process dies: no final snapshot, no claim release."""
    for st in svc.scheduler._studies.values():
        if st.persist is not None:
            st.persist.wal.close()


# ---------------------------------------------------------------------------
# the ring and the salt: the reference's placement, key for key
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("salt,vnodes", [("fp", 64), ("other-fp", 32), (None, 64)])
def test_ring_placement_equals_the_references(salt, vnodes):
    """Every key lands where the reference's ring puts it, before and
    after a replica leaves and a new one joins."""
    if salt is None:
        salt = fleet_salt("tpe", SPACE)
    ours, theirs = HashRing(NODES, salt=salt, vnodes=vnodes), JRing(NODES, salt=salt,
                                                                   vnodes=vnodes)
    assert ours.placement(KEYS) == theirs.placement(KEYS)
    for ring in (ours, theirs):
        ring.remove("r2")
        ring.add("r5")
    assert ours.placement(KEYS) == theirs.placement(KEYS)
    assert ours.placement(KEYS, exclude={"r0"}) == theirs.placement(KEYS, exclude={"r0"})


def test_ring_moves_only_the_right_keys():
    """Removing a replica moves its keys and no others; adding one moves
    about 1/N of the keys, all to the new replica."""
    ring = HashRing(NODES, salt="fp")
    before = ring.placement(KEYS)
    ring.remove("r2")
    after = ring.placement(KEYS)
    assert all(after[k] == before[k] for k in KEYS if before[k] != "r2")
    moved = sum(before[k] != after[k] for k in KEYS)
    assert moved == sum(before[k] == "r2" for k in KEYS)
    assert len(KEYS) / (2 * len(NODES)) <= moved <= 2 * len(KEYS) / len(NODES)
    ring.add("r5")
    again = ring.placement(KEYS)
    grown = [k for k in KEYS if again[k] != after[k]]
    assert grown and all(again[k] == "r5" for k in grown)
    assert len(grown) <= 2 * len(KEYS) / len(NODES)


def test_fleet_salt_is_equal_across_the_packages():
    from hyperopt_tpu.models.synthetic import mixed_space as j_mixed

    assert fleet_salt("tpe", SPACE) == j_salt("tpe", J_SPACE)
    assert fleet_salt("tpe", mixed_space()) == j_salt("tpe", j_mixed())
    assert fleet_salt("anneal", SPACE) == j_salt("anneal", J_SPACE)
    assert fleet_salt("tpe", SPACE) != fleet_salt("anneal", SPACE)


# ---------------------------------------------------------------------------
# the claim file: the reference's bytes; replicas of both packages fence
# each other over one root
# ---------------------------------------------------------------------------


def _claim_history(Claim, root, monkeypatch):
    """The claim file's bytes after each step of acquire, a refused steal,
    takeover, the fence, release, re-acquire and a handoff release; the
    tokens come from one fixed uuid sequence."""
    tokens = iter(uuid.UUID(int=i) for i in range(1, 100))
    monkeypatch.setattr(uuid, "uuid4", lambda: next(tokens))
    path = os.path.join(root, "s.claim")
    history = []

    def snap():
        with open(path, "rb") as f:
            history.append(f.read())

    c0 = Claim.acquire(root, "s", "r0")
    snap()
    with pytest.raises(Exception) as ei:
        Claim.acquire(root, "s", "r1")
    assert type(ei.value).__name__ == "OwnershipLost"
    c1 = Claim.acquire(root, "s", "r1", takeover=True)
    snap()
    assert not c0.is_live() and c1.is_live() and c1.epoch == 1
    c0.release()  # a stale release is a no-op
    snap()
    c1.release()
    snap()
    c2 = Claim.acquire(root, "s", "r2")
    snap()
    c2.release(handoff=True)
    snap()
    return history


def test_claim_file_bytes_equal_the_references(tmp_path, monkeypatch):
    ours = _claim_history(StudyClaim, str(tmp_path / "ours"), monkeypatch)
    theirs = _claim_history(JClaim, str(tmp_path / "theirs"), monkeypatch)
    assert ours == theirs
    assert json.loads(ours[-1]) == {"epoch": 4, "handoff": True, "released": True,
                                    "replica": None, "token": None}


def test_port_and_reference_replicas_fence_each_other(tmp_path):
    """One root, a port replica and a reference replica: a live claim
    refuses the other package's plain open, a takeover fences the previous
    owner out, and the study moves across with its history."""
    root = str(tmp_path / "shared")
    ours = service(root=root, owner="t0", snapshot_cadence=1000)
    theirs = JService(J_SPACE, root=root, owner="j0", background=False, max_batch=8,
                      n_startup_jobs=2, snapshot_cadence=1000, **ALGO_KW)
    try:
        h = ours.create_study("s", seed=5)
        tid, vals = h.ask()
        h.tell(tid, loss_fn(vals))
        with pytest.raises(Exception) as ei:
            theirs.create_study("s")
        assert type(ei.value).__name__ == "OwnershipLost"
        jh = theirs.create_study("s", takeover=True)
        assert jh.n_tells == 1 and StudyClaim.read(root, "s")["replica"] == "j0"
        with pytest.raises(OwnershipLost):
            h.ask()
        with pytest.raises(OwnershipLost):
            h.tell(99, 0.5, vals=VALS)
        jt, jv = jh.ask()
        jh.tell(jt, loss_fn(jv))
        # and back: the port's replica adopts, the reference's is fenced
        h2 = ours.create_study("s", takeover=True)
        assert h2.n_tells == 2 and h2._study.buf.tids[:2].tolist() == [tid, jt]
        with pytest.raises(Exception) as ei:
            jh.ask()
        assert type(ei.value).__name__ == "OwnershipLost"
        doc = StudyClaim.read(root, "s")
        assert doc["replica"] == "t0" and doc["epoch"] == 2
    finally:
        theirs.shutdown()
        ours.shutdown()


def test_a_fenced_replica_never_writes_into_the_new_owners_root(tmp_path):
    """A replica closing (or handing off) a study it was fenced off from
    writes no snapshot and releases nothing: the new owner's log stays
    the truth."""
    root = str(tmp_path / "root")
    a, b = service(root=root, owner="a", snapshot_cadence=2), service(root=root, owner="b",
                                                                    snapshot_cadence=2)
    ha = a.create_study("s", seed=1)
    for _ in range(2):
        tid, vals = ha.ask()
        ha.tell(tid, loss_fn(vals))
    hb = b.create_study("s", takeover=True)
    for _ in range(3):
        tid, vals = hb.ask()
        hb.tell(tid, loss_fn(vals))
    a.close_study("s")  # fenced: forgotten, nothing written
    assert StudyClaim.read(root, "s")["replica"] == "b"
    b.close_study("s")
    c = service(root=root, owner="c")
    assert c.create_study("s").n_tells == 5
    for svc in (a, b, c):
        svc.shutdown()


# ---------------------------------------------------------------------------
# the draining refusal carries retry_after
# ---------------------------------------------------------------------------


def test_draining_overloaded_carries_retry_after():
    svc = service()
    h = svc.create_study("d0", seed=1)
    svc.drain(timeout=9.0, block=False)
    with pytest.raises(Overloaded) as ei:
        h.ask_async()
    e = ei.value
    assert e.reason == "draining" and 1.0 < e.retry_after <= 9.0
    time.sleep(0.05)
    with pytest.raises(Overloaded) as ei2:
        h.ask_async()
    assert ei2.value.retry_after < e.retry_after
    reply = _serve_error_reply(e)
    assert (reply["error_type"], reply["reason"], reply["retry_after"]) == (
        "Overloaded", "draining", e.retry_after)
    assert _serve_error_reply(Overloaded("bare", reason="draining"))["retry_after"] > 0
    svc.shutdown()


def test_remote_study_honours_a_draining_replicas_retry_after():
    """``RemoteStudy`` sleeps a draining refusal's ``retry_after`` (capped)
    and retries; past its retries the typed refusal surfaces with its
    hint."""
    svc = SuggestService(SPACE, background=True, **KW)
    srv = serve_forever(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c = RemoteStudy(*srv.server_address[:2], "d", seed=1, max_retries=2)
        svc.drain(timeout=0.2, block=False)
        t0 = time.perf_counter()
        with pytest.raises(Overloaded) as ei:
            c.ask(timeout=30)
        assert ei.value.reason == "draining" and ei.value.retry_after is not None
        assert c.stats["typed:Overloaded"] == 3 and c.stats["retries"] == 2
        assert time.perf_counter() - t0 < 3 * RETRY_AFTER_CAP
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        svc.shutdown()


# ---------------------------------------------------------------------------
# fsck: the reference's issue kinds and details, one root, both tools
# ---------------------------------------------------------------------------


def _docs(issues):
    return [{"kind": i.kind, "path": i.path, "detail": i.detail} for i in issues]


def _json_report(capsys, argv):
    rc = fsck.main(argv + ["--format", "json"])
    return rc, json.loads(capsys.readouterr().out)


def test_fsck_serve_equals_the_reference_then_restorable(tmp_path, capsys):
    """A root damaged with every kind a killed replica can leave: both
    tools find the same issues (kind, path, detail), the port's JSON report
    lists them, the repair leaves both audits clean, and every family
    restores."""
    root = str(tmp_path / "root")
    svc = service(root=root, owner="r0", snapshot_cadence=2)
    ha = svc.create_study("a", seed=1)
    for tid in range(3):
        ha.tell(tid, 0.5 + tid, vals=VALS)
    hb = svc.create_study("b", seed=2)
    hb.tell(0, 1.5, vals=VALS)
    crash(svc)
    with open(os.path.join(root, "a.wal"), "ab") as f:
        f.write(b"\x00garbage torn tail")
    with open(os.path.join(root, "b.snap"), "wb") as f:
        pickle.dump({"guard": ["foreign", 0, "algo", "fp"]}, f)
    with open(os.path.join(root, "zz.claim"), "w") as f:
        f.write(json.dumps({"replica": "gone", "token": "t", "epoch": 3}))
    tmp = os.path.join(root, "a.snap.tmp.999")
    with open(tmp, "w") as f:
        f.write("half")
    os.utime(tmp, (time.time() - 600, time.time() - 600))

    ours, theirs = fsck.audit_serve(root), jfsck.audit_serve(root)
    assert _docs(ours) == _docs(theirs)
    assert {i.kind for i in ours} == {"wal_torn_tail", "ckpt_fingerprint_mismatch",
                                      "claim_orphaned", "orphaned_snapshot_tmp"}
    rc, report = _json_report(capsys, ["--serve", root])
    assert rc == 1 and report["issues"] == [fsck.issue_doc(i) for i in theirs]
    assert report["repaired"] is None and report["remaining"] is None
    rc, report = _json_report(capsys, ["--serve", root, "--repair"])
    assert rc == 0 and report["repaired"] == len(theirs) and report["remaining"] == []
    assert fsck.audit_serve(root) == [] and jfsck.audit_serve(root) == []
    svc2 = service(root=root, owner="r1")
    assert svc2.create_study("a", takeover=True).n_tells == 3
    assert svc2.create_study("b", takeover=True).n_tells == 1
    svc2.shutdown()
    assert fsck.main(["--serve", root]) == 0
    assert capsys.readouterr().out.strip().endswith("clean")


def test_fsck_serve_cross_host_kinds_equal_the_references(tmp_path, capsys):
    """A stale foreign claim, a half-migrated handoff and a WAL replaced
    under its bundle: the same issues from both tools, repaired by the
    port's, and every family adopts afterwards."""
    root = str(tmp_path / "nfs")
    a = service(root=root, owner="hostA")
    h = a.create_study("a", seed=1)
    for _ in range(3):
        t, vals = h.ask()
        h.tell(t, 0.5, vals=vals)
    crash(a)
    b = service(root=root, owner="hostB")
    hb = b.create_study("b", seed=2)
    t, vals = hb.ask()
    hb.tell(t, 1.0, vals=vals)
    b.handoff_study("b")
    c = service(root=root, owner="hostC")
    hc = c.create_study("c", seed=3)
    for _ in range(3):
        t, vals = hc.ask()
        hc.tell(t, 2.0, vals=vals)
    c.close_study("c")
    with open(os.path.join(root, "c.wal"), "wb"):
        pass
    live = {"hostB", "hostC"}
    for kw in ({}, {"live_owners": live}):
        assert _docs(fsck.audit_serve(root, **kw)) == _docs(jfsck.audit_serve(root, **kw))
    issues = fsck.audit_serve(root, live_owners=live)
    assert {i.kind for i in issues} == {"claim_stale_foreign", "study_half_migrated",
                                        "wal_snap_divergent"}
    rc, report = _json_report(capsys, ["--serve", root, "--live-owner", "hostB",
                                       "--live-owner", "hostC", "--repair"])
    assert rc == 0 and report["repaired"] == 3 and report["remaining"] == []
    assert jfsck.audit_serve(root, live_owners=live) == []
    d = service(root=root, owner="hostD")
    assert d.create_study("a").n_tells == 3
    assert d.create_study("b").n_tells == 1
    assert d.create_study("c", takeover=True).n_tells == 3
    for svc in (b, c, d):
        svc.shutdown()


def test_fsck_driver_obs_and_dir_equal_the_references(tmp_path, capsys):
    """``--driver`` on a killed durable fmin's family, ``--obs`` on a torn
    flight log, ``--dir`` on a queue directory's residue: both tools find
    the same issues, and the port's repair leaves both clean."""
    import numpy as np

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch.models.synthetic import mixed_space_fn

    ckpt = str(tmp_path / "drv" / "ckpt")
    os.makedirs(os.path.dirname(ckpt))
    H.fmin(mixed_space_fn, mixed_space(), max_evals=6, trials=H.Trials(),
           rstate=np.random.default_rng(0), device="cpu", trials_save_file=ckpt,
           show_progressbar=False)
    with open(ckpt + ".wal", "ab") as f:
        f.write(b"\x00torn")
    stale = ckpt + ".tmp.4242"
    with open(stale, "w") as f:
        f.write("x")
    os.utime(stale, (time.time() - 600, time.time() - 600))

    log = str(tmp_path / "flight.jsonl")
    rec = FlightRecorder(path=log)
    svc = SuggestService(SPACE, background=False, recorder=rec, **KW)
    hs = svc.create_study("f", seed=1)
    tid, vals = hs.ask()
    hs.tell(tid, loss_fn(vals))
    svc.shutdown()
    with open(log, "ab") as f:
        f.write(b'{"name": "torn')

    qdir = str(tmp_path / "queue")
    for sub in ("new", "running", "done"):
        os.makedirs(os.path.join(qdir, sub))
    for sub, name in (("done", "j1.json"), ("running", "j1.json"), ("new", "j2.json"),
                      ("running", "j2.json"), ("running", "j3.json")):
        with open(os.path.join(qdir, sub, name), "w") as f:
            json.dump({"tid": int(name[1]), "state": sub}, f)
    with open(os.path.join(qdir, "new", "j4.json"), "w") as f:
        f.write('{"tid": ')
    old = time.time() - 600
    os.utime(os.path.join(qdir, "running", "j3.json"), (old, old))
    qtmp = os.path.join(qdir, "new", "j5.json.tmp.77")
    with open(qtmp, "w") as f:
        f.write("{")
    os.utime(qtmp, (old, old))

    cases = [
        (["--driver", ckpt], lambda: fsck.audit_driver(ckpt), lambda: jfsck.audit_driver(ckpt),
         {"wal_torn_tail", "orphaned_snapshot_tmp"}),
        (["--obs", log], lambda: fsck.audit_obs(log), lambda: jfsck.audit_obs(log),
         {"obs_torn_tail"}),
        (["--dir", qdir], lambda: fsck.audit(qdir, reserve_timeout=120.0),
         lambda: jfsck.audit(qdir, reserve_timeout=120.0),
         {"completed_claim", "duplicate_tid", "half_written", "orphaned_claim", "stale_tmp"}),
    ]
    for argv, ours, theirs, kinds in cases:
        got = ours()
        assert _docs(got) == _docs(theirs()), argv
        assert {i.kind for i in got} == kinds, (argv, got)
        rc, report = _json_report(capsys, argv)
        assert rc == 1 and report["issues"] == _docs(got)
        rc, report = _json_report(capsys, argv + ["--repair"])
        assert rc == 0 and report["remaining"] == [], (argv, report)
        assert ours() == [] and theirs() == [], argv


# ---------------------------------------------------------------------------
# the TCP router
# ---------------------------------------------------------------------------


class _Client:
    def __init__(self, host, port):
        self.sock = socket.create_connection((host, port), timeout=30)
        self.f = self.sock.makefile("rwb")

    def rpc(self, **req):
        self.f.write((json.dumps(req) + "\n").encode())
        self.f.flush()
        return json.loads(self.f.readline())

    def close(self):
        self.f.close()
        self.sock.close()


def _spawn(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _backends(root, rids=("b0", "b1")):
    svcs, servers = {}, {}
    for rid in rids:
        svc = SuggestService(SPACE, root=root, owner=rid, background=True, **KW)
        svcs[rid], servers[rid] = svc, _spawn(serve_forever(svc, port=0))
    return svcs, servers


def _stop(svcs, servers, *routers):
    for rsrv in routers:
        rsrv.shutdown()
        rsrv.server_close()
    for rid in servers:
        try:
            servers[rid].shutdown()
            servers[rid].server_close()
            svcs[rid].shutdown()
        except Exception:
            pass


@pytest.mark.parametrize("package", ["port", "reference"])
def test_tcp_router_routes_and_fails_over(tmp_path, package):
    """Two port backends on one root behind a router, the port's or the
    reference's (the wire is the reference's): both hold a share, and
    when one dies its studies are adopted by the survivor from the root."""
    root = str(tmp_path / "root")
    svcs, servers = _backends(root)
    Router, Backend = (RouterServer, _Backend) if package == "port" else (JRouter, JBackend)
    router = Router([Backend(rid, *servers[rid].server_address[:2]) for rid in servers],
                    salt=fleet_salt("tpe", SPACE))
    rsrv = _spawn(router.serve_forever(port=0))
    cli = _Client(*rsrv.server_address[:2])
    names = ["t6", "t7", "d0", "d3"]  # two on each backend
    try:
        assert cli.rpc(op="ping")["router"] is True and cli.rpc(op="ready")["ready"] is True
        for i, n in enumerate(names):
            assert cli.rpc(op="create_study", name=n, seed=40 + i)["ok"]
        assert cli.rpc(op="studies")["studies"] == sorted(names)
        shares = {rid: len(svc.studies()) for rid, svc in svcs.items()}
        assert all(v > 0 for v in shares.values()), shares
        for n in names:
            r = cli.rpc(op="ask", study=n, timeout=30)
            assert r["ok"], r
            assert cli.rpc(op="tell", study=n, tid=r["tid"], loss=0.25)["ok"]
        scrape = cli.rpc(op="metrics")
        assert scrape["replicas"] == ["b0", "b1"] and 'replica="b1"' in scrape["text"]
        dead = "b0"
        moved = svcs[dead].studies()
        servers[dead].shutdown()
        servers[dead].server_close()
        crash(svcs[dead])
        cli2 = _Client(*rsrv.server_address[:2])
        for n in names:
            r = cli2.rpc(op="ask", study=n, timeout=30, recover=True)
            assert r["ok"], (n, r)
            assert cli2.rpc(op="tell", study=n, tid=r["tid"], loss=0.5)["ok"]
            assert cli2.rpc(op="best", study=n)["best"] is not None
        assert moved and set(moved) <= set(svcs["b1"].studies())
        for n in moved:
            assert svcs["b1"].scheduler.study(n).persist.wal.total_tells == 2
        cli2.close()
    finally:
        cli.close()
        _stop(svcs, servers, rsrv)


def test_tcp_router_drain_broadcast_and_ask_batch(tmp_path):
    """``ask_batch`` through the router is one frame per backend; ``drain``
    reaches every backend, and the reply carries the slowest hint."""
    root = str(tmp_path / "root")
    svcs, servers = _backends(root)
    router = RouterServer([_Backend(rid, *servers[rid].server_address[:2]) for rid in servers],
                          salt=fleet_salt("tpe", SPACE))
    rsrv = _spawn(router.serve_forever(port=0))
    cli = _Client(*rsrv.server_address[:2])
    try:
        names = [f"d{i}" for i in range(4)]
        for i, n in enumerate(names):
            assert cli.rpc(op="create_study", name=n, seed=i)["ok"]
        got = cli.rpc(op="ask_batch", names=names, timeout=30)
        assert got["ok"] and all(got["results"][n]["ok"] for n in names)
        r = cli.rpc(op="drain", timeout=5.0)
        assert r["ok"] and r["replicas"] == {"b0": True, "b1": True}
        assert 0 < r["retry_after"] <= RETRY_AFTER_CAP
        assert all(svc.scheduler.draining for svc in svcs.values())
    finally:
        cli.close()
        _stop(svcs, servers, rsrv)


def test_router_probe_backoff_schedule():
    """A backend that stays down is probed on sweeps 0, 2, 5, 10, 19, 28
    (the reference's schedule); one success rejoins it and resets it."""
    router = RouterServer([_Backend("b0", "127.0.0.1", 1)], salt="fp", probe_backoff_cap=8)
    state = {"ok": False}

    def rpc(conns, rid, req, timeout=30.0):
        if not state["ok"]:
            raise ConnectionError("down")
        return {"ok": True}

    router._rpc = rpc
    probed = []
    for sweep in range(29):
        before = router._probes_total.value
        router.probe_backends()
        if router._probes_total.value > before:
            probed.append(sweep)
    assert probed == [0, 2, 5, 10, 19, 28] and "b0" in router._alive_excluded()
    state["ok"] = True
    for _ in range(9):
        router.probe_backends()
    assert "b0" not in router._alive_excluded() and router._rejoins.value == 1
    assert router._probe_fails == {} and router._probe_wait == {}


def test_remote_study_keeps_its_keyed_ask_across_a_failover(tmp_path):
    """An ask whose reply was lost is sent again with its ``ask_id`` after
    its replica died: the survivor adopts the study from the root and
    serves the same tid and vals, and a third copy is the same again."""
    root = str(tmp_path / "root")
    svcs, servers = _backends(root)
    router = RouterServer([_Backend(rid, *servers[rid].server_address[:2]) for rid in servers],
                          salt=fleet_salt("tpe", SPACE))
    rsrv = _spawn(router.serve_forever(port=0))
    try:
        c = RemoteStudy(*rsrv.server_address[:2], "k", seed=3, takeover=True)
        tid, vals = c.ask(timeout=30)
        c.tell(tid, loss_fn(vals), vals)
        owner = router.ring.owner("k")
        first = c.call({"op": "ask", "study": "k", "timeout": 30, "ask_id": "A"})
        servers[owner].shutdown()
        servers[owner].server_close()
        crash(svcs[owner])
        c.close()  # the reply was lost: the copy goes out on a new connection
        c = RemoteStudy(*rsrv.server_address[:2], "k", create=False)
        again = c.call({"op": "ask", "study": "k", "timeout": 30, "ask_id": "A",
                        "recover": True})
        third = c.call({"op": "ask", "study": "k", "timeout": 30, "ask_id": "A"})
        assert (again["tid"], again["vals"]) == (first["tid"], first["vals"]) == (
            third["tid"], third["vals"])
        survivor = next(r for r in svcs if r != owner)
        assert "k" in svcs[survivor].studies()
        c.tell(first["tid"], loss_fn(first["vals"]), first["vals"])
        assert svcs[survivor].scheduler.study("k").persist.wal.total_tells == 2
        c.close()
    finally:
        _stop(svcs, servers, rsrv)


# ---------------------------------------------------------------------------
# the console scripts as processes
# ---------------------------------------------------------------------------


def _start(args, module):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _port_of(proc):
    line = proc.stdout.readline()
    assert "listening on 127.0.0.1:" in line, (line, proc.stderr.read()[-3000:])
    return int(line.split("127.0.0.1:")[1].split()[0])


def test_console_scripts_owner_replicas_router_and_fsck(tmp_path, capsys):
    """Two ``hyperopt-tpu-torch-serve --owner`` replicas on one root (the
    CPU asked for), started together, behind ``hyperopt-tpu-torch-router
    --salt`` given the fleet's ``fleet_salt``; the replica owning the first
    study is SIGKILLed mid-run, the router fails over (the survivor adopts
    every study by takeover), and ``hyperopt-tpu-torch-fsck --serve`` holds
    the root to the survivor's claims: clean with the survivor live, every
    claim stale with only the dead replica named live, and clean once the
    replicas closed their studies."""
    root = str(tmp_path / "root")
    space = "hyperopt_tpu_torch.models.synthetic:mixed_space"
    reps = {rid: _start(["--space", space, "--port", "0", "--root", root, "--owner", rid,
                         "--n-startup-jobs", "2", "--device", "cpu"],
                        "hyperopt_tpu_torch.serve.service") for rid in ("r0", "r1")}
    router = None
    try:
        ports = {rid: _port_of(p) for rid, p in reps.items()}
        salt = fleet_salt("tpe", mixed_space())
        router = _start(["--salt", salt, "--port", "0", "--probe-interval", "0",
                         "--read-timeout", "30"]
                        + [f"--backend={rid}=127.0.0.1:{port}" for rid, port in ports.items()],
                        "hyperopt_tpu_torch.serve.router")
        rport = _port_of(router)
        ring = HashRing(ports, salt=salt)
        names = ["p0", "p1", "p2"]
        clients = {n: RemoteStudy("127.0.0.1", rport, n, seed=i, read_timeout=60)
                   for i, n in enumerate(names)}
        for n, c in clients.items():
            tid, vals = c.ask(timeout=60)
            c.tell(tid, 0.5, vals)
        victim = ring.owner(names[0])
        reps[victim].send_signal(signal.SIGKILL)
        reps[victim].wait(timeout=30)
        for n, c in clients.items():
            tid, vals = c.ask(timeout=60)
            assert tid == 1, (n, tid)
            c.tell(tid, 0.25, vals)
            c.close()
        survivor = next(r for r in ports if r != victim)
        assert {StudyClaim.read(root, n)["replica"] for n in names} == {survivor}
        rc, report = _json_report(capsys, ["--serve", root, "--live-owner", survivor])
        assert rc == 0 and report["issues"] == [], report
        rc, report = _json_report(capsys, ["--serve", root, "--live-owner", victim])
        assert rc == 1 and [i["kind"] for i in report["issues"]] == ["claim_stale_foreign"] * 3
    finally:
        for p in list(reps.values()) + ([router] if router else []):
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
            p.stdout.close()
            p.stderr.close()
    rc, report = _json_report(capsys, ["--serve", root])
    assert rc == 0 and report["issues"] == [], report  # the survivor closed every study
    proc = subprocess.run([sys.executable, "-m", "hyperopt_tpu_torch.distributed.fsck",
                           "--serve", root, "--format", "json"], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and json.loads(proc.stdout)["issues"] == []


# ---------------------------------------------------------------------------
# the fleet scrape counts each replica's own kernel launches
# ---------------------------------------------------------------------------


def test_fleet_scrape_counts_each_replicas_own_launches(tmp_path, monkeypatch):
    """Three replicas in one process: each one's ``serve_kernel_launches``
    counts the launches of its own rounds, and the rows sum to the
    process's launches (the wrapper's plain version counts as a launch
    here, where no kernel runs)."""
    real = G.gmm_llr_plain

    def counted(*args, **kw):
        G.KERNEL.count_launch()
        return real(*args, **kw)

    monkeypatch.setattr(G, "gmm_llr_plain", counted)
    G.KERNEL.launches = 0
    fleet = Fleet(SPACE, str(tmp_path / "root"), n_replicas=3, **KW)
    router = FleetRouter(fleet)
    names = [f"s{i}" for i in range(9)]
    for i, n in enumerate(names):
        router.create_study(n, seed=i)
    for _ in range(4):  # two startup rounds, then two rounds of the TPE body
        for n, (tid, vals) in router.ask_batch(names).items():
            router.tell(n, tid, loss_fn(vals), vals=vals)
    rows = [r for r in fleet.metrics_rows() if r["name"] == "serve_kernel_launches"]
    per = {r["labels"]["replica"]: r["value"] for r in rows}
    dispatches = {rid: rep.service.counters["dispatch_count"]
                  for rid, rep in fleet.replicas.items()}
    assert sorted(per) == ["r0", "r1", "r2"]
    assert per == dispatches  # the stacked step runs the TPE body every round
    assert sum(per.values()) == G.KERNEL.launches > 0
    fleet.shutdown()
