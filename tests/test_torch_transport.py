"""The port's socket transport against the reference's: the TCP front
(``serve_forever``), the console script (``main``, ``_load_space``), the
exactly-once study client (``RemoteStudy``) and network fault injection
(``NetFaultPlan``), as ``tests/test_burst.py``, ``tests/test_netstorm.py``
and ``tests/test_serve.py`` hold the reference's.

Across the packages, in one process: the port's ``RemoteStudy`` against
the reference's server and the reference's against the port's; the two
servers' replies to one request script are the same bytes through the
startup asks and equal after them up to a first divergence that is a
near-tie of the reference's own ask (llr margin < NEAR_TIE, the rule of
``test_torch_serve_batched.py``); and ``NetFaultPlan`` makes the
reference's decisions for one seed over one scripted sequence of
operations.  Every server here binds port 0 on 127.0.0.1, every socket
has a read deadline, and every server is shut down in a ``finally``.
"""

import io
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from hyperopt_tpu import hp as jhp
from hyperopt_tpu.client import RemoteStudy as JRemoteStudy
from hyperopt_tpu.distributed import netfaults as JN
from hyperopt_tpu.jax_trials import ObsBuffer as JObsBuffer, host_key
from hyperopt_tpu.ops.compile import compile_space as j_compile
from hyperopt_tpu.serve import SuggestService as JService
from hyperopt_tpu.serve.service import serve_forever as j_serve_forever
from hyperopt_tpu_torch import hp
from hyperopt_tpu_torch.client import RemoteStudy
from hyperopt_tpu_torch.distributed.faults import (
    ALL_CRASH_POINTS,
    NET_CRASH_POINTS,
    NetFaultPlan,
    SimulatedCrash,
)
from hyperopt_tpu_torch.exceptions import NetworkTimeout, Overloaded, PeerUnreachable
from hyperopt_tpu_torch.models.synthetic import mixed_space_fn
from hyperopt_tpu_torch.ops.compile import compile_space as t_compile
from hyperopt_tpu_torch.serve import SuggestService
from hyperopt_tpu_torch.serve.frames import FrameConn, dial, read_frame
from hyperopt_tpu_torch.serve.service import _load_space, main, serve_forever

from test_torch_serve import ALGO_KW, NEAR_TIE
from test_torch_serve_batched import picks_differ, ref_margins

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def space(h):
    """No log-space dim, so the prior draws of both packages are bitwise
    (``test_torch_serve_batched.py``: PyTorch's ``exp`` is not XLA's)."""
    return {"x": h.uniform("x", -5, 5), "q": h.quniform("q", 0, 10, 1),
            "c": h.choice("c", [0, 1, 2])}


N_STARTUP = 2


def loss_fn(vals):
    return (vals["x"] - 1) ** 2 / 10 + abs(vals["q"] - 4) / 5 + 0.1 * vals["c"]


def service(**kw):
    kw.setdefault("background", True)
    return SuggestService(space(hp), max_batch=8, n_startup_jobs=N_STARTUP, device="cpu",
                          **ALGO_KW, **kw)


def spawn(svc, **kw):
    srv = serve_forever(svc, port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def teardown(svc, srv):
    srv.shutdown()
    srv.server_close()
    svc.shutdown()


def json_rpc(sock):
    f = sock.makefile("rwb")

    def rpc(**req):
        f.write((json.dumps(req) + "\n").encode())
        f.flush()
        return json.loads(f.readline())

    return rpc, f


# ---------------------------------------------------------------------------
# the front, on both protocols
# ---------------------------------------------------------------------------


def test_json_line_round_trip():
    svc = service(max_wait_ms=1.0)
    srv = spawn(svc)
    try:
        with socket.create_connection(srv.server_address[:2], timeout=30) as sock:
            rpc, f = json_rpc(sock)
            assert rpc(op="ping")["pong"]
            assert rpc(op="create_study", name="demo", seed=3) == {
                "ok": True, "study": "demo", "n_tells": 0}
            assert rpc(op="studies")["studies"] == ["demo"]
            for _ in range(3):
                r = rpc(op="ask", study="demo", timeout=30)
                assert r["ok"], r
                assert type(r["tid"]) is int and type(r["vals"]["c"]) is int
                assert type(r["vals"]["x"]) is float
                assert rpc(op="tell", study="demo", tid=r["tid"], loss=loss_fn(r["vals"]))["ok"]
            best = rpc(op="best", study="demo")
            assert best["ok"] and best["best"]["loss"] >= 0
            assert rpc(op="ask", study="nope")["error_type"] == "UnknownStudy"
            assert not rpc(op="frobnicate")["ok"]
            assert rpc(op="health")["counters"]["dispatch_count"] == 3
            assert rpc(op="ready")["ready"] is True
            metrics = rpc(op="metrics")
            rows = {r["name"]: r.get("value") for r in metrics["metrics"]}
            assert rows["serve_dispatch_total"] == 3 and "serve_dispatch_total 3" in metrics["text"]
            assert rpc(op="trace", tail=5) == {"ok": True, "spans": []}
            assert rpc(op="close_study", study="demo")["ok"]
            f.close()
    finally:
        teardown(svc, srv)


def test_binary_pipelined_round_trip():
    svc = service()
    srv = spawn(svc)
    sock, f = dial(*srv.server_address[:2], read_timeout=30)
    conn = FrameConn(f)
    try:
        assert conn.binary is True  # negotiated up
        futs = [conn.submit({"op": "ping"}),
                conn.submit({"op": "create_study", "name": "s", "seed": 3}),
                conn.submit({"op": "ask", "study": "s", "timeout": 30}),
                conn.submit({"op": "studies"})]
        ping, created, ask, studies = [conn.drain(fut) for fut in futs]
        assert ping["pong"] is True and created["ok"] and ask["ok"], (created, ask)
        assert studies["studies"] == ["s"]
        assert [r["rid"] for r in (ping, created, ask, studies)] == [0, 1, 2, 3]
        assert conn.call({"op": "tell", "study": "s", "tid": ask["tid"], "loss": 0.5})["ok"]
        assert svc.scheduler.study("s").buf.count == 1
    finally:
        conn.close()
        sock.close()
        teardown(svc, srv)


def test_a_json_client_against_the_binary_server_stays_on_json():
    svc = service()
    srv = spawn(svc)
    try:
        with socket.create_connection(srv.server_address[:2], timeout=30) as sock:
            rpc, f = json_rpc(sock)
            assert rpc(op="create_study", name="s", seed=3)["ok"]
            r = rpc(op="ask", study="s", timeout=30, rid=41)
            assert r["ok"] and r["rid"] == 41, r
            assert rpc(op="tell", study="s", tid=r["tid"], loss=0.5)["ok"]
            f.close()
    finally:
        teardown(svc, srv)


def test_a_binary_client_against_a_json_only_server_falls_back():
    """The reference's pre-frames peer shape (``hello`` unknown, no rid
    echo): the port's ``FrameConn`` stays on JSON lines, FIFO."""
    from test_torch_frames import _OldJsonHandler, _peer

    srv = _peer(_OldJsonHandler)
    sock, f = dial(*srv.server_address[:2], read_timeout=30)
    conn = FrameConn(f)
    try:
        assert conn.binary is False
        futs = [conn.submit({"op": "x", "n": i}) for i in range(3)]
        assert [conn.drain(fut)["echo"] for fut in futs] == [0, 1, 2]
    finally:
        conn.close()
        sock.close()
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("garbage", [b"\x00\x00\x00\x00", b"\x00\x00\x00\x64short"],
                         ids=["malformed", "truncated"])
def test_a_bad_frame_is_a_typed_error_not_a_hang(garbage):
    svc = service()
    srv = spawn(svc)
    sock, f = dial(*srv.server_address[:2], read_timeout=30)
    conn = FrameConn(f)
    try:
        assert conn.binary is True
        conn.f.write(garbage)
        conn.f.flush()
        sock.shutdown(socket.SHUT_WR)  # EOF mid-frame for the truncated one
        reply = read_frame(conn.f)
        assert reply["ok"] is False and reply["error_type"] == "FrameError", reply
        assert read_frame(conn.f) is None  # the server hung up
    finally:
        conn.close()
        sock.close()
        teardown(svc, srv)


def test_a_malformed_json_line_is_typed_and_keeps_the_connection():
    svc = service()
    srv = spawn(svc)
    try:
        with socket.create_connection(srv.server_address[:2], timeout=30) as sock:
            rpc, f = json_rpc(sock)
            f.write(b"{not json\n[1, 2]\n")
            f.flush()
            for _ in range(2):
                assert json.loads(f.readline())["error_type"] == "FrameError"
            assert rpc(op="ping")["pong"]
            f.close()
    finally:
        teardown(svc, srv)


@pytest.mark.parametrize("background", [True, False], ids=["loop", "pumped"])
def test_ask_batch_coalesces_into_one_round(background):
    """One ``ask_batch`` frame for three studies is one device round; on a
    service without a loop the handler's thread pumps it."""
    svc = service(background=background)
    srv = spawn(svc)
    sock, f = dial(*srv.server_address[:2], read_timeout=30)
    conn = FrameConn(f)
    names = ["a", "b", "c"]
    try:
        for i, n in enumerate(names):
            assert conn.call({"op": "create_study", "name": n, "seed": 10 + i})["ok"]
        before = svc.counters["dispatch_count"]
        reply = conn.call({"op": "ask_batch", "names": names, "timeout": 30})
        assert reply["ok"] and all(reply["results"][n]["ok"] for n in names), reply
        assert svc.counters["dispatch_count"] == before + 1
        for n in names:
            r = reply["results"][n]
            assert conn.call({"op": "tell", "study": n, "tid": r["tid"], "loss": 0.5})["ok"]
        missing = conn.call({"op": "ask_batch", "names": ["nope"], "timeout": 5})
        assert missing["results"]["nope"]["error_type"] == "UnknownStudy"
    finally:
        conn.close()
        sock.close()
        teardown(svc, srv)


def test_connection_cap_is_a_typed_refusal():
    svc = service()
    srv = spawn(svc, max_conns=1)
    addr = srv.server_address[:2]
    try:
        s1, f1 = dial(*addr, read_timeout=30)
        c1 = FrameConn(f1)  # holds the only slot
        assert c1.call({"op": "ping"})["pong"] is True
        s2, f2 = dial(*addr, read_timeout=30)
        with pytest.raises(Overloaded) as ei:
            FrameConn(f2)
        assert ei.value.reason == "max_connections" and ei.value.retry_after is not None
        f2.close()
        s2.close()
        c1.close()
        s1.close()
        # the slot frees once the handler ends: a retrying client gets in
        deadline = time.perf_counter() + 10
        while True:
            s3, f3 = dial(*addr, read_timeout=30)
            try:
                c3 = FrameConn(f3)
            except Overloaded:
                f3.close()
                s3.close()
                assert time.perf_counter() < deadline
                time.sleep(0.01)
                continue
            assert c3.call({"op": "ping"})["pong"] is True
            c3.close()
            s3.close()
            break
    finally:
        teardown(svc, srv)


def test_idle_timeout_reaps_a_half_open_client():
    svc = service()
    srv = spawn(svc, idle_timeout=0.3)
    try:
        with socket.create_connection(srv.server_address[:2], timeout=10) as sock:
            sock.settimeout(10.0)
            assert sock.recv(64) == b""  # the server hangs up on a silent peer
    finally:
        teardown(svc, srv)


def test_a_hung_peer_is_a_network_timeout_and_a_refused_connect_unreachable():
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    host, port = lsock.getsockname()
    try:
        sock, f = dial(host, port, read_timeout=0.2)
        f.write(b'{"op": "ping"}\n')
        f.flush()
        with pytest.raises(NetworkTimeout):
            f.readline()
        f.close()
        sock.close()
    finally:
        lsock.close()
    with pytest.raises(PeerUnreachable):
        dial(host, port, connect_timeout=0.5)
    with pytest.raises(PeerUnreachable, match=f"{host}:{port}"):
        RemoteStudy(host, port, "s", connect_timeout=0.5, max_retries=2)


# ---------------------------------------------------------------------------
# exactly once across a lost reply and a lost ack
# ---------------------------------------------------------------------------


def test_net_crash_points_registered():
    assert set(NET_CRASH_POINTS) == {"net_client_after_send_before_reply",
                                     "net_client_after_reply_before_deliver"}
    assert set(NET_CRASH_POINTS) <= set(ALL_CRASH_POINTS)
    assert NET_CRASH_POINTS == JN.NET_CRASH_POINTS
    with pytest.raises(ValueError):
        NetFaultPlan().arm("not_a_point")


def test_a_lost_reply_to_an_ask_resolves_exactly_once(tmp_path):
    svc = service(root=str(tmp_path / "ask"))
    srv = spawn(svc)
    host, port = srv.server_address[:2]
    plan = NetFaultPlan(seed=0)
    try:
        c1 = RemoteStudy(host, port, "s", seed=7, net_plan=plan)
        tid0, vals0 = c1.ask(timeout=30)
        c1.tell(tid0, loss_fn(vals0), vals0)
        plan.arm("net_client_after_reply_before_deliver", at=1)
        with pytest.raises(SimulatedCrash):
            c1.ask(timeout=30)  # served, never seen
        c2 = RemoteStudy(host, port, "s", create=False)
        reply = c2.call({"op": "ask", "study": "s", "timeout": 30, "recover": True})
        assert reply["tid"] == tid0 + 1  # the crashed ask's tid, served again
        c2.tell(reply["tid"], loss_fn(reply["vals"]), reply["vals"])
        st = svc.scheduler.study("s")
        assert st.persist.wal.total_tells == 2
        assert st.buf.tids[:2].tolist() == [tid0, tid0 + 1]
        c2.close()
    finally:
        teardown(svc, srv)


def test_a_lost_ack_of_a_tell_resolves_exactly_once(tmp_path):
    svc = service(root=str(tmp_path / "tell"))
    srv = spawn(svc)
    host, port = srv.server_address[:2]
    plan = NetFaultPlan(seed=1)
    try:
        c1 = RemoteStudy(host, port, "s", seed=7, net_plan=plan)
        tid, vals = c1.ask(timeout=30)
        plan.arm("net_client_after_send_before_reply", at=1)
        with pytest.raises(SimulatedCrash):
            c1.tell(tid, loss_fn(vals), vals)  # sent and applied, never acked
        st = svc.scheduler.study("s")
        deadline = time.perf_counter() + 10
        while st.persist.wal.total_tells < 1:
            assert time.perf_counter() < deadline
            time.sleep(0.005)
        c2 = RemoteStudy(host, port, "s", create=False)
        c2.tell(tid, loss_fn(vals), vals)  # the resubmission
        assert st.persist.wal.total_tells == 1 and int(st.buf.count) == 1
        c2.close()
    finally:
        teardown(svc, srv)


def test_a_resubmitted_ask_that_overtakes_its_original_is_one_tid():
    """A client that lost an ask's reply resends it (the same ``ask_id``)
    on a new connection, and the copy can reach the service first while
    the original waits in another handler thread.  Both copies are
    served as one tid: no seed is skipped, no suggestion is left untold.
    Without the key (the reference's protocol) the late original would
    draw the next tid."""
    svc = service()
    srv = spawn(svc)
    addr = srv.server_address[:2]
    try:
        c = RemoteStudy(*addr, "s", seed=5)
        copy = c.call({"op": "ask", "study": "s", "timeout": 30, "recover": True,
                       "ask_id": "k0"})
        late = c.call({"op": "ask", "study": "s", "timeout": 30, "ask_id": "k0"})
        assert (late["tid"], late["vals"]) == (copy["tid"], copy["vals"]) == (0, copy["vals"])
        st = svc.scheduler.study("s")
        assert st.next_tid == 1 and sorted(st.outstanding) == [0]
        c.tell(0, loss_fn(copy["vals"]), copy["vals"])
        assert c.ask(timeout=30)[0] == 1
        with pytest.raises(RuntimeError, match="told already"):
            c.call({"op": "ask", "study": "s", "timeout": 30, "ask_id": "k0"})
        c.close()
    finally:
        teardown(svc, srv)


def test_a_keyed_copy_of_a_queued_ask_is_served_from_its_seed():
    """The other order: the original is still queued when its copy
    arrives; the copy is queued again with the logged seed, and both are
    served the same vals under one tid."""
    svc = service(background=False)
    h = svc.create_study("s", seed=6)
    queued = []
    svc._await = lambda req, timeout: queued.append(req)  # keep both queued
    h.ask(timeout=30, ask_id="k")
    h.ask(timeout=30, recover=True, ask_id="k")
    first, copy = queued
    assert first.tid == copy.tid == 0 and first.seed == copy.seed
    assert svc.pump() == 1 and svc.pump() == 1  # one per study per round
    assert first.future.result(timeout=0) == copy.future.result(timeout=0)
    assert h._study.next_tid == 1
    svc.shutdown()


def storm_round_trip(net_plan=None, front_plan=None, seed=3, rounds=6):
    """The ask/tell loop through ``RemoteStudy``: the clean run and its
    storm twin share it, so any divergence is the storm's."""
    svc = service()
    srv = spawn(svc, net_plan=front_plan)
    host, port = srv.server_address[:2]
    try:
        c = RemoteStudy(host, port, "s", seed=seed, net_plan=net_plan, read_timeout=30.0)
        stream = []
        for _ in range(rounds):
            tid, vals = c.ask(timeout=30)
            c.tell(tid, loss_fn(vals), vals)
            stream.append((tid, json.dumps(vals, sort_keys=True)))
        stats = dict(c.stats)
        count = int(svc.scheduler.study("s").buf.count)
        c.close()
        return stream, count, stats
    finally:
        teardown(svc, srv)


@pytest.mark.parametrize("side,seed,rounds,plan_seed,reset,truncate", [
    ("client", 3, 6, 11, 0.15, 0.1), ("front", 5, 5, 12, 0.12, 0.08)])
def test_storm_twin_is_bitwise_the_clean_run(side, seed, rounds, plan_seed, reset, truncate):
    """Resets mid-frame, latency and truncate-then-close on the client's
    wire or on the server front's accepted connections: every op lands
    once and the stream is bitwise the clean run's."""
    clean, clean_count, clean_stats = storm_round_trip(seed=seed, rounds=rounds)
    assert clean_stats.get("transport_errors", 0) == 0
    plan = NetFaultPlan(seed=plan_seed, reset_rate=reset, latency=0.001, truncate_rate=truncate,
                        burst=2)
    kw = {"net_plan": plan} if side == "client" else {"front_plan": plan}
    stream, count, stats = storm_round_trip(seed=seed, rounds=rounds, **kw)
    assert stream == clean and count == clean_count == rounds
    assert plan.stats.get("net:reset", 0) + plan.stats.get("net:truncate", 0) > 0
    assert stats["transport_errors"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("side,plan_seed", [("client", 21), ("front", 22)])
def test_storm_twin_second_seed(side, plan_seed):
    """The storm twins at a second plan seed and more rounds."""
    clean, _, _ = storm_round_trip(seed=9, rounds=12)
    plan = NetFaultPlan(seed=plan_seed, reset_rate=0.15, latency=0.001, truncate_rate=0.1,
                        burst=2)
    kw = {"net_plan": plan} if side == "client" else {"front_plan": plan}
    stream, count, _ = storm_round_trip(seed=9, rounds=12, **kw)
    assert stream == clean and count == 12


@pytest.mark.slow
def test_thousand_client_soak_typed_errors_only():
    """1000 binary pipelining clients (``TORCH_SOAK_CLIENTS`` sizes it)
    against one served engine, 64 at a time: every reply is ok or a typed
    error (backpressure), never a raw failure or a hang -- the port's twin
    of the reference's soak."""
    svc = service(max_queue=4096, study_queue_cap=64)
    srv = spawn(svc)
    addr = srv.server_address[:2]
    names = [f"s{i}" for i in range(8)]
    for i, n in enumerate(names):
        svc.create_study(n, seed=i)
    failures, stats, lock = [], {"ok": 0, "typed": 0}, threading.Lock()

    def one_client(i):
        try:
            sock, f = dial(*addr, connect_timeout=60, read_timeout=60)
        except PeerUnreachable as e:
            failures.append(("connect", i, str(e)))
            return
        try:
            conn = FrameConn(f)
            name = names[i % len(names)]
            r = conn.call({"op": "ask", "study": name, "timeout": 45})
            if r.get("ok"):
                t = conn.call({"op": "tell", "study": name, "tid": r["tid"],
                               "loss": 0.1 + (i % 10) / 100.0})
                if not t.get("ok") and not t.get("error_type"):
                    failures.append(("tell", i, t))
                with lock:
                    stats["ok"] += 1
            elif r.get("error_type"):
                with lock:
                    stats["typed"] += 1
            else:
                failures.append(("ask", i, r))
            conn.close()
        except Exception as e:  # any raw client failure fails the soak
            failures.append(("client", i, f"{type(e).__name__}: {e}"))
        finally:
            sock.close()

    n_clients = int(os.environ.get("TORCH_SOAK_CLIENTS", "1000"))
    todo = iter(range(n_clients))

    def worker():
        while True:
            with lock:
                i = next(todo, None)
            if i is None:
                return
            one_client(i)

    workers = [threading.Thread(target=worker) for _ in range(64)]
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=900)
        assert not any(w.is_alive() for w in workers), "a soak client hung"
        assert not failures, failures[:10]
        assert stats["ok"] + stats["typed"] == n_clients and stats["ok"] > 0
    finally:
        teardown(svc, srv)


# ---------------------------------------------------------------------------
# the console script and the refusals
# ---------------------------------------------------------------------------


def test_load_space():
    sp = _load_space("hyperopt_tpu_torch.models.synthetic:mixed_space")
    assert t_compile(sp, device="cpu").n_dims == 20
    with pytest.raises(SystemExit):
        _load_space("no_colon_here")


def test_the_refusals_name_their_items(tmp_path):
    """The fleet's wire ops (item 12d) answer as the reference's: without
    an owner, ``takeover`` opens the study and ``handoff_study`` releases
    it (the console script's ``--owner`` runs in ``test_torch_fleet.py``);
    the console script's ``--mesh-devices 2``, once refused, serves two
    in-process study shards (the ``health`` op's ``mesh_shards``) and
    scrapes the shard-local rebuild counter; a count below -1, and -1 (a
    shard per card) on the CPU, are usage errors."""
    for bad in ("-5", "-1"):
        with pytest.raises(SystemExit) as exc:
            main(["--space", "hyperopt_tpu_torch.models.synthetic:mixed_space",
                  "--mesh-devices", bad, "--device", "cpu"])
        assert exc.value.code == 2
    svc = service(background=False)
    srv = spawn(svc)
    try:
        with socket.create_connection(srv.server_address[:2], timeout=30) as sock:
            rpc, f = json_rpc(sock)
            r = rpc(op="create_study", name="s", seed=1, takeover=True)
            assert r == {"ok": True, "study": "s", "n_tells": 0}
            assert rpc(op="create_study", name="s", seed=1)["ok"]
            assert rpc(op="handoff_study", study="s") == {"ok": True, "handed_off": "s"}
            assert rpc(op="studies")["studies"] == []
            assert rpc(op="handoff_study", study="s")["error_type"] == "UnknownStudy"
            assert rpc(op="ping")["pong"]  # the connection stays
            f.close()
    finally:
        teardown(svc, srv)
    proc = _script("--space", "hyperopt_tpu_torch.models.synthetic:mixed_space", "--port", "0",
                   "--n-startup-jobs", "2", "--mesh-devices", "2", "--device", "cpu")
    try:
        line = proc.stdout.readline()
        assert "listening on 127.0.0.1:" in line, (line, proc.stderr.read() if
                                                   proc.poll() is not None else "")
        port = int(line.split("127.0.0.1:")[1].split()[0])
        c = RemoteStudy("127.0.0.1", port, "m", seed=2, read_timeout=60)
        for _ in range(3):
            tid, vals = c.ask(timeout=60)
            c.tell(tid, mixed_space_fn(vals), vals)
        c.close()
        with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
            rpc, f = json_rpc(sock)
            counters = rpc(op="health")["counters"]
            assert (counters["mesh_shards"], counters["dispatch_count"]) == (2, 3)
            assert "serve_shard_restacks_total" in rpc(op="metrics")["text"]
            f.close()
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()


def _script(*args, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    return subprocess.Popen([sys.executable, "-m", "hyperopt_tpu_torch.serve.service", *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_the_console_script_serves_and_never_falls_back_to_the_cpu(tmp_path):
    """``python -m hyperopt_tpu_torch.serve.service --device cpu`` serves
    a study over its socket; without a card and without ``--device cpu``
    it exits non-zero with the device error."""
    proc = _script("--space", "hyperopt_tpu_torch.models.synthetic:mixed_space", "--port", "0",
                   "--root", str(tmp_path), "--n-startup-jobs", "2", "--device", "cpu")
    try:
        line = proc.stdout.readline()
        assert "listening on 127.0.0.1:" in line, (line, proc.stderr.read() if
                                                   proc.poll() is not None else "")
        port = int(line.split("127.0.0.1:")[1].split()[0])
        c = RemoteStudy("127.0.0.1", port, "s", seed=2, read_timeout=60)
        for _ in range(3):
            tid, vals = c.ask(timeout=60)
            c.tell(tid, mixed_space_fn(vals), vals)
        c.close()
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()
    if not __import__("torch").cuda.is_available():
        proc = _script("--space", "hyperopt_tpu_torch.models.synthetic:mixed_space", "--port",
                       "0")
        out, err = proc.communicate(timeout=120)
        assert proc.returncode != 0 and "device='cpu'" in err, (proc.returncode, err)
        assert "listening" not in out


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def j_service():
    return JService(space(jhp), max_batch=8, background=True, n_startup_jobs=N_STARTUP,
                    **ALGO_KW)


def drive_remote(client_cls, host, port, name, seed, rounds):
    c = client_cls(host, port, name, seed=seed, read_timeout=60)
    stream = []
    for _ in range(rounds):
        tid, vals = c.ask(timeout=60)
        c.tell(tid, loss_fn(vals), vals)
        stream.append((tid, vals))
    c.close()
    return stream


@pytest.mark.parametrize("pair", ["port_client_reference_server", "reference_client_port_server"])
def test_clients_and_servers_of_the_two_packages_interoperate(pair):
    """Each package's ``RemoteStudy`` on binary frames against the other's
    server: the startup asks are the same in both directions, and every
    tell is logged on the server once."""
    rounds = N_STARTUP + 2
    if pair == "port_client_reference_server":
        svc, client_cls = j_service(), RemoteStudy
        srv = j_serve_forever(svc, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    else:
        svc, client_cls = service(), JRemoteStudy
        srv = spawn(svc)
    try:
        stream = drive_remote(client_cls, *srv.server_address[:2], "s", 4, rounds)
        assert [tid for tid, _ in stream] == list(range(rounds))
        assert int(svc.scheduler.study("s").buf.count) == rounds
        # the startup asks are the prior's: the same draws from either server
        own = service(background=False)
        try:
            h = own.create_study("s", seed=4)
            for tid, vals in stream[:N_STARTUP]:
                assert h.ask(timeout=30) == (tid, vals)
                h.tell(tid, loss_fn(vals))
        finally:
            own.shutdown()
    finally:
        teardown(svc, srv)


def script_replies(host, port, rounds):
    """The request script on JSON lines: two studies, ``rounds`` rounds of
    one ``ask_batch`` then two tells; returns each reply's raw bytes."""
    raw = []
    with socket.create_connection((host, port), timeout=60) as sock:
        f = sock.makefile("rwb")

        def send(**req):
            f.write((json.dumps(req) + "\n").encode())
            f.flush()
            line = f.readline()
            raw.append(line)
            return json.loads(line)

        send(op="ping")
        send(op="create_study", name="s0", seed=3)
        send(op="create_study", name="s1", seed=4)
        for _ in range(rounds):
            reply = send(op="ask_batch", names=["s0", "s1"], timeout=60)
            for name in ("s0", "s1"):
                r = reply["results"][name]
                send(op="tell", study=name, tid=r["tid"], loss=loss_fn(r["vals"]))
        send(op="best", study="s0")
        f.close()
    return raw


def test_the_two_servers_reply_the_same_bytes_up_to_a_near_tie():
    rounds = N_STARTUP + 4
    replies = {}
    for pkg, (svc, serve) in {"ref": (j_service(), j_serve_forever),
                              "port": (service(background=False), serve_forever)}.items():
        srv = serve(svc, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            replies[pkg] = script_replies(*srv.server_address[:2], rounds)
        finally:
            teardown(svc, srv)
    ref, mine = replies["ref"], replies["port"]
    assert len(ref) == len(mine) == 3 + 3 * rounds + 1
    startup = 3 + 3 * N_STARTUP
    assert mine[:startup] == ref[:startup]  # byte for byte
    jps, tps = j_compile(space(jhp)), t_compile(space(hp), device="cpu")
    told = {"s0": [], "s1": []}
    rngs = {"s0": np.random.default_rng(3), "s1": np.random.default_rng(4)}
    for k in range(rounds):
        jr, tr = (json.loads(x[3 + 3 * k]) for x in (ref, mine))
        for name in ("s0", "s1"):
            seed = int(rngs[name].integers(2**31 - 1))
            jvals, tvals = jr["results"][name]["vals"], tr["results"][name]["vals"]
            if k >= N_STARTUP and jvals != tvals:
                jv = np.array([jvals[l] for l in jps.labels], np.float32)
                tv = np.array([tvals[l] for l in jps.labels], np.float32)
                differ = picks_differ(tps, jv, tv)
                if differ.any():
                    buf = JObsBuffer(jps)
                    for vals in told[name]:
                        buf.add(dict(vals), loss_fn(vals))
                    arrays = tuple(a[..., : buf._device_bucket(None)] for a in buf.arrays())
                    margins = ref_margins(jps, arrays, host_key(seed % (2**31 - 1)))
                    assert np.all(margins[differ] < NEAR_TIE), (name, k, margins, differ)
                    return  # past the first divergence the histories part
            assert jr["results"][name]["tid"] == tr["results"][name]["tid"] == k
            told[name].append(jvals)


def _wire_script(mod, plan):
    """One scripted sequence of reads and writes over three connections
    (two keys, a reconnect): what each op raised, then the plan's log."""
    raised = []
    for key, n_ops in (("client/a", 12), ("serve-front", 9), ("client/a", 7)):
        sink = io.BytesIO(b"x" * 4096)
        wire = plan.wrap(sink, key=key)
        for i in range(n_ops):
            try:
                if i % 3 == 2:
                    wire.read(16)
                else:
                    wire.write(b"frame-%02d" % i * 5)
                    wire.flush()
                raised.append(None)
            except (ConnectionResetError, BrokenPipeError, ValueError, socket.timeout) as e:
                raised.append(type(e).__name__)
        if key == "serve-front":
            plan.partition(key)
            try:
                plan.wrap(io.BytesIO(b"y"), key=key).read(1)
            except socket.timeout:
                raised.append("timeout")
            plan.heal(key)
    return raised, list(plan.log), dict(plan.stats)


def test_net_fault_plan_makes_the_reference_decisions():
    kw = dict(seed=17, reset_rate=0.2, latency=0.001, truncate_rate=0.15, burst=2)
    mine = _wire_script(None, NetFaultPlan(**kw))
    ref = _wire_script(JN, JN.NetFaultPlan(**kw))
    assert mine == ref
    assert sum(x is not None for x in mine[0]) > 3  # the script did inject
    assert NetFaultPlan(**kw).split("w1").seed == JN.NetFaultPlan(**kw).split("w1").seed
