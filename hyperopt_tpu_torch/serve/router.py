"""The fleet's routing front in the PyTorch port: the consistent-hash ring
and the routers that place each study on its replica.

The counterpart of :mod:`hyperopt_tpu.serve.router`.  Two routers share
one :class:`HashRing`:

* :class:`FleetRouter`, the in-process front over a
  :class:`~hyperopt_tpu_torch.serve.fleet.Fleet`: it routes
  ``create/ask/tell/best/close`` by study name, turns a replica death it
  observes (:class:`~hyperopt_tpu_torch.exceptions.ReplicaDead`, or a
  :class:`~hyperopt_tpu_torch.distributed.faults.SimulatedCrash` out of a
  replica's round) into failover and retries the op on the new owner with
  ``recover=True`` (exactly-once delivery), and passes typed
  :class:`~hyperopt_tpu_torch.exceptions.Overloaded` backpressure to the
  client untouched;
* :class:`RouterServer` and :func:`main` (the
  ``hyperopt-tpu-torch-router`` console script), the same policy over
  TCP: clients speak the JSON-line or binary-frame protocol to the
  router, which forwards each request to the backend that owns the
  study.  Backends are ``hyperopt-tpu-torch-serve`` processes on one
  ``--root``, fenced by their ``--owner`` claims; when one stops
  answering, its studies go to ring survivors, which restore them from
  the root through ``create_study(takeover=True)``.

The wire is the reference's, so either package's router fronts either
package's backends.  Placement is a function of (guard, study name, live
replicas): the ring hashes with blake2b, never ``hash()``, and places a
study where the reference's ring places it.  The router runs nothing on
a device.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import logging
import socket
import threading
import time

from ..distributed.faults import REAL_FS, SimulatedCrash
from ..exceptions import NetworkTimeout, OwnershipLost, PeerUnreachable, ReplicaDead
from ..obs.expo import merge_rows, render_prometheus, tag_rows
from ..obs.registry import LATENCY_BUCKETS_S, MetricsRegistry
from .frames import DEFAULT_READ_TIMEOUT, FrameConn, FrameError, dial

logger = logging.getLogger(__name__)

__all__ = ["FleetRouter", "HashRing", "RouterServer", "main"]

#: everything a forward can die of in the transport: socket failures, torn
#: frames, garbled JSON-line replies, and the typed deadline and
#: reachability errors (ServeErrors, not OSErrors, so named here)
_NET_ERRORS = (OSError, ConnectionError, FrameError, json.JSONDecodeError, NetworkTimeout,
               PeerUnreachable)


def _h64(s):
    """A stable 64-bit point on the ring (the same in every process)."""
    return int.from_bytes(hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest(), "big")


class HashRing:
    """Consistent hashing of study names over replica ids.

    ``salt`` is the study family's guard: fleets over different spaces
    place the same names differently, and one fleet's placement is the
    same wherever the guard is.  ``vnodes`` virtual points per replica
    keep the load within a small factor of even; adding or removing a
    replica moves only the keys whose arcs it owned, about 1/N of them,
    and no key whose owner survives.
    """

    def __init__(self, nodes=(), salt="", vnodes=64):
        self.salt = str(salt)
        self.vnodes = int(vnodes)
        self._points = []  # sorted [(hash, node), ...]
        self.nodes = set()
        for node in nodes:
            self.add(node)

    def add(self, node):
        node = str(node)
        if node in self.nodes:
            return
        self.nodes.add(node)
        for v in range(self.vnodes):
            bisect.insort(self._points, (_h64(f"{self.salt}|node|{node}|{v}"), node))

    def remove(self, node):
        node = str(node)
        if node not in self.nodes:
            return
        self.nodes.discard(node)
        self._points = [p for p in self._points if p[1] != node]

    def owner(self, key, exclude=()):
        """The replica owning ``key``: the first ring point at or after
        the key's hash (wrapping), skipping ``exclude``."""
        alive = self.nodes - set(exclude)
        if not alive:
            raise ReplicaDead(f"no live replica on the ring for key {key!r}")
        h = _h64(f"{self.salt}|key|{key}")
        i = bisect.bisect_left(self._points, (h, ""))
        n = len(self._points)
        for step in range(n):
            node = self._points[(i + step) % n][1]
            if node in alive:
                return node
        raise ReplicaDead(f"ring exhausted for key {key!r}")  # unreachable

    def placement(self, keys, exclude=()):
        """``{key: owner}`` for a batch of keys."""
        return {k: self.owner(k, exclude=exclude) for k in keys}


class FleetRouter:
    """The in-process routing front over a Fleet.

    One instance is one router process: its ``fs`` seam carries the
    router's crash point (``fleet_router_after_forward_before_ack``: the
    replica ran the op, the client never saw the ack); a crashed router is
    restarted by building a new one over the same fleet, and the client
    retries idempotently (tells dedup by tid, asks are served again with
    ``recover=True``).

    Failure policy: an op that finds its replica dead, or watches it die
    (a ``SimulatedCrash`` out of the replica's round), fails the replica
    over and retries ONCE on the new owner, asks with ``recover=True`` so
    a suggestion the dead replica logged or served is delivered again
    bitwise instead of drawing a new seed.  Typed ``Overloaded``
    (draining, a full queue, an open circuit) goes to the client: the
    backpressure is the client's signal.
    """

    def __init__(self, fleet, fs=REAL_FS):
        self.fleet = fleet
        self.fs = fs

    def _forward(self, name, op, recover_op=None):
        """``op(replica)`` on the study's owner; on the replica's death,
        before the call or during it, fail it over and retry once on the
        new owner (``recover_op`` when given)."""
        rid = self.fleet.route(name)
        replica = self.fleet.replicas[rid]
        try:
            if replica.dead or replica.partitioned:
                raise ReplicaDead(f"replica {rid!r} is unreachable")
            return op(replica)
        except (ReplicaDead, SimulatedCrash):
            self.fleet.mark_dead(rid)
            self.fleet.failover(rid)
            return (recover_op or op)(self.fleet.replicas[self.fleet.route(name)])
        except OwnershipLost:
            # a healed rejoiner: the ring routed the study back, but the
            # replica's resident handle holds its old claim.  Re-claim from
            # the shared root (takeover bumps the epoch; the restore replays
            # exactly once) and retry: the client sees nothing
            replica = self.fleet.replicas[self.fleet.route(name)]
            replica.open_study(name, takeover=True)
            return (recover_op or op)(replica)

    def _ack(self):
        self.fs.crashpoint("fleet_router_after_forward_before_ack")

    # -- the client API ----------------------------------------------------
    def create_study(self, name, seed=0):
        self.fleet.register(name)
        out = self._forward(name, lambda r: r.open_study(name, seed=seed).name)
        self._ack()
        return out

    def ask(self, name, timeout=60.0, recover=False):
        out = self._forward(name, lambda r: r.ask(name, timeout=timeout, recover=recover),
                            recover_op=lambda r: r.ask(name, timeout=timeout, recover=True))
        self._ack()
        return out

    def tell(self, name, tid, loss, vals=None):
        self._forward(name, lambda r: r.tell(name, tid, loss, vals=vals))
        self._ack()

    def best(self, name):
        out = self._forward(name, lambda r: r.best(name))
        self._ack()
        return out

    def close_study(self, name):
        self._forward(name, lambda r: r.close_study(name))
        self.fleet.unregister(name)
        self._ack()

    def ask_batch(self, names, timeout=60.0):
        """The fleet's throughput path: group the asks by owner, submit each
        group (ONE coalesced round per replica), then gather.  Returns
        ``{name: (tid, vals)}``; a name whose replica died mid-round is
        retried through the failover path with ``recover=True``."""
        by_replica = {}
        for name in names:
            by_replica.setdefault(self.fleet.route(name), []).append(name)
        out, retry = {}, []
        for rid, group in by_replica.items():
            replica = self.fleet.replicas[rid]
            if replica.dead or replica.partitioned:
                retry.extend(group)
                continue
            try:
                futs = [(n, replica.ask_async(n)) for n in group]
                replica.pump_until([f for _, f in futs], timeout=timeout)
                for n, f in futs:
                    out[n] = f.result(timeout=0)
            except (ReplicaDead, SimulatedCrash, OwnershipLost):
                self.fleet.mark_dead(rid)
                self.fleet.failover(rid)
                retry.extend(n for n in group if n not in out)
        for n in retry:
            out[n] = self.ask(n, timeout=timeout, recover=True)
        self._ack()
        return out


# ---------------------------------------------------------------------------
# the TCP router: the same policy over the wire
# ---------------------------------------------------------------------------


class _Backend:
    """One replica's address.  Connections are opened per handler thread
    and kept by the caller."""

    def __init__(self, rid, host, port):
        self.rid = rid
        self.host = host
        self.port = int(port)

    def connect(self, timeout=10.0, read_timeout=DEFAULT_READ_TIMEOUT, net_plan=None):
        """A deadline-armed transport to the replica
        (:func:`~.frames.dial`): a failed connect is :class:`PeerUnreachable`,
        a hung read :class:`NetworkTimeout`, never a stranded thread."""
        _sock, f = dial(self.host, self.port, connect_timeout=timeout,
                        read_timeout=read_timeout, net_plan=net_plan, key=self.rid)
        return f


class RouterServer:
    """The TCP routing front: requests in, forwarded to the owning backend,
    replies out.

    Every client connection has its own handler thread with its OWN backend
    connections (no shared sockets, no lock around I/O); the only shared
    mutable state is the dead-backend set, changed under a small lock with
    nothing blocking inside.  A backend that fails a forward is marked
    dead, the ring excludes it, and the request goes to the new owner,
    first ``create_study(takeover=True)`` when the study is not resident
    there (the shared root restores it), then the op, an ask with
    ``recover`` set.  Probes run with exponential backoff
    (:meth:`probe_backends`); ``read_timeout`` bounds every backend read,
    and the client front reaps idle connections at ``idle_timeout`` and
    serves at most ``max_conns`` at once.
    """

    def __init__(self, backends, salt="", vnodes=64, probe_timeout=5.0, probe_backoff_cap=8,
                 read_timeout=DEFAULT_READ_TIMEOUT, net_plan=None, idle_timeout=300.0,
                 max_conns=256):
        self.backends = {b.rid: b for b in backends}
        self.read_timeout = float(read_timeout)
        self.net_plan = net_plan
        self.idle_timeout = idle_timeout
        self.max_conns = int(max_conns)
        self.ring = HashRing(self.backends, salt=salt, vnodes=vnodes)
        self._lock = threading.Lock()
        self._dead = set()
        # the router's own series, merged into the fleet-wide scrape
        self.metrics = MetricsRegistry("router")
        self._up_gauge = self.metrics.gauge(
            "router_backend_up", "1 = the last health probe (or forward) succeeded",
            labels=("backend",))
        self._probe_hist = self.metrics.histogram(
            "router_probe_seconds", "health-probe round-trip time", buckets=LATENCY_BUCKETS_S)
        self._probe_failures = self.metrics.counter(
            "router_probe_failures_total", "failed health probes")
        self._rejoins = self.metrics.counter(
            "router_backend_rejoins_total", "dead backends revived by a succeeding probe")
        self._probes_total = self.metrics.counter(
            "router_probes_total", "health probes attempted (skips under backoff excluded)")
        self.probe_timeout = float(probe_timeout)
        # after the f-th failure in a row the next min(2**(f-1), cap) sweeps
        # skip the backend: probed on sweeps 0, 2, 5, 10, 19, 28, ...; any
        # success resets it
        self.probe_backoff_cap = int(probe_backoff_cap)
        self._probe_fails = {}  # rid -> consecutive probe failures
        self._probe_wait = {}  # rid -> sweeps left before the next try
        self._probe_conns = {}  # the probe loop's own connections
        self._probe_thread = None
        self._probing = False

    def _mark_dead(self, rid):
        with self._lock:
            self._dead.add(rid)
        self._up_gauge.labels(backend=rid).set(0)

    def _alive_excluded(self):
        with self._lock:
            return frozenset(self._dead)

    def _conn(self, conns, rid, timeout=30.0):
        """This thread's negotiated :class:`FrameConn` to ``rid``, opened
        and hello'd at first use (binary frames, or JSON lines against a
        backend that does not speak them)."""
        c = conns.get(rid)
        if c is None:
            c = conns[rid] = FrameConn(self.backends[rid].connect(
                timeout=timeout, read_timeout=min(self.read_timeout, float(timeout)),
                net_plan=self.net_plan))
        return c

    def _drop_conn(self, conns, rid):
        c = conns.pop(rid, None)
        if c is not None:
            c.close()

    def _rpc(self, conns, rid, req, timeout=30.0):
        return self._conn(conns, rid, timeout=timeout).call(req)

    def handle_request(self, req, conns):
        """Route one request; ``conns`` is the calling thread's backend
        connections (``{rid: FrameConn}``).  The fleet-level ops (health,
        ready, studies, metrics, trace, ask_batch, drain) span the live
        backends."""
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "pong": True, "router": True}
        if op in ("health", "ready", "studies"):
            return self._aggregate(op, conns)
        if op == "metrics":
            return self._aggregate_metrics(conns)
        if op == "trace":
            return self._aggregate_trace(conns, req.get("tail"))
        if op == "ask_batch":
            return self._ask_batch(req, conns)
        if op == "drain":
            return self._drain_all(req, conns)
        name = req.get("name") or req.get("study")
        if not name:
            return {"ok": False, "error": f"op {op!r} needs a study name"}
        last_exc = None
        draining_reply = None
        for _attempt in range(1 + len(self.backends)):
            try:
                rid = self.ring.owner(name, exclude=self._alive_excluded())
            except ReplicaDead as e:
                return {"ok": False, "error": str(e), "error_type": "ReplicaDead"}
            try:
                reply = self._rpc(conns, rid, req)
                if (not reply.get("ok")
                        and reply.get("error_type") in ("UnknownStudy", "OwnershipLost")
                        and op != "create_study"):
                    # adoption: the ring's owner has not loaded the study
                    # (UnknownStudy), or is a rejoiner holding a stale claim
                    # (OwnershipLost): restore or re-claim it from the root,
                    # then retry on the same backend
                    adopt = self._rpc(conns, rid, {"op": "create_study", "name": name,
                                                   "takeover": True})
                    if adopt.get("ok"):
                        if op == "ask":
                            req = dict(req, recover=True)
                        reply = self._rpc(conns, rid, req)
                if (not reply.get("ok") and reply.get("error_type") == "Overloaded"
                        and reply.get("reason") == "draining"
                        and reply.get("retry_after") is not None):
                    # a draining backend names its comeback time: honour it,
                    # capped, within this loop's attempts (a backend that
                    # drains forever ends in the typed refusal, not a hang)
                    from .service import RETRY_AFTER_CAP

                    draining_reply = reply
                    time.sleep(min(float(reply["retry_after"]), RETRY_AFTER_CAP))
                    continue
                return reply
            except _NET_ERRORS as e:
                last_exc = e
                self._drop_conn(conns, rid)
                self._mark_dead(rid)
                logger.warning("router: backend %s unreachable (%s); failing over", rid, e)
                if op == "ask":
                    req = dict(req, recover=True)
                continue
        if draining_reply is not None:
            # still draining past the retry budget: the typed backpressure
            # goes to the client, whose backoff owns the longer wait
            return draining_reply
        return {"ok": False, "error_type": "ReplicaDead",
                "error": f"no backend could serve {name!r}: {last_exc}"}

    def _ask_batch(self, req, conns):
        """The coalesced fleet ask over TCP: group the names by ring owner,
        SUBMIT one ``ask_batch`` frame per backend (all in flight at once),
        then drain.  A name whose backend died, has not loaded it, or
        predates ``ask_batch`` goes through :meth:`handle_request` with its
        whole failover policy."""
        names = [str(n) for n in (req.get("names") or ())]
        timeout = float(req.get("timeout") or 60.0)
        results, retry, flights = {}, [], []
        by_rid = {}
        for name in names:
            try:
                rid = self.ring.owner(name, exclude=self._alive_excluded())
            except ReplicaDead as e:
                results[name] = {"ok": False, "error": str(e), "error_type": "ReplicaDead"}
                continue
            by_rid.setdefault(rid, []).append(name)
        for rid, group in by_rid.items():
            try:
                c = self._conn(conns, rid)
                flights.append((rid, group, c, c.submit(
                    {"op": "ask_batch", "names": group, "timeout": timeout})))
            except _NET_ERRORS:
                self._drop_conn(conns, rid)
                self._mark_dead(rid)
                retry.extend(group)
        for rid, group, c, fut in flights:
            try:
                reply = c.drain(fut)
            except _NET_ERRORS:
                self._drop_conn(conns, rid)
                self._mark_dead(rid)
                retry.extend(group)
                continue
            if not reply.get("ok"):
                retry.extend(group)  # a backend without ask_batch
                continue
            sub = reply.get("results") or {}
            for name in group:
                r = sub.get(name)
                if r is None or (not r.get("ok")
                                 and r.get("error_type") in ("UnknownStudy", "OwnershipLost")):
                    retry.append(name)  # adoption through the per-name path
                else:
                    results[name] = r
        for name in retry:
            results[name] = self.handle_request({"op": "ask", "study": name,
                                                 "timeout": timeout}, conns)
        return {"ok": True, "results": results}

    def _drain_all(self, req, conns):
        """Forward ``drain`` to every live backend, so the whole fleet stops
        admitting asks at once; the reply's ``retry_after`` is the slowest
        backend's hint, capped."""
        from .service import RETRY_AFTER_CAP

        fwd = {"op": "drain"}
        if req.get("timeout") is not None:
            fwd["timeout"] = req["timeout"]
        replicas, hints = {}, []
        for rid in sorted(self.backends):
            if rid in self._alive_excluded():
                continue
            try:
                reply = self._rpc(conns, rid, fwd)
            except _NET_ERRORS:
                self._drop_conn(conns, rid)
                self._mark_dead(rid)
                replicas[rid] = False
                continue
            replicas[rid] = bool(reply.get("draining"))
            if reply.get("retry_after") is not None:
                hints.append(float(reply["retry_after"]))
        return {"ok": True, "draining": True, "replicas": replicas,
                "retry_after": min(max(hints, default=0.0), RETRY_AFTER_CAP)}

    def _aggregate(self, op, conns):
        replies = {}
        for rid in self.backends:
            if rid in self._alive_excluded():
                continue
            try:
                replies[rid] = self._rpc(conns, rid, {"op": op})
            except _NET_ERRORS as e:
                self._drop_conn(conns, rid)
                replies[rid] = {"ok": False, "error": str(e)}
        if op == "ready":
            return {"ok": True, "ready": any(r.get("ready") for r in replies.values()),
                    "replicas": {rid: bool(r.get("ready")) for rid, r in replies.items()}}
        if op == "studies":
            return {"ok": True,
                    "studies": sorted({s for r in replies.values() for s in r.get("studies", [])})}
        return {"ok": True, "replicas": replies}

    def _aggregate_metrics(self, conns):
        """The fleet-wide scrape: every live replica's rows, tagged with its
        id, and the router's own, as one Prometheus text document."""
        row_lists = [tag_rows(self.metrics.collect(), component="router")]
        scraped = []
        for rid in sorted(self.backends):
            if rid in self._alive_excluded():
                continue
            try:
                reply = self._rpc(conns, rid, {"op": "metrics"})
            except _NET_ERRORS:
                self._drop_conn(conns, rid)
                continue
            if reply.get("ok"):
                row_lists.append(tag_rows(reply.get("metrics", []), replica=rid))
                scraped.append(rid)
        rows = merge_rows(*row_lists)
        return {"ok": True, "metrics": rows, "text": render_prometheus(rows), "replicas": scraped}

    def _aggregate_trace(self, conns, tail=None):
        """Every live replica's recent spans (each stamped with its replica
        id), in time order."""
        spans = []
        for rid in sorted(self.backends):
            if rid in self._alive_excluded():
                continue
            try:
                reply = self._rpc(conns, rid, {"op": "trace", "tail": tail})
            except _NET_ERRORS:
                self._drop_conn(conns, rid)
                continue
            if reply.get("ok"):
                for s in reply.get("spans", []):
                    s.setdefault("replica", rid)
                    spans.append(s)
        spans.sort(key=lambda s: s.get("ts", 0))
        if tail is not None:
            spans = spans[-int(tail):]
        return {"ok": True, "spans": spans}

    # -- health probes -------------------------------------------------------
    def probe_backends(self):
        """One probe sweep over every backend, on the probe loop's own
        connections: a failing backend is marked dead before a client's
        ask finds out, and a dead one whose probe succeeds rejoins the ring
        (its studies come back request by request through adoption).  A
        backend down for long backs off exponentially: after the f-th
        failure in a row the next ``min(2**(f-1), probe_backoff_cap)``
        sweeps skip it, and a success resets the schedule."""
        for rid in sorted(self.backends):
            wait = self._probe_wait.get(rid, 0)
            if wait > 0:
                self._probe_wait[rid] = wait - 1
                continue
            self._probes_total.inc()
            t0 = time.perf_counter()
            try:
                reply = self._rpc(self._probe_conns, rid, {"op": "health"},
                                  timeout=self.probe_timeout)
                ok = bool(reply.get("ok"))
            except _NET_ERRORS:
                self._drop_conn(self._probe_conns, rid)
                ok = False
            self._probe_hist.observe_since(t0)
            if ok:
                self._probe_fails.pop(rid, None)
                self._probe_wait.pop(rid, None)
                with self._lock:
                    rejoined = rid in self._dead
                    self._dead.discard(rid)
                if rejoined:
                    self._rejoins.inc()
                    logger.info("router: backend %s probe-recovered; rejoining the ring", rid)
                self._up_gauge.labels(backend=rid).set(1)
            else:
                fails = self._probe_fails.get(rid, 0) + 1
                self._probe_fails[rid] = fails
                self._probe_wait[rid] = min(2 ** (fails - 1), self.probe_backoff_cap)
                self._probe_failures.inc()
                already = rid in self._alive_excluded()
                self._mark_dead(rid)
                if not already:
                    logger.warning("router: backend %s failed its health probe; marked suspect "
                                   "before any client ask hit it", rid)

    def start_probes(self, interval=1.0):
        """Run :meth:`probe_backends` on a background thread every
        ``interval`` seconds (tests call it directly)."""
        if self._probe_thread is not None:
            return
        self._probing = True
        interval = float(interval)

        def _probe_loop():
            while self._probing:
                self.probe_backends()
                time.sleep(interval)

        self._probe_thread = threading.Thread(target=_probe_loop, name="router-probe",
                                              daemon=True)
        self._probe_thread.start()

    def stop_probes(self):
        self._probing = False
        t = self._probe_thread
        self._probe_thread = None
        if t is not None:
            t.join(timeout=5.0)
        for f in self._probe_conns.values():
            try:
                f.close()
            except OSError:
                pass
        self._probe_conns.clear()

    def serve_forever(self, host="127.0.0.1", port=0):
        """Bind the client front; returns the (not yet serving)
        ``ThreadingTCPServer``, as :func:`~.service.serve_forever` does,
        with the same ``hello`` negotiation, so a binary client gets frames
        end to end.  Every accepted connection carries ``idle_timeout`` as
        its read deadline, and at most ``max_conns`` are served at once:
        one past the cap gets a typed ``Overloaded`` refusal (``reason:
        "max_connections"``) and a close."""
        import socketserver

        from .frames import PROTO_V2, read_frame, write_frame
        from .service import RETRY_AFTER_CAP

        router = self
        idle = self.idle_timeout
        plan = self.net_plan
        slots = threading.BoundedSemaphore(self.max_conns)

        class Handler(socketserver.StreamRequestHandler):
            timeout = idle  # StreamRequestHandler sets it on the socket

            def setup(self):
                super().setup()
                if plan is not None:
                    self.rfile, self.wfile = plan.wrap_pair(self.rfile, self.wfile,
                                                            sock=self.connection,
                                                            key="router-front")

            def _send(self, reply, binary):
                if binary:
                    write_frame(self.wfile, reply)
                else:
                    self.wfile.write((json.dumps(reply) + "\n").encode("utf-8"))
                self.wfile.flush()

            def handle(self):
                if not slots.acquire(blocking=False):
                    try:
                        self._send({"ok": False, "error": "router connection cap reached",
                                    "error_type": "Overloaded", "reason": "max_connections",
                                    "retry_after": min(0.05, RETRY_AFTER_CAP)}, False)
                    except OSError:
                        pass
                    return
                try:
                    self._handle_conn()
                except ConnectionError:
                    return  # the peer reset or vanished mid-request
                finally:
                    slots.release()

            def _refuse(self, error, binary):
                self._send({"ok": False, "error": error, "error_type": "FrameError"}, binary)

            def _handle_conn(self):
                conns = {}  # this thread's backend connections
                binary = False
                try:
                    while True:
                        if binary:
                            try:
                                req = read_frame(self.rfile)
                            except FrameError as e:
                                self._refuse(str(e), binary)
                                return
                            if req is None:
                                return
                            if not isinstance(req, dict):
                                self._refuse("frame payload must be a map", binary)
                                return
                        else:
                            raw = self.rfile.readline()
                            if not raw:
                                return
                            line = raw.strip()
                            if not line:
                                continue
                            try:
                                req = json.loads(line)
                            except ValueError as e:
                                self._refuse(f"malformed request line: {e}", binary)
                                continue
                            if not isinstance(req, dict):
                                self._refuse("request must be a JSON object", binary)
                                continue
                        if req.get("op") == "hello":
                            proto = min(int(req.get("proto", 1)), PROTO_V2)
                            reply = {"ok": True, "proto": proto}
                            if "rid" in req:
                                reply["rid"] = req["rid"]
                            self._send(reply, binary)
                            binary = proto >= PROTO_V2
                            continue
                        try:
                            reply = router.handle_request(req, conns)
                        except Exception as e:
                            # one bad request does not end the connection
                            logger.debug("routed request %r failed", req.get("op"),
                                         exc_info=True)
                            reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                        if "rid" in req:
                            reply = dict(reply, rid=req["rid"])
                        self._send(reply, binary)
                except socket.timeout:
                    return  # the idle deadline: a silent or half-open client is reaped
                finally:
                    for c in conns.values():
                        c.close()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        return Server((host, int(port)), Handler)


def main(argv=None):
    """``hyperopt-tpu-torch-router``: the fleet's routing front as a process.

    Two replicas on the card sharing a study root::

        hyperopt-tpu-torch-serve --space my.mod:space --root /shared/studies \\
            --owner r0 --port 7070 &
        hyperopt-tpu-torch-serve --space my.mod:space --root /shared/studies \\
            --owner r1 --port 7071 &
        hyperopt-tpu-torch-router --salt my-space \\
            --backend r0=127.0.0.1:7070 --backend r1=127.0.0.1:7071

    Placement depends only on ``--salt``: a router of either package given
    the same salt (for instance the fleet's ``fleet_salt``) places every
    study on the same replica.
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="hyperopt-tpu-torch-router",
        description="consistent-hash router of a hyperopt-tpu-torch serve fleet: speaks the "
        "JSON-line and binary-frame protocol, routes by study name, fails studies over to "
        "ring survivors (which restore them from the shared --root) when a replica dies",
    )
    parser.add_argument("--backend", action="append", required=True, metavar="ID=HOST:PORT",
                        help="one replica endpoint (repeatable)")
    parser.add_argument("--salt", default="",
                        help="ring salt -- use the fleet's space/guard fingerprint so placement "
                        "matches any other router over the same fleet")
    parser.add_argument("--vnodes", type=int, default=64)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7076)
    parser.add_argument("--probe-interval", type=float, default=1.0,
                        help="seconds between background health-probe sweeps (a backend down "
                        "for long backs off exponentially, see --probe-backoff-cap); 0 "
                        "disables probing")
    parser.add_argument("--read-timeout", type=float, default=DEFAULT_READ_TIMEOUT,
                        help="per-op read deadline on every backend connection: a hung "
                        "backend surfaces as NetworkTimeout and takes the failover path")
    parser.add_argument("--idle-timeout", type=float, default=300.0,
                        help="per-connection idle deadline on the client front")
    parser.add_argument("--max-conns", type=int, default=256,
                        help="bound on concurrently served client connections; one past the "
                        "cap gets a typed Overloaded refusal (reason max_connections)")
    parser.add_argument("--probe-backoff-cap", type=int, default=8,
                        help="most sweeps skipped between probes of a backend that stays down")
    args = parser.parse_args(argv)

    backends = []
    for spec in args.backend:
        rid, _, addr = spec.partition("=")
        host, _, port = addr.rpartition(":")
        if not (rid and host and port):
            raise SystemExit(f"--backend must be ID=HOST:PORT, got {spec!r}")
        backends.append(_Backend(rid, host, int(port)))
    router = RouterServer(backends, salt=args.salt, vnodes=args.vnodes,
                          probe_backoff_cap=args.probe_backoff_cap,
                          read_timeout=args.read_timeout, idle_timeout=args.idle_timeout,
                          max_conns=args.max_conns)
    server = router.serve_forever(host=args.host, port=args.port)
    if args.probe_interval > 0:
        router.start_probes(interval=args.probe_interval)
    host, port = server.server_address[:2]
    print(f"hyperopt-tpu-torch-router listening on {host}:{port} ({len(backends)} backend(s))",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        router.stop_probes()
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
