"""The horizontal serve fleet of the PyTorch port: replicas over one study
root, claim/epoch ownership, migration and failover.

The counterpart of :mod:`hyperopt_tpu.serve.fleet`:

* a study is a portable WAL and snapshot pair in a SHARED root
  (:class:`~hyperopt_tpu_torch.serve.service.StudyPersistence`), so
  migrating it is a snapshot and a claim handoff: nothing is copied, the
  new owner restores in place and replays the log exactly once (dedup by
  tid);
* each replica is an ordinary :class:`~hyperopt_tpu_torch.serve.service.
  SuggestService` with a fleet identity (``owner=``), on the card unless
  ``device="cpu"`` is passed through ``service_kw``; a per-study
  :class:`StudyClaim` with a monotone EPOCH fences its every ask and
  tell, so a partitioned or zombie replica gets :class:`~hyperopt_tpu_torch.
  exceptions.OwnershipLost` instead of serving a study that failed over;
* :class:`Fleet` is the control plane: the consistent-hash ring
  (:class:`~hyperopt_tpu_torch.serve.router.HashRing`, salted with the
  study family's guard) places studies, :meth:`Fleet.failover` restores
  a dead replica's studies on ring survivors from their root, and
  :meth:`Fleet.drain_replica` is the planned rolling restart (typed
  ``Overloaded(reason="draining", retry_after=...)`` to clients, then
  snapshot, handoff, restore on the new owner, repoint).

The claim file is the reference's bytes (sorted-key JSON published by tmp,
fsync and rename), so replicas of either package fence each other over
one root; placement is the reference's key for key.

Determinism: placement is a function of (guard, study name, live
replicas); a stream is a function of (study seed, tell history), with
submit-time seeds and logged cursors, so a study that fails over goes on
bitwise; and a study's bits on the card do not depend on which replica
or which neighbours share its round (the fixed-order sums of the stacked
step).

Fencing caveat (the reference's): the claim check and the WAL append it
guards are two filesystem operations, so a takeover landing between them
can still interleave one record; a deployment puts the claim on a lease
and fences at the storage layer.  The fence sits before the WAL append
and before a round delivers, which closes every window the protocol can
see.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid

from ..distributed import _common
from ..distributed.faults import REAL_FS
from ..exceptions import OwnershipLost, ReplicaDead
from ..obs.expo import tag_rows
from ..obs.registry import GaugeAttr, MetricsRegistry
from .router import HashRing
from .service import SuggestService, _study_guard

logger = logging.getLogger(__name__)

__all__ = ["Fleet", "Replica", "StudyClaim", "fleet_salt"]


def fleet_salt(algo, space):
    """The ring's salt: the study family's guard, serialized, so placement
    is the same across routers, processes, runs and the two packages."""
    return json.dumps(_study_guard(algo, space), sort_keys=True)


class StudyClaim:
    """A study's ownership token at ``<root>/<name>.claim``.

    The file holds ``{"replica", "token", "epoch", "released"}``, published
    atomically (tmp, fsync, rename).  ``token`` is the uniqueness check (a
    holder proves it still owns the study by reading its token back);
    ``epoch`` is the fencing counter: every acquire and release bumps it,
    so ownership changes are totally ordered and a zombie's stale epoch
    never wins.  ``release`` writes a tombstone, keeping the epoch
    monotone, instead of unlinking.
    """

    SUFFIX = ".claim"

    def __init__(self, path, replica, token, epoch, fs=REAL_FS):
        self.path = path
        self.replica = replica
        self.token = token
        self.epoch = int(epoch)
        self.fs = fs

    @staticmethod
    def path_for(root, name):
        return os.path.join(str(root), name + StudyClaim.SUFFIX)

    @classmethod
    def read(cls, root, name, fs=REAL_FS):
        """The current claim doc, or None when never claimed."""
        return cls._read_path(cls.path_for(root, name), fs, "claim read")

    @staticmethod
    def _read_path(path, fs, label):
        def _read():
            if not fs.exists(path):
                return None
            with fs.open(path, "r") as f:
                return json.load(f)

        return _common.with_retries(_read, label=label)

    @classmethod
    def acquire(cls, root, name, replica, fs=REAL_FS, takeover=False):
        """Claim the study for ``replica``; returns the live claim.

        A study live-owned by ANOTHER replica is refused with
        :class:`OwnershipLost` unless ``takeover=True``: the failover and
        migration path, the only authority that may declare an owner
        dead.  The publish is last-writer-wins (an atomic rename) followed
        by a read-back, so losing a race to a concurrent claimant raises
        :class:`OwnershipLost` and never makes two winners."""
        fs.makedirs(str(root), exist_ok=True)
        cur = cls.read(root, name, fs=fs)
        if (cur is not None and not cur.get("released")
                and cur.get("replica") not in (None, replica) and not takeover):
            raise OwnershipLost(
                f"study {name!r} is owned by replica {cur['replica']!r} (epoch "
                f"{cur.get('epoch')}); only the failover/migration path may take it over"
            )
        epoch = (int(cur.get("epoch", -1)) + 1) if cur is not None else 0
        claim = cls(cls.path_for(root, name), str(replica), uuid.uuid4().hex, epoch, fs=fs)
        claim._publish({"replica": claim.replica, "token": claim.token, "epoch": claim.epoch,
                        "released": False})
        back = cls.read(root, name, fs=fs)
        if back is None or back.get("token") != claim.token:
            raise OwnershipLost(
                f"lost the claim race for study {name!r} to {(back or {}).get('replica')!r}")
        return claim

    def _publish(self, doc):
        def _write():
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with self.fs.open(tmp, "w") as f:
                f.write(json.dumps(doc, sort_keys=True))
                self.fs.fsync(f)
            self.fs.crashpoint("fleet_claim_tmp_before_rename")
            self.fs.rename(tmp, self.path)

        _common.with_retries(_write, label="claim publish")

    def is_live(self):
        """Whether this replica still owns the study: the claim file
        carries OUR token.  False after any takeover or release."""
        cur = self._read_path(self.path, self.fs, "claim check")
        return cur is not None and not cur.get("released") and cur.get("token") == self.token

    def ensure_live(self):
        if not self.is_live():
            raise OwnershipLost(
                f"replica {self.replica!r} no longer holds the claim for "
                f"{os.path.basename(self.path)!r} (taken over or released); dropping the "
                "operation instead of double-serving"
            )

    def release(self, handoff=False):
        """Tombstone the claim (the epoch bumped): the planned half of a
        migration.  A crashed owner never releases; its successor takes
        over with ``acquire(takeover=True)``.  ``handoff=True`` marks the
        tombstone as a migration's source half: the next acquire
        overwrites the mark, so a mark still on disk is a study stranded
        between handoff and restore (``hyperopt-tpu-torch-fsck --serve``'s
        ``study_half_migrated``)."""
        if not self.is_live():
            return  # taken over already: nothing of ours to release
        self.epoch += 1
        doc = {"replica": None, "token": None, "epoch": self.epoch, "released": True}
        if handoff:
            doc["handoff"] = True
        self._publish(doc)


class Replica:
    """One fleet member: a fleet-identified ``SuggestService`` and the
    flags the in-process harness needs (``dead``: the process is gone;
    ``partitioned``: alive but cut off from the router, the zombie the
    claim epochs exist for)."""

    def __init__(self, rid, service):
        self.rid = str(rid)
        self.service = service
        self.dead = False
        self.partitioned = False

    def _check(self):
        if self.dead:
            raise ReplicaDead(f"replica {self.rid!r} is dead")

    def _handle(self, name):
        svc = self.service
        with svc._lock:
            handle = svc._handles.get(name)
        if handle is None and svc.root is not None:
            # lazy adoption: the ring routed the study here, so what the
            # shared root holds of it is ours to restore (the failover and
            # aborted-migration heal)
            handle = svc.create_study(name, takeover=True)
        if handle is None:
            raise ValueError(f"study {name!r} unknown on {self.rid!r}")
        return handle

    # -- the ops the router forwards ---------------------------------------
    def open_study(self, name, seed=0, takeover=False):
        self._check()
        return self.service.create_study(name, seed=seed, takeover=takeover)

    def ask(self, name, timeout=60.0, recover=False):
        self._check()
        return self._handle(name).ask(timeout=timeout, recover=recover)

    def ask_async(self, name):
        self._check()
        return self._handle(name).ask_async()

    def tell(self, name, tid, loss, vals=None):
        self._check()
        return self._handle(name).tell(tid, loss, vals=vals)

    def best(self, name):
        self._check()
        return self._handle(name).best()

    def close_study(self, name):
        self._check()
        self.service.close_study(name)

    def pump_until(self, futures, timeout=60.0):
        """Serve coalesced rounds until every future resolves (a crash
        propagates: the router is the failure detector)."""
        self._check()
        deadline = time.perf_counter() + float(timeout)
        while not all(f.done() for f in futures):
            if self.service.pump() == 0:
                if time.perf_counter() > deadline:
                    raise TimeoutError(
                        f"replica {self.rid!r}: batch not served within {timeout}s")
                time.sleep(0.001)

    def die(self):
        """Crash semantics: the process is gone.  No snapshots and no claim
        releases; close the files a dead process would close and refuse
        every later op."""
        if self.dead:
            return
        self.dead = True
        for st in list(self.service.scheduler._studies.values()):
            if st.persist is not None:
                st.persist.wal.close()


class Fleet:
    """The control plane: replicas, the ring, the registry of studies, and
    failover.

    ``plans`` maps a replica id to a :class:`~hyperopt_tpu_torch.
    distributed.faults.FaultPlan` (crash points or a storm per replica);
    ``fs`` is the fleet manager's own seam (the migration's crash point
    between handoff and restore, the autoscaler's mid-scale-out one).
    ``service_kw`` goes to every replica's ``SuggestService`` (batch
    sizes, algo parameters, ``device``: keep them equal across replicas
    or streams stop being independent of placement).  Every replica runs
    on the card unless ``device="cpu"`` is passed.
    """

    #: the last failover's restore time (ms); None before the first
    recovery_ms = GaugeAttr("fleet_recovery_ms", "last failover's study re-materialization time")

    def __init__(self, space, root, n_replicas=3, algo="tpe", replica_ids=None, plans=None,
                 fs=REAL_FS, vnodes=64, **service_kw):
        self.metrics = MetricsRegistry("fleet")
        self.space = space
        self.root = str(root)
        self.algo = str(algo)
        self.fs = fs
        self.service_kw = dict(service_kw)
        self.salt = fleet_salt(algo, space)
        self.ring = HashRing(salt=self.salt, vnodes=vnodes)
        self.replicas = {}
        self.registry = set()  # the studies created through the router
        self._moved = {}  # name -> rid: a migration's repoint ahead of the ring
        # the membership lock: scale-out, scale-in and failover all move
        # claims, and two of them interleaving (the autoscaler racing the
        # router's failure handling) could adopt a study twice or strand
        # it; each runs under this one lock and sees the other's finished
        # placement (the claim epochs stay the guarantee across processes)
        self._mlock = threading.RLock()
        plans = plans or {}
        for rid in replica_ids or [f"r{i}" for i in range(n_replicas)]:
            plan = plans.get(rid)
            self.add_replica(rid, fs=None if plan is None else plan.fs(), migrate=False)

    # -- membership --------------------------------------------------------
    def add_replica(self, rid, fs=None, migrate=True):
        """Join a replica.  With ``migrate=True`` (scale-out, a rolling
        replacement) the registered studies the ring now places on it are
        handed over by the drain protocol: adding a node moves about 1/N
        of the keys and nothing else.

        The ``pilot_mid_scale_out`` crash point (on the fleet's plan)
        fires after the first remapped study moved: the ring holds the
        new replica, the rest of the remapped studies have not moved, and
        the new owner adopts each on its first routed request.  Running
        ``add_replica`` again is refused (the rid is a member)."""
        with self._mlock:
            rid = str(rid)
            if rid in self.replicas:
                raise ValueError(f"replica {rid!r} already in the fleet")
            service = SuggestService(self.space, algo=self.algo, root=self.root,
                                     fs=fs if fs is not None else REAL_FS, owner=rid,
                                     background=False, **self.service_kw)
            replica = Replica(rid, service)
            before = self.ring.placement(self.registry) if migrate and self.registry else {}
            self.replicas[rid] = replica
            self.ring.add(rid)
            if before:
                after = self.ring.placement(self.registry)
                moved = 0
                for name in sorted(self.registry):
                    if after[name] == rid and before[name] != rid:
                        self.migrate_study(name, rid, src_rid=before[name])
                        moved += 1
                        if moved == 1:
                            self.fs.crashpoint("pilot_mid_scale_out")
            return replica

    def register(self, name):
        with self._mlock:
            self.registry.add(name)

    def unregister(self, name):
        with self._mlock:
            self.registry.discard(name)
            self._moved.pop(name, None)

    def route(self, name):
        """The replica serving ``name``: a pending migration's target, else
        the ring's owner."""
        with self._mlock:
            rid = self._moved.get(name)
            if rid is not None and rid in self.ring.nodes:
                return rid
            return self.ring.owner(name)

    # -- failure handling --------------------------------------------------
    def mark_dead(self, rid):
        """The router saw ``rid`` fail.  A partitioned replica keeps
        running (the zombie the claim epochs fence); anything else gets
        crash semantics."""
        replica = self.replicas.get(rid)
        if replica is None or replica.partitioned:
            return
        replica.die()

    def kill_replica(self, rid):
        """A replica's process is killed from outside: crash semantics now,
        failover when the router notices."""
        self.replicas[rid].die()

    def partition(self, rid):
        """Cut a replica off from the router: its studies fail over, while
        it keeps running as a zombie whose fenced ops all raise
        ``OwnershipLost``."""
        self.replicas[rid].partitioned = True

    def heal(self, rid):
        """The partition lifts: the replica was alive all along and rejoins
        the ring.  Its resident handles still carry the old claims, so its
        first routed op per study raises ``OwnershipLost`` and the router
        re-claims the study with ``create_study(takeover=True)`` (the epoch
        bumped, restored from the root): the client sees nothing.  A no-op
        for a dead or unknown rid."""
        with self._mlock:
            replica = self.replicas.get(rid)
            if replica is None or replica.dead:
                return
            replica.partitioned = False
            self.ring.add(rid)  # the same ~1/N move as any membership change

    def failover(self, rid):
        """Restore a dead replica's studies on ring survivors from their
        WAL and snapshot pairs (exactly once, the claim epochs bumped).
        Idempotent; returns the moved names."""
        with self._mlock:
            if rid not in self.ring.nodes:
                return []
            t0 = time.perf_counter()
            owned = [n for n in sorted(self.registry) if self.route(n) == rid]
            self.ring.remove(rid)
            self._moved = {n: r for n, r in self._moved.items() if r != rid}
            for name in owned:
                new_rid = self.ring.owner(name)
                self.replicas[new_rid].open_study(name, takeover=True)
                logger.info("failover: study %r restored on %r (was %r)", name, new_rid, rid)
            self.metrics.gauge("fleet_recovery_ms",
                               "last failover's study re-materialization time").set_duration_ms(t0)
            self.metrics.counter("fleet_failovers_total", "replica failovers executed").inc()
            return owned

    # -- planned migration (the drain protocol) ----------------------------
    def migrate_study(self, name, dst_rid, src_rid=None):
        """Snapshot, hand off, restore on the new owner, repoint.

        Idempotent across coordinator crashes: a re-run skips the handoff
        when the source already released the study (the
        ``fleet_migrate_after_handoff_before_restore`` window) and the
        restore when the target already adopted it."""
        with self._mlock:
            src_rid = src_rid if src_rid is not None else self.route(name)
            if src_rid == dst_rid:
                return
            src = self.replicas[src_rid]
            if not src.dead and name in src.service.studies():
                src.service.handoff_study(name)
            self.fs.crashpoint("fleet_migrate_after_handoff_before_restore")
            self.replicas[dst_rid].open_study(name, takeover=True)
            self._moved[name] = dst_rid

    def begin_drain(self, rid, timeout=30.0):
        """Mark the replica draining: new asks are refused with
        ``Overloaded(reason="draining", retry_after=<time left until the
        drain deadline>)`` while migration proceeds."""
        self.replicas[rid].service.drain(timeout=timeout, block=False)

    def complete_drain(self, rid):
        """Migrate every owned study to its ring successor, flip the ring,
        shut the replica down.  Returns the migrated names."""
        with self._mlock:
            replica = self.replicas[rid]
            owned = [n for n in sorted(self.registry) if self.route(n) == rid]
            for name in owned:
                self.migrate_study(name, self.ring.owner(name, exclude={rid}), src_rid=rid)
            self.ring.remove(rid)
            self._moved = {n: r for n, r in self._moved.items()
                           if n in self.registry and self.ring.owner(n) != r}
            replica.service.shutdown()
            replica.dead = True
            del self.replicas[rid]
            return owned

    def drain_replica(self, rid, timeout=30.0):
        """The whole rolling-restart step for one replica."""
        self.begin_drain(rid, timeout=timeout)
        return self.complete_drain(rid)

    # -- observability -----------------------------------------------------
    def health(self):
        return {
            rid: ({"status": "dead"} if r.dead
                  else {"partitioned": True, **r.service.health()} if r.partitioned
                  else r.service.health())
            for rid, r in sorted(self.replicas.items())
        }

    def metrics_rows(self):
        """The whole in-process fleet's exposition: the control plane's own
        series and every live replica's, each tagged with its replica id.
        Each replica's ``serve_kernel_launches`` counts its own rounds'
        launches, so the rows sum to the process's launches."""
        rows = list(self.metrics.collect())
        for rid, r in sorted(self.replicas.items()):
            if not r.dead:
                rows.extend(tag_rows(r.service.metrics_rows(), replica=rid))
        return rows

    def counters(self):
        """The live replicas' deterministic counters, summed."""
        total = {}
        for r in self.replicas.values():
            if r.dead:
                continue
            for k, v in r.service.counters.items():
                total[k] = total.get(k, 0) + v
        total["replicas_alive"] = sum(1 for r in self.replicas.values() if not r.dead)
        return total

    def wal_fsyncs_per_tell(self):
        """WAL fsyncs per tell across the fleet: 1.0 with an fsync per
        tell, toward 1/round-size under group commit."""
        c = self.counters()
        tells = c.get("wal_tells", 0)
        return (c.get("wal_fsyncs", 0) / tells) if tells else 0.0

    def shutdown(self):
        for r in self.replicas.values():
            if not r.dead:
                r.service.shutdown()
