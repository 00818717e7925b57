"""The study-batched suggestion service of the PyTorch port.

The counterpart of :mod:`hyperopt_tpu.serve`, batching the ask/tell
boundary ACROSS studies as LLM serving batches requests:

* :mod:`.batched` -- the device engine: N studies' histories stacked
  along a leading study axis and one fused tell+ask step over all of
  them, whose launch sequence does not grow with N and holds one
  ``gmm_llr`` kernel launch;
* :mod:`.scheduler` -- the continuous-batching scheduler: a slotted
  batch, admission control, the finite-check guard and the dispatch
  watchdog, with per-study seed streams that keep every study's
  suggestions independent of batching order;
* :mod:`.service` -- the in-process front (:class:`SuggestService`,
  :class:`StudyHandle`), per-study durability (``root=``: a write-ahead
  log and snapshots per study, exactly-once tells across a crash), and
  the TCP front (``serve_forever``, the ``hyperopt-tpu-torch-serve``
  console script);
* :mod:`.frames` -- the wire: JSON lines, negotiated binary frames and
  pipelining, byte for byte the reference's;
* :mod:`.fleet`, :mod:`.router` -- the horizontal tier above one service:
  replicas over one study root fenced by per-study claim/epoch tokens
  (:class:`StudyClaim`), placed by the consistent-hash ring
  (:class:`HashRing`), migrated by snapshot and handoff, failed over by
  takeover (:class:`Fleet`), routed in-process (:class:`FleetRouter`) or
  as a process (the ``hyperopt-tpu-torch-router`` console script);
* :mod:`.pilot`, :mod:`.replay` -- the autoscaler that reads only the
  fleet's scrape (:class:`FleetPilot`, :class:`PilotConfig`), and
  flight-recorder logs replayed as traffic (:func:`extract_workload`,
  :func:`replay_flight_log`, :func:`stream_hash`).

``fmin(engine=True)`` is an in-process client of this engine, and
:class:`~hyperopt_tpu_torch.client.RemoteStudy` a socket client
(:mod:`hyperopt_tpu_torch.client`).

Example, on the card::

    from hyperopt_tpu_torch import hp
    from hyperopt_tpu_torch.serve import SuggestService

    svc = SuggestService({"x": hp.uniform("x", -5, 5)}, max_batch=64)
    study = svc.create_study("s0", seed=1)
    tid, vals = study.ask()
    study.tell(tid, (vals["x"] - 1) ** 2)
    svc.shutdown()

A fleet of three replicas on the card, routed in-process::

    from hyperopt_tpu_torch.serve import Fleet, FleetRouter

    fleet = Fleet({"x": hp.uniform("x", -5, 5)}, "/shared/studies", n_replicas=3)
    router = FleetRouter(fleet)
    router.create_study("s0", seed=1)
    tid, vals = router.ask("s0")
    router.tell("s0", tid, (vals["x"] - 1) ** 2)
    fleet.shutdown()
"""

_HOMES = {
    "StudyHandle": "service",
    "SuggestService": "service",
    # the fleet: the horizontal tier above one service
    "Fleet": "fleet",
    "StudyClaim": "fleet",
    "FleetRouter": "router",
    "HashRing": "router",
    # the autoscaler and traffic replay
    "FleetPilot": "pilot",
    "PilotConfig": "pilot",
    "extract_workload": "replay",
    "replay_flight_log": "replay",
    "stream_hash": "replay",
}

__all__ = list(_HOMES)


def __getattr__(name):
    # lazy, as the reference's: ``python -m hyperopt_tpu_torch.serve.service``
    # then runs the one copy of the module
    home = _HOMES.get(name)
    if home is not None:
        import importlib

        return getattr(importlib.import_module(f".{home}", __name__), name)
    raise AttributeError(name)
