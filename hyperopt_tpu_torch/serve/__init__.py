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
  :class:`StudyHandle`) and per-study durability (``root=``: a
  write-ahead log and snapshots per study, exactly-once tells across a
  crash).

``fmin(engine=True)`` is a client of this engine
(:mod:`hyperopt_tpu_torch.client`).  The socket transport and the fleet
are not ported yet (``ROADMAP.md`` Queue A, items 12c and 12d).

Example, on the card::

    from hyperopt_tpu_torch import hp
    from hyperopt_tpu_torch.serve import SuggestService

    svc = SuggestService({"x": hp.uniform("x", -5, 5)}, max_batch=64)
    study = svc.create_study("s0", seed=1)
    tid, vals = study.ask()
    study.tell(tid, (vals["x"] - 1) ** 2)
    svc.shutdown()
"""

from .service import StudyHandle, SuggestService

__all__ = ["StudyHandle", "SuggestService"]
