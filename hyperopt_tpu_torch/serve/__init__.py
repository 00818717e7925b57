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
  pipelining, byte for byte the reference's.

``fmin(engine=True)`` is an in-process client of this engine, and
:class:`~hyperopt_tpu_torch.client.RemoteStudy` a socket client
(:mod:`hyperopt_tpu_torch.client`).  The fleet is not ported yet
(``ROADMAP.md`` Queue A, item 12d).

Example, on the card::

    from hyperopt_tpu_torch import hp
    from hyperopt_tpu_torch.serve import SuggestService

    svc = SuggestService({"x": hp.uniform("x", -5, 5)}, max_batch=64)
    study = svc.create_study("s0", seed=1)
    tid, vals = study.ask()
    study.tell(tid, (vals["x"] - 1) ** 2)
    svc.shutdown()
"""

__all__ = ["StudyHandle", "SuggestService"]


def __getattr__(name):
    # lazy, as the reference's: ``python -m hyperopt_tpu_torch.serve.service``
    # then runs the one copy of the module
    if name in __all__:
        from . import service

        return getattr(service, name)
    raise AttributeError(name)
