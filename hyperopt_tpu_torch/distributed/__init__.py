"""Asynchronous execution backends and the fault seams of the PyTorch port
(the port of :mod:`hyperopt_tpu.distributed`).  In every backend the
driver runs the suggestion on the domain's device; the backend only
evaluates.

``threads``    -- ``ThreadTrials``: in-process thread-pool evaluation with
                  a parallelism cap, timeout and cancellation.
``filequeue``  -- ``FileTrials`` + ``hyperopt-tpu-torch-worker``
                  (:mod:`.worker`): a shared-filesystem job queue with
                  atomic (rename-based) reservation, reserve-timeout
                  reaping, pickled-Domain shipping and ERROR capture.
``asha_queue`` -- ASHA farmed to every backend: ``asha_filequeue``,
                  ``asha_mongo`` and ``asha_spark``; the budget rides the
                  trial doc and the pickled ``BudgetedDomainFn`` hands it
                  to the objective.
``mongo``      -- ``MongoTrials``: the MongoDB protocol (CAS reservation,
                  GridFS attachments); needs pymongo, import-gated.
``spark``      -- ``SparkTrials``: a dispatcher thread and a one-task Spark
                  job per trial; needs pyspark, import-gated.
``faults``     -- ``FaultPlan``: seeded file faults and crash points for
                  the filesystem seam; ``netfaults``: seeded network faults.
``fsck``       -- ``hyperopt-tpu-torch-fsck``: audit and repair of a queue
                  directory, a serve root, a driver checkpoint or a flight
                  log.
"""

from .faults import REAL_FS, FaultPlan
from .filequeue import FileJobQueue, FileTrials
from .threads import ThreadTrials

__all__ = [
    "ThreadTrials", "FileTrials", "FileJobQueue", "FaultPlan", "REAL_FS",
    "asha_filequeue", "asha_mongo", "asha_spark", "BudgetedDomainFn",
]


def __getattr__(name):
    import importlib

    if name in ("fsck",):
        mod = importlib.import_module(".fsck", __name__)
        globals()["fsck"] = mod
        return mod
    if name in (
        "asha_queue", "asha_filequeue", "asha_mongo", "asha_spark",
        "BudgetedDomainFn",
    ):
        # lazy: pulls in the host schedulers only when the ASHA-over-queue
        # driver is used
        mod = importlib.import_module(".asha_queue", __name__)
        globals()["asha_queue"] = mod
        return mod if name == "asha_queue" else getattr(mod, name)
    if name in ("mongo", "MongoTrials"):
        mod = importlib.import_module(".mongo", __name__)
        globals()["mongo"] = mod
        return mod if name == "mongo" else mod.MongoTrials
    if name in ("spark", "SparkTrials"):
        mod = importlib.import_module(".spark", __name__)
        globals()["spark"] = mod
        return mod if name == "spark" else mod.SparkTrials
    raise AttributeError(name)
