"""Trial-document construction shared by the port's suggest algorithms
(the port's copy of :func:`hyperopt_tpu.rand.docs_from_idxs_vals`)."""

from __future__ import annotations

__all__ = ["docs_from_idxs_vals"]


def docs_from_idxs_vals(new_ids, domain, trials, idxs, vals):
    """Build NEW trial documents from a sparse batch encoding."""
    labels = sorted(idxs)
    rval_specs = []
    rval_results = []
    rval_miscs = []
    for tid in new_ids:
        misc = {
            "tid": tid,
            "cmd": domain.cmd,
            "workdir": domain.workdir,
            "idxs": {label: [] for label in labels},
            "vals": {label: [] for label in labels},
        }
        rval_specs.append(None)
        rval_results.append(domain.new_result())
        rval_miscs.append(misc)
    by_tid = {m["tid"]: m for m in rval_miscs}
    for label in labels:
        for tid, val in zip(idxs[label], vals[label]):
            by_tid[tid]["idxs"][label] = [tid]
            by_tid[tid]["vals"][label] = [val]
    return trials.new_trial_docs(new_ids, rval_specs, rval_results, rval_miscs)
