"""Dense -> sparse ``idxs/vals`` bridge at the API boundary (the port's
copy of :func:`hyperopt_tpu.vectorize.dense_to_idxs_vals`)."""

from __future__ import annotations

import numpy as np

__all__ = ["dense_to_idxs_vals"]


def dense_to_idxs_vals(new_ids, labels, values, active):
    """Convert dense per-label arrays + active-mask to sparse idxs/vals.

    Args:
      new_ids: sequence of trial ids, length n.
      labels: list of D label strings.
      values: [D, n] array-like of drawn values (garbage where inactive).
      active: [D, n] boolean mask.
    """
    idxs = {}
    vals = {}
    new_ids = list(new_ids)
    values = np.asarray(values)
    active = np.asarray(active, dtype=bool)  # int masks must not fancy-index
    for d, label in enumerate(labels):
        mask = active[d]
        if mask.all():
            idxs[label] = list(new_ids)
        else:
            idxs[label] = [tid for tid, m in zip(new_ids, mask) if m]
        vals[label] = values[d][mask].tolist()
    return idxs, vals
