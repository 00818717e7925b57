"""Host sampling of one space and the dense -> sparse ``idxs/vals``
bridge at the API boundary: the port's copy of
:class:`hyperopt_tpu.vectorize.VectorizeHelper` (the pyll sampler ATPE's
restarts and the host random search of :mod:`hyperopt_tpu_torch.rand_host`
draw from) and :func:`hyperopt_tpu.vectorize.dense_to_idxs_vals`."""

from __future__ import annotations

import numpy as np

from .pyll.base import Literal, as_apply, clone, dfs, rec_eval
from .pyll.stochastic import STOCHASTIC_NAMES, ensure_rng
from .pyll_utils import expr_to_config

__all__ = ["VectorizeHelper", "dense_to_idxs_vals"]


class VectorizeHelper:
    """Samples trials from an hp-annotated space on the host, one
    ``rec_eval`` per trial with lazy ``switch``, so only the labels active
    on a trial's ``hp.choice`` branch are drawn."""

    def __init__(self, expr):
        self.expr = as_apply(expr)
        self.hps = expr_to_config(self.expr)
        self.labels = sorted(self.hps)
        # clone once; a trial's rng goes in by swapping one Literal's payload
        self._rng_literal = Literal(None)
        self._sampling_expr = clone(self.expr)
        for node in dfs(self._sampling_expr):
            if node.name in STOCHASTIC_NAMES:
                named = dict(node.named_args)
                if "rng" not in named:
                    node.named_args.append(("rng", self._rng_literal))
                    node.named_args.sort()

    def sample_one(self, rng):
        """Draw one trial's config: {label: raw value} for the active
        labels only."""
        self._rng_literal._obj = ensure_rng(rng)
        vals = {}

        def observer(node, value):
            if node.name == "hyperopt_param":
                vals[node.pos_args[0].obj] = value

        rec_eval(self._sampling_expr, observer=observer)
        return vals

    def sample_batch(self, new_ids, rng):
        """One config per trial id, as sparse ``(idxs, vals)`` dicts over
        every label (a label inactive on a trial has no entry for it)."""
        rng = ensure_rng(rng)
        idxs = {label: [] for label in self.labels}
        vals = {label: [] for label in self.labels}
        for tid in new_ids:
            for label, value in self.sample_one(rng).items():
                idxs[label].append(tid)
                vals[label].append(value)
        return idxs, vals


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
