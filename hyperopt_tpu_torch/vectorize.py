"""Host sampling of one space and the dense <-> sparse ``idxs/vals``
bridges at the API boundary: the port's copy of
:mod:`hyperopt_tpu.vectorize` -- :class:`VectorizeHelper` (the pyll
sampler that ATPE's restarts, the host algorithms and the host random
search of :mod:`hyperopt_tpu_torch.rand_host` draw from),
:func:`sample_config`, :func:`pretty_names`, :func:`dense_to_idxs_vals`
and :func:`idxs_vals_to_dense`."""

from __future__ import annotations

import numpy as np

from .pyll.base import Literal, as_apply, clone, dfs, rec_eval
from .pyll.stochastic import STOCHASTIC_NAMES, ensure_rng
from .pyll_utils import expr_to_config

__all__ = [
    "VectorizeHelper",
    "pretty_names",
    "sample_config",
    "dense_to_idxs_vals",
    "idxs_vals_to_dense",
]


class VectorizeHelper:
    """Samples trials from an hp-annotated space on the host, one
    ``rec_eval`` per trial with lazy ``switch``, so only the labels active
    on a trial's ``hp.choice`` branch are drawn.  ``idxs_by_label()`` /
    ``vals_by_label()`` return the sparse encoding of the latest batch."""

    def __init__(self, expr, s_new_ids=None):
        self.expr = as_apply(expr)
        self.s_new_ids = s_new_ids
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
        self._last_idxs = None
        self._last_vals = None

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
        self._last_idxs, self._last_vals = idxs, vals
        return idxs, vals

    def idxs_by_label(self):
        if self._last_idxs is None:
            raise RuntimeError("no batch sampled yet")
        return self._last_idxs

    def vals_by_label(self):
        if self._last_vals is None:
            raise RuntimeError("no batch sampled yet")
        return self._last_vals


def sample_config(expr, rng):
    """One-shot convenience: {label: value} for one draw of ``expr``."""
    return VectorizeHelper(expr).sample_one(rng)


def pretty_names(expr, prefix=None):
    """{node: dotted-name} map for labeled params (a diagnostic aid)."""
    hps = expr_to_config(as_apply(expr))
    rval = {}
    for label, info in sorted(hps.items()):
        name = label if prefix is None else f"{prefix}.{label}"
        rval[info.node] = name
    return rval


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


def idxs_vals_to_dense(tids, labels, idxs, vals, fill=0.0):
    """Convert sparse idxs/vals to dense [D, n] values + active mask."""
    tid_pos = {tid: i for i, tid in enumerate(tids)}
    n = len(tids)
    D = len(labels)
    values = np.full((D, n), fill, dtype=np.float64)
    active = np.zeros((D, n), dtype=bool)
    for d, label in enumerate(labels):
        for tid, v in zip(idxs.get(label, []), vals.get(label, [])):
            if tid in tid_pos:
                i = tid_pos[tid]
                values[d, i] = v
                active[d, i] = True
    return values, active
