"""HPOBench-style XGBoost surrogate benchmark (8-dim mixed space); the
port's copy of :mod:`hyperopt_tpu.models.surrogate`, built with its ``hp``.

BASELINE.json config #3: a mixed continuous/int/categorical space shaped
like XGBoost's hyperparameters with a deterministic, structured response
surface standing in for the real HPOBench lookup tables (which cannot be
downloaded in a zero-egress image).  The surface has the properties that
make HPOBench discriminative for optimizers: a log-scale optimum basin
for eta/regularization, integer plateaus for depth, interaction terms,
categorical offsets, and a rugged low-amplitude residual.
"""

from __future__ import annotations

import math

import numpy as np

from .. import hp

__all__ = ["space", "objective", "best_known"]


def space():
    """8-dim mixed: 4 cont (log/linear) + 2 int + 2 categorical."""
    return {
        "eta": hp.loguniform("eta", math.log(1e-3), math.log(1.0)),
        "reg_lambda": hp.loguniform("reg_lambda", math.log(1e-5), math.log(10.0)),
        "subsample": hp.uniform("subsample", 0.3, 1.0),
        "colsample": hp.uniform("colsample", 0.3, 1.0),
        "max_depth": hp.uniformint("max_depth", 2, 12),
        "min_child_weight": hp.quniform("min_child_weight", 1, 20, 1),
        "booster": hp.choice("booster", ["gbtree", "dart"]),
        "grow_policy": hp.pchoice(
            "grow_policy", [(0.7, "depthwise"), (0.3, "lossguide")]
        ),
    }


def _rugged(x, scale=0.015):
    """Deterministic low-amplitude residual (makes the surface non-convex
    without hiding the basin)."""
    return scale * math.sin(37.0 * x) * math.cos(17.0 * x * x)


def objective(cfg):
    """Validation-error-like loss in [0, ~1.2]; optimum ~0.031."""
    log_eta = math.log(cfg["eta"])
    log_lam = math.log(cfg["reg_lambda"])

    # basin: eta near 5e-2, lambda near 1e-2 (log-space quadratics)
    loss = 0.03
    loss += 0.018 * (log_eta - math.log(5e-2)) ** 2
    loss += 0.004 * (log_lam - math.log(1e-2)) ** 2
    # depth plateau: 6..8 optimal, integer steps matter
    depth = int(cfg["max_depth"])
    loss += 0.012 * max(0, 6 - depth) + 0.008 * max(0, depth - 8)
    # subsample/colsample ridge with interaction
    loss += 0.05 * (cfg["subsample"] - 0.85) ** 2
    loss += 0.05 * (cfg["colsample"] - 0.8) ** 2
    loss += 0.04 * abs(cfg["subsample"] - cfg["colsample"]) * (
        1.0 if depth > 8 else 0.3
    )
    # min_child_weight: mild preference for small values, interacting
    # with eta (big eta + small mcw overfits)
    mcw = float(cfg["min_child_weight"])
    loss += 0.002 * mcw
    loss += 0.02 * max(0.0, log_eta - math.log(0.2)) * max(0.0, 5.0 - mcw)
    # categorical offsets
    if cfg["booster"] == "dart":
        loss += 0.006
    if cfg["grow_policy"] == "lossguide":
        loss += 0.004 if depth <= 8 else -0.003
    # rugged residual keyed on the continuous dims
    loss += abs(_rugged(log_eta) + _rugged(cfg["subsample"], 0.01))
    return float(loss)


def best_known():
    """Approximate optimal loss (for test thresholds)."""
    return 0.032
