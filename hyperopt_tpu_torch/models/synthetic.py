"""The throughput benchmark space (a copy of ``mixed_space`` and
``mixed_space_fn`` from :mod:`hyperopt_tpu.models.synthetic`, built with
the port's ``hp``)."""

from __future__ import annotations

import math

from .. import hp

__all__ = ["mixed_space", "mixed_space_fn"]


def mixed_space(n_uniform=8, n_loguniform=4, n_quniform=2, n_randint=3, n_choice=3):
    """A D-dim mixed continuous/categorical flat space (defaults: 20-dim,
    the throughput benchmark configuration)."""
    space = {}
    for i in range(n_uniform):
        space[f"u{i}"] = hp.uniform(f"u{i}", -5, 5)
    for i in range(n_loguniform):
        space[f"lu{i}"] = hp.loguniform(f"lu{i}", -5, 2)
    for i in range(n_quniform):
        space[f"qu{i}"] = hp.quniform(f"qu{i}", 0, 20, 1)
    for i in range(n_randint):
        space[f"ri{i}"] = hp.randint(f"ri{i}", 8)
    for i in range(n_choice):
        space[f"ch{i}"] = hp.choice(f"ch{i}", list(range(5)))
    return space


def mixed_space_fn(cfg):
    """Cheap separable loss over ``mixed_space`` (objective cost ~0, so
    suggest dominates)."""
    t = 0.0
    for k, v in cfg.items():
        if k.startswith("lu"):
            t += (math.log(max(v, 1e-12))) ** 2 / 50.0
        elif k.startswith("u"):
            t += (v - 1.0) ** 2 / 50.0
        elif k.startswith("qu"):
            t += abs(v - 10.0) / 100.0
        elif k.startswith("ri") or k.startswith("ch"):
            t += 0.02 * (v % 3)
    return t
