"""Closed-form acquisition criteria over Gaussian predictions.

The port's copy of :mod:`hyperopt_tpu.criteria`: expected improvement
(empirical and Gaussian), a log EI that stays finite deep in the tail,
and the upper confidence bound.  Not wired into TPE, as in the
reference.  Each function takes numpy arrays (computed with scipy's
``erf``) or torch tensors (computed with ``torch.special.erf`` on the
tensor's device) and returns the kind it was given.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["EI_empirical", "EI_gaussian", "logEI_gaussian", "UCB"]


class _TorchOps:
    """The numpy names these formulas use, over torch tensors."""

    pi = math.pi

    def __init__(self, like):
        self.dtype = like.dtype if like.is_floating_point() else torch.float64
        self.device = like.device

    def asarray(self, x, dtype=None):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def maximum(self, a, b):
        return torch.clamp_min(a, b) if not torch.is_tensor(b) else torch.maximum(a, b)

    def where(self, c, a, b):
        return torch.where(c, a, b)

    def sqrt(self, x):
        return torch.sqrt(x) if torch.is_tensor(x) else math.sqrt(x)

    def log(self, x):
        return torch.log(x) if torch.is_tensor(x) else math.log(x)

    exp = staticmethod(torch.exp)
    log1p = staticmethod(torch.log1p)


def _np_mod(x):
    return _TorchOps(x) if torch.is_tensor(x) else np


def _norm_pdf(x, xp):
    return xp.exp(-0.5 * x * x) / xp.sqrt(2 * xp.pi)


def _norm_cdf(x, xp):
    if xp is np:
        from scipy.special import erf
    else:
        erf = torch.special.erf
    return 0.5 * (1.0 + erf(x / xp.sqrt(2.0)))


def EI_empirical(samples, thresh):
    """Expected improvement over ``thresh`` from empirical samples."""
    xp = _np_mod(samples)
    samples = xp.asarray(samples)
    return xp.maximum(samples - thresh, 0.0).mean()


def EI_gaussian(mean, var, thresh):
    """Expected improvement over ``thresh`` of N(mean, var)."""
    xp = _np_mod(mean)
    mean = xp.asarray(mean, dtype=float)
    var = xp.asarray(var, dtype=float)
    sigma = xp.sqrt(var)
    score = (mean - thresh) / sigma
    return sigma * (score * _norm_cdf(score, xp) + _norm_pdf(score, xp))


def logEI_gaussian(mean, var, thresh):
    """log(EI_gaussian), numerically stable deep into the tail.

    For score << 0 uses the asymptotic expansion
    ``EI ~ pdf(s) * sigma / s^2`` so the log stays finite where the naive
    formula underflows.
    """
    xp = _np_mod(mean)
    mean = xp.asarray(mean, dtype=float)
    var = xp.asarray(var, dtype=float)
    sigma = xp.sqrt(var)
    score = (mean - thresh) / sigma

    naive_inner = score * _norm_cdf(score, xp) + _norm_pdf(score, xp)
    naive = xp.log(xp.maximum(naive_inner, 1e-300)) + xp.log(sigma)
    # tail: log(pdf(s)/s^2 * (1 - 2/s^2)) + log(sigma)
    s2 = xp.maximum(score * score, 1e-12)
    tail = (
        -0.5 * s2
        - 0.5 * xp.log(2 * xp.pi)
        - xp.log(s2)
        + xp.log1p(xp.maximum(-2.0 / s2, -0.999))
        + xp.log(sigma)
    )
    use_tail = score < -6.0
    return xp.where(use_tail, tail, naive)


def UCB(mean, var, zscore):
    """Upper confidence bound: mean + zscore * std."""
    xp = _np_mod(mean)
    return xp.asarray(mean, dtype=float) + xp.sqrt(
        xp.asarray(var, dtype=float)
    ) * zscore
