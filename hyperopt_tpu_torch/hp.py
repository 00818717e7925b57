"""``hp.*`` search-space constructors (the port's copy).

A copy of :mod:`hyperopt_tpu.hp` over the port's own ``scope``: each
``hp.X(label, ...)`` wraps a stochastic node in ``hyperopt_param(label,
...)``; ``hp.choice`` is ``switch(randint(n), *opts)``; ``hp.pchoice`` is
``switch(categorical(p), *opts)``.  The graphs are compiled to dense
tensors by :mod:`hyperopt_tpu_torch.ops.compile`.
"""

from __future__ import annotations

from .exceptions import InvalidAnnotatedParameter
from .pyll.base import scope
from .pyll_utils import validate_label

__all__ = [
    "choice",
    "pchoice",
    "randint",
    "uniform",
    "quniform",
    "uniformint",
    "loguniform",
    "qloguniform",
    "normal",
    "qnormal",
    "lognormal",
    "qlognormal",
]


def choice(label, options):
    """Choose one of ``options`` uniformly; conditional subspaces allowed."""
    validate_label(label)
    options = list(options)
    if not options:
        raise InvalidAnnotatedParameter(f"hp.choice({label!r}): empty options")
    ch = scope.hyperopt_param(label, scope.randint(len(options)))
    return scope.switch(ch, *options)


def pchoice(label, p_options):
    """Choose one of ``options`` with explicit probabilities.

    ``p_options`` is a list of ``(prob, option)`` pairs.
    """
    validate_label(label)
    p_options = list(p_options)
    if not p_options:
        raise InvalidAnnotatedParameter(f"hp.pchoice({label!r}): empty options")
    probs, options = [], []
    for item in p_options:
        try:
            p, opt = item
        except (TypeError, ValueError):
            raise InvalidAnnotatedParameter(
                f"hp.pchoice({label!r}): expected (prob, option) pairs"
            )
        probs.append(float(p))
        options.append(opt)
    total = sum(probs)
    if total <= 0:
        raise InvalidAnnotatedParameter(f"hp.pchoice({label!r}): probs sum <= 0")
    probs = [p / total for p in probs]
    ch = scope.hyperopt_param(label, scope.categorical(probs))
    return scope.switch(ch, *options)


def randint(label, *args):
    """``randint(label, upper)`` -> [0, upper); ``randint(label, low, high)``."""
    validate_label(label)
    if len(args) not in (1, 2):
        raise InvalidAnnotatedParameter(
            f"hp.randint({label!r}): takes (upper,) or (low, high)"
        )
    return scope.hyperopt_param(label, scope.randint(*args))


def uniform(label, low, high):
    validate_label(label)
    return scope.float(scope.hyperopt_param(label, scope.uniform(low, high)))


def quniform(label, low, high, q):
    validate_label(label)
    return scope.float(scope.hyperopt_param(label, scope.quniform(low, high, q)))


def uniformint(label, low, high, q=1.0):
    """Uniform integer in [low, high] (inclusive), via quantized uniform."""
    validate_label(label)
    if q != 1.0:
        raise InvalidAnnotatedParameter(
            f"hp.uniformint({label!r}): q must be 1.0 (use quniform for q != 1)"
        )
    return scope.int(scope.hyperopt_param(label, scope.quniform(low, high, q)))


def loguniform(label, low, high):
    """exp(uniform(low, high)) -- low/high are bounds in log space."""
    validate_label(label)
    return scope.float(scope.hyperopt_param(label, scope.loguniform(low, high)))


def qloguniform(label, low, high, q):
    validate_label(label)
    return scope.float(scope.hyperopt_param(label, scope.qloguniform(low, high, q)))


def normal(label, mu, sigma):
    validate_label(label)
    return scope.float(scope.hyperopt_param(label, scope.normal(mu, sigma)))


def qnormal(label, mu, sigma, q):
    validate_label(label)
    return scope.float(scope.hyperopt_param(label, scope.qnormal(mu, sigma, q)))


def lognormal(label, mu, sigma):
    validate_label(label)
    return scope.float(scope.hyperopt_param(label, scope.lognormal(mu, sigma)))


def qlognormal(label, mu, sigma, q):
    validate_label(label)
    return scope.float(scope.hyperopt_param(label, scope.qlognormal(mu, sigma, q)))
