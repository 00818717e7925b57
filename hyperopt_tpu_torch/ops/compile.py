"""The space compiler of the PyTorch port: ``hp.*`` pyll graph -> dense
per-dimension tensors.

The numpy half of :class:`PackedSpace` is a copy of
:mod:`hyperopt_tpu.ops.compile`'s: the space is compiled once into flat
per-dimension parameter arrays, and sampling a batch of ``n`` trials is
a handful of tensor ops emitting dense ``[D, n]`` values plus an active
mask.  Conditional (``hp.choice``) structure compiles to padded condition
tables: ``active[d] = OR_a AND_c (values[cond_dim[d,a,c]] ==
cond_val[d,a,c])``.  The tensor half (``consts``, :meth:`active_fn`,
:meth:`sample_prior_fn`) lives on the space's device; every draw goes
through :mod:`hyperopt_tpu_torch.random`, so prior draws match the
reference's bit for bit before the float math.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import random as R
from ..exceptions import CompileError
from ..pyll.base import as_apply
from ..pyll_utils import expr_to_config
from ..utils import resolve_device

__all__ = ["PackedSpace", "compile_space"]

_CONT_DISTS = {
    "uniform": (False, False),  # (logspace, quantized)
    "quniform": (False, True),
    "loguniform": (True, False),
    "qloguniform": (True, True),
    "normal": (False, False),
    "qnormal": (False, True),
    "lognormal": (True, False),
    "qlognormal": (True, True),
}
_CAT_DISTS = {"randint", "categorical", "randint_via_categorical"}

#: the numpy fields that :attr:`PackedSpace.consts` puts on the device
CONST_FIELDS = (
    "low", "high", "prior_mu", "prior_sigma", "logspace", "q",
    "prior_p", "int_low", "n_options",
    "alt_mask", "term_mask", "cond_dim", "cond_val",
    "cont_idx", "cat_idx",
)


class PackedSpace:
    """Flat array encoding of a search space (host numpy + device tensors).

    Continuous dims are parameterized in *latent* space (log-space dists
    fit/sample on log values): ``low/high`` latent bounds (+-inf if
    unbounded), ``prior_mu/prior_sigma`` the TPE prior component, ``q``
    natural-space quantization (0 = none).  Categorical dims carry a
    zero-padded prior pmf and an integer offset (for ``hp.randint(low,
    high)``).  Condition tables encode hp.choice activation (see module
    docstring).  ``device`` is where :attr:`consts` and every program of
    the space live.
    """

    def __init__(self, labels, hps, device="cpu"):
        self.labels = labels
        self.hps = hps
        self.device = torch.device(device)
        D = len(labels)
        self.n_dims = D
        idx = {label: d for d, label in enumerate(labels)}

        kind = np.zeros(D, dtype=np.int32)
        cont, cat = [], []
        for d, label in enumerate(labels):
            dist = hps[label].dist
            if dist in _CONT_DISTS:
                cont.append(d)
            elif dist in _CAT_DISTS:
                cat.append(d)
            else:
                raise CompileError(f"cannot compile distribution {dist!r}")
        kind[cat] = 1
        self.kind = kind
        self.cont_idx = np.asarray(cont, dtype=np.int32)
        self.cat_idx = np.asarray(cat, dtype=np.int32)

        # -- continuous dim params (latent space) -------------------------
        Dc = len(cont)
        self.low = np.full(Dc, -np.inf, dtype=np.float32)
        self.high = np.full(Dc, np.inf, dtype=np.float32)
        self.prior_mu = np.zeros(Dc, dtype=np.float32)
        self.prior_sigma = np.ones(Dc, dtype=np.float32)
        self.logspace = np.zeros(Dc, dtype=bool)
        self.q = np.zeros(Dc, dtype=np.float32)
        for i, d in enumerate(cont):
            info = hps[labels[d]]
            p = info.params
            logspace, quantized = _CONT_DISTS[info.dist]
            self.logspace[i] = logspace
            if quantized:
                qv = p.get("q")
                if not isinstance(qv, (int, float)):
                    raise CompileError(
                        f"{info.label}: q must be a literal number, got {qv!r}"
                    )
                self.q[i] = float(qv)
            if info.dist in ("uniform", "quniform", "loguniform", "qloguniform"):
                lo, hi = p["low"], p["high"]
                if not isinstance(lo, (int, float)) or not isinstance(hi, (int, float)):
                    raise CompileError(
                        f"{info.label}: bounds must be literal numbers"
                    )
                self.low[i], self.high[i] = float(lo), float(hi)
                self.prior_mu[i] = 0.5 * (float(lo) + float(hi))
                self.prior_sigma[i] = float(hi) - float(lo)
            else:
                mu, sg = p["mu"], p["sigma"]
                if not isinstance(mu, (int, float)) or not isinstance(sg, (int, float)):
                    raise CompileError(
                        f"{info.label}: mu/sigma must be literal numbers"
                    )
                self.prior_mu[i], self.prior_sigma[i] = float(mu), float(sg)

        # -- categorical dim params ---------------------------------------
        Dk = len(cat)
        n_opts = []
        int_low = []
        priors = []
        for d in cat:
            info = hps[labels[d]]
            p = info.params
            if info.dist == "randint":
                lo = int(p["low"])
                hi = int(p["high"])
                n_opts.append(hi - lo)
                int_low.append(lo)
                priors.append(np.full(hi - lo, 1.0 / (hi - lo)))
            else:
                pm = np.asarray(p["p"], dtype=np.float64)
                n_opts.append(len(pm))
                int_low.append(0)
                priors.append(pm / pm.sum())
        self.k_max = max(n_opts, default=1)
        self.n_options = np.asarray(n_opts, dtype=np.int32)
        self.int_low = np.asarray(int_low, dtype=np.int32)
        self.prior_p = np.zeros((Dk, self.k_max), dtype=np.float32)
        for i, pm in enumerate(priors):
            self.prior_p[i, : len(pm)] = pm

        # -- condition tables ---------------------------------------------
        a_max = max((len(hps[l].conditions) for l in labels), default=1) or 1
        c_max = max(
            (len(conj) for l in labels for conj in hps[l].conditions), default=1
        ) or 1
        self.a_max, self.c_max = a_max, c_max
        self.alt_mask = np.zeros((D, a_max), dtype=bool)
        self.term_mask = np.zeros((D, a_max, c_max), dtype=bool)
        self.cond_dim = np.zeros((D, a_max, c_max), dtype=np.int32)
        self.cond_val = np.zeros((D, a_max, c_max), dtype=np.float32)
        for d, label in enumerate(labels):
            conds = sorted(hps[label].conditions) or [()]
            for a, conj in enumerate(conds):
                self.alt_mask[d, a] = True
                for c, term in enumerate(conj):
                    if term.name not in idx:
                        raise CompileError(
                            f"condition on unknown label {term.name!r}"
                        )
                    self.term_mask[d, a, c] = True
                    self.cond_dim[d, a, c] = idx[term.name]
                    self.cond_val[d, a, c] = float(term.val)

        self.unconditional = bool(
            all(hps[l].unconditional for l in labels)
        )

    # -- device-side programs ---------------------------------------------
    @functools.cached_property
    def consts(self):
        """The packed fields as tensors on :attr:`device` (index arrays as
        int64, so they index tensors directly)."""
        out = {}
        for k in CONST_FIELDS:
            a = getattr(self, k)
            if a.dtype == np.int32:
                a = a.astype(np.int64)
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return out

    def active_fn(self, values):
        """[..., D, n] dense values -> [..., D, n] active mask (leading
        dims: a stack of studies)."""
        if self.unconditional:
            return torch.ones(values.shape, dtype=torch.bool, device=values.device)
        c = self.consts
        gathered = values[..., c["cond_dim"], :]  # [..., D, A, C, n]
        eq = torch.abs(gathered - c["cond_val"][..., None]) < 0.5
        term_ok = eq | ~c["term_mask"][..., None]
        conj = torch.all(term_ok, dim=-2) & c["alt_mask"][..., None]
        return torch.any(conj, dim=-2)

    def sample_prior_fn(self, key, n):
        """Draw n prior configs -> (values [D, n], active [D, n]); keys
        ``[..., 2]`` with leading dims (one key per study) draw ``[..., D,
        n]``, each study's slice bitwise its own key's draw.

        Continuous dims: bounded dims draw uniform in latent space, normal
        dims draw mu + sigma*z; log-space dims exponentiate; quantized dims
        round in natural space.  Categorical dims: Gumbel/categorical over
        the padded prior pmf.  The key tree is the reference's:
        ``split(key, 3)`` into the uniform, normal and categorical keys.
        """
        from .kernels import quantize_nat

        c = self.consts
        D = self.n_dims
        Dc = len(self.cont_idx)
        Dk = len(self.cat_idx)
        ku, kz, kc = R.split(key, 3).unbind(-2)
        values = torch.zeros(key.shape[:-1] + (D, n), dtype=torch.float32, device=self.device)

        if Dc:
            low, high = c["low"][:, None], c["high"][:, None]
            bounded = torch.isfinite(low)
            u = R.uniform(ku, (Dc, n))
            z = R.normal(kz, (Dc, n))
            # the multiply-adds contracted as XLA contracts them
            lat = torch.where(
                bounded,
                R._fma(u, high - low, low),
                R._fma(c["prior_sigma"][:, None], z, c["prior_mu"][:, None]),
            )
            logspace = c["logspace"][:, None]
            nat = torch.where(logspace, torch.exp(lat), lat)
            nat = quantize_nat(nat, c["q"][:, None], low, high, logspace)
            values[..., c["cont_idx"], :] = nat

        if Dk:
            logits = torch.where(
                c["prior_p"] > 0,
                torch.log(torch.clamp(c["prior_p"], min=1e-30)),
                -torch.inf,
            )
            draws = R.categorical(kc, logits[:, None, :], (Dk, n))
            values[..., c["cat_idx"], :] = draws.to(torch.float32) + c["int_low"][:, None]

        return values, self.active_fn(values)

    sample_prior = sample_prior_fn

    def __repr__(self):
        return (
            f"PackedSpace(D={self.n_dims}, cont={len(self.cont_idx)}, "
            f"cat={len(self.cat_idx)}, k_max={self.k_max}, "
            f"conditional={not self.unconditional}, device={self.device})"
        )


def compile_space(space, device=None):
    """Compile an hp-annotated space (pyll graph or pytree of graphs) into
    a :class:`PackedSpace` on ``device`` (None = the card)."""
    expr = as_apply(space)
    hps = expr_to_config(expr)
    labels = sorted(hps)
    if not labels:
        raise CompileError("space has no hyperparameters")
    return PackedSpace(labels, hps, device=resolve_device(device))
