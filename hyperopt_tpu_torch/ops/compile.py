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

import dataclasses
import functools
import importlib
import os

import numpy as np
import torch

from .. import random as R
from ..exceptions import CompileError
from ..pyll.base import as_apply
from ..pyll_utils import expr_to_config
from ..utils import resolve_device

__all__ = [
    "PackedSpace", "ProgramCapture", "ProgramParams", "ProgramSpec", "compile_space",
    "program_family", "reference_space", "register_program", "registered_programs",
]

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


# ---------------------------------------------------------------------------
# The program registry: the programs the port launches on its hot paths
# ---------------------------------------------------------------------------
#
# graftlint (analysis/rules.py) sees source text only; what ends up
# inside a program -- a host read smuggled in through a helper, an
# un-dtyped factory that widens to float64, an input written in place
# that nobody declared, a megabyte constant baked into a captured graph
# -- is invisible to it.  Every hot program registers a builder here
# that rebuilds it on the CPU over small concrete inputs, so the program
# checker (analysis/ir.py, ``hyperopt-tpu-torch-lint --ir``) can trace
# each one to an aten graph and audit it.  The contracts are pinned in
# ``analysis/program_contracts.json``.


def program_family(fn):
    """The program-FAMILY identity of a callable: ``module:qualname``
    with any ``<locals>`` suffix stripped, so every closure a builder
    makes maps back to the builder that owns the family
    (``build_suggest_fn.<locals>.fn_factorized`` ->
    ``hyperopt_tpu_torch.tpe:build_suggest_fn``).  ``functools.partial``
    wrappers and bound methods resolve to the wrapped function.  The
    registry-completeness test records these for the steps handed to
    ``capture_graph`` and the closures the ``build_*_fn`` builders
    return, and asserts each family is claimed by a registration."""
    while isinstance(fn, functools.partial):
        fn = fn.func
    fn = getattr(fn, "__func__", fn)
    fn = getattr(fn, "__wrapped__", fn)
    mod = getattr(fn, "__module__", None) or "<unknown>"
    qn = getattr(fn, "__qualname__", None) or getattr(fn, "__name__", "<anonymous>")
    return f"{mod}:{qn.split('.<locals>')[0]}"


@dataclasses.dataclass
class ProgramParams:
    """The knobs every registered builder is parameterized by: the
    compiled reference space plus history width, suggestion batch,
    speculative draw width and study-axis width.  The helpers build the
    inputs the history-shaped programs share as concrete tensors on the
    space's device (the checker traces in real mode, on the CPU): half the history told with prior
    draws and their squared-norm losses, the rest empty, so the traced
    fits see both occupied and free slots."""

    space: PackedSpace
    n_obs: int = 128
    batch: int = 4
    k_spec: int = 8
    #: the study-axis width of the serve engine's stacked programs (a
    #: small slot capacity; the family's graphs grow with it, one width
    #: pins the family)
    n_studies: int = 4

    @property
    def device(self):
        return self.space.device

    @functools.cached_property
    def host_space(self):
        """The space on the CPU: the inputs are drawn there and moved to
        :attr:`device`, so a program's inputs on the card are bitwise its
        inputs on the CPU."""
        if self.space.device.type == "cpu":
            return self.space
        return PackedSpace(self.space.labels, self.space.hps)

    def key_spec(self, seed=0):
        from .. import random as R

        return R.key(seed, device=self.device)

    def keys_spec(self, n=None):
        """[S, 2] keys, one per study slot."""
        from .. import random as R

        s = self.n_studies if n is None else int(n)
        return R.split(R.key(0, device=self.device), s)

    def history_specs(self, seed=1):
        """(values [D, N], active [D, N], losses [N], valid [N]): the
        first ``N // 2`` slots told."""
        from .. import random as R

        N, n = self.n_obs, self.n_obs // 2
        v, a = self.host_space.sample_prior_fn(R.key(seed), N)
        told = torch.arange(N) < n
        values = torch.where(told, v, 0.0)
        active = a & told
        losses = torch.where(told, torch.where(active, values, 0.0).square().sum(0), 0.0)
        return tuple(t.to(self.device) for t in (values, active, losses, told))

    def delta_specs(self):
        """One O(D) tell into the first free slot, as the resident history
        stages it on the host: ``{"vcol": [D] float32, "acol": [D] bool,
        "loss": float, "idx": int}`` (numpy columns; a program uploads
        them)."""
        from .. import random as R

        v, a = self.host_space.sample_prior_fn(R.key(2), 1)
        vcol = v[:, 0].numpy().copy()
        acol = a[:, 0].numpy().copy()
        loss = float(np.where(acol, vcol, np.float32(0.0)).astype(np.float32).__pow__(2).sum())
        return {"vcol": vcol, "acol": acol, "loss": loss, "idx": self.n_obs // 2}

    def study_history_specs(self, n=None):
        """The four history tensors with a leading study axis (the
        :class:`hyperopt_tpu_torch.serve.batched.StudyBatchState`
        layout), study ``i`` told from seed ``i + 1``."""
        s = self.n_studies if n is None else int(n)
        hs = [self.history_specs(seed=i + 1) for i in range(s)]
        return tuple(torch.stack([h[f] for h in hs]) for f in range(4))

    def study_delta_specs(self, n=None):
        """Per-slot O(D) tell deltas and the apply mask: (vcol [S, D],
        acol [S, D], loss [S], idx [S], apply [S]); every other slot
        applies."""
        s = self.n_studies if n is None else int(n)
        d = self.delta_specs()
        dev = self.device
        return (torch.from_numpy(d["vcol"]).to(dev).expand(s, -1).clone(),
                torch.from_numpy(d["acol"]).to(dev).expand(s, -1).clone(),
                torch.full((s,), d["loss"], dtype=torch.float32, device=dev),
                torch.full((s,), d["idx"], dtype=torch.int64, device=dev),
                torch.arange(s, device=dev) % 2 == 0)

    def study_mask_spec(self, n=None):
        """A [S] bool per-slot mask (warm/active flags): every slot set."""
        s = self.n_studies if n is None else int(n)
        return torch.ones(s, dtype=torch.bool, device=self.device)


@dataclasses.dataclass
class ProgramCapture:
    """What a registered builder hands the program checker: the program
    (a callable over tensors or pytrees of tensors), the concrete CPU
    arguments to trace it over, static keyword arguments, and its
    DECLARED contracts."""

    fn: object
    args: tuple
    kwargs: dict = dataclasses.field(default_factory=dict)
    #: the argument positions the program writes in place: its static
    #: carry (GL403 compares them with the inputs whose ``_version``
    #: moved over the traced call)
    mutates: tuple = ()
    #: GL401's explicit escape hatch: the host reads this program
    #: DECLARES it makes (``"cpu"``, ``"tolist"``, ...).  An undeclared
    #: read is a finding, and so is a declared one the program no longer
    #: makes; the set is pinned in the manifest (GL406 ``syncs``)
    allowed_syncs: tuple = ()
    #: run the float64-default re-trace (GL402)?  A program that shares
    #: its closure with another registration (same build, another batch)
    #: may skip the duplicate re-trace
    x64_check: bool = True


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    name: str
    build: object          # build(params: ProgramParams) -> ProgramCapture
    families: tuple        # program_family() keys this spec covers
    path: str              # repo-relative source file of the registration
    line: int


PROGRAM_REGISTRY = {}

#: modules that own registered programs; imported (once) by
#: :func:`registered_programs` so their registrations run.  A new
#: program starts by adding its module here and a ``@register_program``
#: builder there.
_PROGRAM_MODULES = (
    "hyperopt_tpu_torch.ops.compile",
    "hyperopt_tpu_torch.torch_trials",
    "hyperopt_tpu_torch.tpe",
    "hyperopt_tpu_torch.anneal",
    "hyperopt_tpu_torch.atpe",
    "hyperopt_tpu_torch.device_loop",
    "hyperopt_tpu_torch.parallel.sharded",
    "hyperopt_tpu_torch.ops.gmm_scores",
    "hyperopt_tpu_torch.serve.batched",
    "hyperopt_tpu_torch.pbt",
    "hyperopt_tpu_torch.hyperband",
    "hyperopt_tpu_torch.obs.device",
)


def _rel_source_path(filename):
    """Repo-relative posix path of a registration site (anchored at the
    package's parent, never the process cwd)."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        rel = os.path.relpath(os.path.abspath(filename), start=pkg_root)
    except ValueError:  # another drive (windows)
        rel = filename
    return rel.replace(os.sep, "/")


def register_program(name, families=()):
    """Decorator registering a hot program.

    The decorated ``build(params)`` returns a :class:`ProgramCapture` on
    the CPU; it may build closures and small inputs but runs nothing on
    a card.  ``families`` lists the :func:`program_family` keys of every
    callable this program stands for, the completeness contract the
    registry test enforces."""

    def deco(build):
        code = getattr(build, "__code__", None)
        spec = ProgramSpec(
            name=name, build=build, families=tuple(families),
            path=_rel_source_path(code.co_filename if code else __file__),
            line=code.co_firstlineno if code else 1,
        )
        if name in PROGRAM_REGISTRY:
            raise ValueError(f"program {name!r} registered twice")
        PROGRAM_REGISTRY[name] = spec
        return build

    return deco


def registered_programs():
    """Import every program-owning module and return the registry (name
    -> :class:`ProgramSpec`, insertion-ordered)."""
    for mod in _PROGRAM_MODULES:
        importlib.import_module(mod)
    return dict(PROGRAM_REGISTRY)


def reference_space():
    """The registry's canonical mixed space (the reference's): two
    continuous families (bounded + log), one quantized, one categorical
    -- every kernel family appears in the traced programs."""
    from .. import hp

    return {
        "x": hp.uniform("x", -5.0, 5.0),
        "lr": hp.loguniform("lr", -6.0, 0.0),
        "width": hp.quniform("width", 16.0, 256.0, 16.0),
        "unit": hp.choice("unit", [0, 1, 2]),
    }


def default_program_params(n_obs=128, batch=4, k_spec=8, device="cpu"):
    """The parameterization the committed contracts are pinned at (on
    the CPU; ``device="cuda"`` builds the same programs on the card)."""
    ps = compile_space(reference_space(), device=device)
    return ProgramParams(space=ps, n_obs=n_obs, batch=batch, k_spec=k_spec)


@register_program(
    "compile.sample_prior",
    families=("hyperopt_tpu_torch.ops.compile:PackedSpace.sample_prior_fn",),
)
def _registry_sample_prior(p):
    """The startup-regime ask: every suggest path below
    ``n_startup_jobs`` serves prior draws through this program."""
    return ProgramCapture(fn=p.space.sample_prior_fn, args=(p.key_spec(),),
                          kwargs={"n": p.batch})
