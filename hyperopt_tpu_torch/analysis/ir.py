"""graftir for the port: the program-contract checker (the GL4xx pack)
over traced aten graphs.

graftlint's AST rules (:mod:`.rules`) see source text only; what ends up
INSIDE a program the port launches -- or captures into a CUDA graph and
replays -- is invisible to them: a host read smuggled in through a
helper, an un-dtyped factory that widens to float64, an input written in
place that nobody declared, a megabyte constant baked into the graph.
Every hot program registers a builder with the program registry
(:mod:`hyperopt_tpu_torch.ops.compile`, ``register_program``) that
rebuilds it over small concrete inputs, and this module traces each one
with ``make_fx(tracing_mode="real")`` and audits the aten graph:

* **GL401** host read inside a program: ``Tensor.item``/``tolist``/
  ``numpy``/``cpu``, a tensor's truth or scalar value, or
  ``torch.cuda.synchronize``, recorded by a ``TorchFunctionMode`` around
  the call, and any ``aten._local_scalar_dense`` or ``aten.nonzero``
  node.  A program may DECLARE a deliberate read in its registration's
  ``allowed_syncs`` (the metrics twin's one read of its row is the
  case): an undeclared read fails, a stale declaration fails too, and
  the set is pinned in the manifest (``syncs``, GL406).
* **GL402** float64 creep: the program runs again under
  ``torch.set_default_dtype(torch.float64)`` (the port's counterpart of
  ``enable_x64``), its aten ops counted by a dispatch mode, and every
  float64/complex128 result (of one or more dims) that run adds is
  flagged -- an un-dtyped factory that silently doubles memory and
  compute, or breaks where it meets a float32 buffer.  A float64 step
  with its dtype named (the exact products of ``random._fma``) is wide
  in both runs and passes.
* **GL403** mutation contract: the registration declares the inputs the
  program writes in place (its static carry); the inputs whose
  ``_version`` moved over the traced call must be exactly those.
* **GL404** oversized constant: a closed-over tensor (a ``get_attr``
  node) at or past :data:`CONST_BYTES_MAX` rides along in every graph.
* **GL405** transfer inside a program: ``.to(device)``/``.cuda()``, seen
  by the same ``TorchFunctionMode`` (on a CPU trace a transfer to the
  CPU leaves no node, so the graph alone cannot show it).
* **GL406** contract drift: output shapes and dtypes, the mutated
  inputs, the declared syncs, the aten node count, the FLOPs
  (``torch.utils.flop_counter``'s formulas over the graph) and the
  constant bytes are pinned in ``analysis/program_contracts.json``; a
  drift fails with a field-level diff and is accepted only through
  ``hyperopt-tpu-torch-lint --ir --update-contracts``.

This checker is the one entry point of the port that runs on the CPU by
design: it traces and audits, and executes nothing on a card (the
reference's checker lowers on the CPU backend for the same reason).
Each program runs once eagerly before its trace (the float32 count of
GL402), so the lazy caches a first call fills (a space's constants,
cached scalars) are filled outside the graph.  Everything here is
cwd-independent: finding paths are the registrations' repo-relative
paths, and the default manifest sits in this package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

from .engine import Finding

__all__ = [
    "CONST_BYTES_MAX",
    "DEFAULT_CONTRACTS",
    "IRResult",
    "build_contract",
    "check_capture",
    "check_programs",
    "default_contracts_path",
    "load_contracts",
    "write_contracts",
]

DEFAULT_CONTRACTS = os.path.join("analysis", "program_contracts.json")
CONTRACTS_VERSION = 1

#: GL404 threshold: a closed-over constant at or past this many bytes
#: rides along with every graph.  A space's constants are O(D) -- a few
#: hundred bytes; one MiB means a history-sized tensor was baked in.
CONST_BYTES_MAX = 1 << 20

#: host reads, by the name of the Tensor method (dunder scalar reads by
#: their builtin's name)
_HOST_READS = {
    "item": "item", "tolist": "tolist", "numpy": "numpy", "cpu": "cpu",
    "__bool__": "bool", "__float__": "float", "__int__": "int",
    "__index__": "index",
}
#: graph nodes that read the card from the host
_SYNC_NODES = {"aten::_local_scalar_dense": "_local_scalar_dense", "aten::nonzero": "nonzero"}
_WIDE_DTYPES = ("float64", "complex128")
_CONTRACT_KEYS = ("outputs", "mutated", "syncs", "nodes", "flops", "const_bytes")


@dataclasses.dataclass
class IRResult:
    """What one ``--ir`` run produced (the reporter's input)."""

    findings: list
    programs_checked: int = 0
    contract_drift: int = 0
    contracts_path: str = ""
    updated: bool = False

    @property
    def clean(self):
        return not self.findings


def package_dir():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_contracts_path(root=None):
    """The committed manifest, in this package (``root`` names another
    package directory holding an ``analysis/`` folder)."""
    return os.path.join(root or package_dir(), DEFAULT_CONTRACTS)


def _finding(spec, rule, message):
    f = Finding(path=spec.path, rule=rule, line=spec.line, col=0,
                message=f"[{spec.name}] {message}")
    object.__setattr__(f, "_scope_lines", [])
    return f


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def _val_str(v):
    import torch

    if isinstance(v, torch.Tensor):
        return f"{_dtype_name(v.dtype)}[{','.join(str(int(s)) for s in v.shape)}]"
    return type(v).__name__


def _leaves(tree):
    import torch

    return torch.utils._pytree.tree_leaves(tree)


def _clone_args(args):
    import torch

    return torch.utils._pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, args)


class _Recorder:
    """A ``TorchFunctionMode`` recording the host reads and transfers a
    traced call makes.  A host read runs with the proxy modes off, so
    the trace goes on past it (the value read is baked in, which is the
    hazard the finding names); ``torch.cuda.synchronize`` is recorded by
    a stand-in for the traced call's span."""

    def __init__(self):
        from torch.overrides import TorchFunctionMode

        rec = self
        self.syncs, self.transfers = set(), set()

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = getattr(func, "__name__", "")
                if name in _HOST_READS:
                    rec.syncs.add(_HOST_READS[name])
                    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

                    with disable_proxy_modes_tracing():
                        return func(*args, **kwargs)
                if name == "cuda" or (name == "to" and _names_device(args[1:], kwargs)):
                    rec.transfers.add(f".{name}()")
                return func(*args, **kwargs)

        self.mode = Mode()

    @contextlib.contextmanager
    def armed(self):
        import torch

        real = torch.cuda.synchronize

        def synchronize(*a, **k):
            self.syncs.add("synchronize")

        torch.cuda.synchronize = synchronize
        try:
            with self.mode:
                yield self
        finally:
            torch.cuda.synchronize = real


def _names_device(args, kwargs):
    """Whether a ``Tensor.to`` call names a device (a transfer) rather
    than a dtype only."""
    import torch

    if "device" in kwargs:
        return True
    return any(isinstance(a, (torch.device, str, torch.Tensor))
               or (isinstance(a, int) and not isinstance(a, bool)) for a in args)


def _trace(capture):
    """``(graph_module, recorder, mutated positions, outputs)`` of one
    traced call on fresh clones of the capture's arguments."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    args = _clone_args(capture.args)
    versions = [[t._version for t in _leaves(a) if isinstance(t, torch.Tensor)] for a in args]
    rec = _Recorder()
    kwargs = dict(capture.kwargs)
    outs = []

    def call(*a):
        with rec.armed():
            out = capture.fn(*a, **kwargs)
        outs.append(out)
        return out

    gm = make_fx(call, tracing_mode="real")(*args)
    mutated = [i for i, (a, vs) in enumerate(zip(args, versions))
               if [t._version for t in _leaves(a) if isinstance(t, torch.Tensor)] != vs]
    return gm, rec, mutated, outs[-1]


def _is_wide(v):
    """A float64/complex128 tensor of one or more dims (a 0-dim tensor,
    like a Python scalar, does not promote the dimensioned tensors it
    meets: the counterpart of the reference's exempt weak types)."""
    return _dtype_name(getattr(v, "dtype", "")) in _WIDE_DTYPES and v.dim() > 0


def _wide_ops(capture, x64):
    """op name -> the number of its calls with a wide output
    (:func:`_is_wide`) in one eager call on fresh clones, under a float64
    default dtype when ``x64``; an exception of that call comes back as
    ``{"<raised>": message}``.  The call runs under a dispatch mode, the
    same aten ops the trace records, at a fraction of a trace's cost."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    wide = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(_is_wide(v) for v in _leaves(out) if isinstance(v, torch.Tensor)):
                name = func.name()
                wide[name] = wide.get(name, 0) + 1
            return out

    prev = torch.get_default_dtype()
    if x64:
        torch.set_default_dtype(torch.float64)
    try:
        with Count():
            capture.fn(*_clone_args(capture.args), **capture.kwargs)
    except Exception as e:  # a program that cannot run at all widens somewhere
        return {"<raised>": f"{type(e).__name__}: {e}"}
    finally:
        torch.set_default_dtype(prev)
    return wide


def _call_nodes(gm):
    return [n for n in gm.graph.nodes if n.op == "call_function"]


def _op_name(node):
    t = node.target
    name = getattr(t, "name", None)
    return name() if callable(name) else str(t)


def _flops(gm):
    """FLOPs of the graph by ``torch.utils.flop_counter``'s formulas,
    from each node's recorded shapes (nothing runs)."""
    import torch
    from torch.utils.flop_counter import flop_registry

    total = 0
    for n in _call_nodes(gm):
        f = flop_registry.get(getattr(n.target, "overloadpacket", None))
        if f is None:
            continue
        val = lambda a: a.meta.get("val") if isinstance(a, torch.fx.Node) else a  # noqa: E731
        args = torch.utils._pytree.tree_map(val, n.args)
        kwargs = torch.utils._pytree.tree_map(val, n.kwargs)
        total += int(f(*args, out_val=n.meta.get("val"), **kwargs))
    return total


def _constants(gm):
    import torch

    out = []
    for n in gm.graph.nodes:
        if n.op == "get_attr":
            t = getattr(gm, n.target, None)
            if isinstance(t, torch.Tensor):
                out.append((n.target, t))
    return out


def build_contract(capture):
    """Trace one :class:`~hyperopt_tpu_torch.ops.compile.ProgramCapture`
    on the CPU; returns ``(traced, widened, contract)``: ``traced`` is
    ``(graph_module, recorder, mutated, outputs)``, ``widened`` the ops
    (and their counts) a float64 default dtype widens (None when the
    registration skips GL402), ``contract`` the manifest row."""
    import torch

    with torch.no_grad():
        # the first call fills the lazy caches (outside the graph) and
        # counts the wide ops of the float32 default
        base = _wide_ops(capture, x64=False)
        if "<raised>" in base:
            raise RuntimeError(f"the program does not run: {base['<raised>']}")
        traced = _trace(capture)
        widened = None
        if capture.x64_check:
            widened = {op: k - base.get(op, 0)
                       for op, k in _wide_ops(capture, x64=True).items()
                       if op == "<raised>" or k > base.get(op, 0)}
    gm, rec, mutated, out = traced
    nodes = _call_nodes(gm)
    syncs = set(rec.syncs) | {_SYNC_NODES[_op_name(n).split(".")[0]] for n in nodes
                              if _op_name(n).split(".")[0] in _SYNC_NODES}
    contract = {
        "outputs": [_val_str(v) for v in _leaves(out)],
        "mutated": list(mutated),
        "syncs": sorted(syncs),
        "nodes": len(nodes),
        "flops": _flops(gm),
        "const_bytes": int(sum(t.numel() * t.element_size() for _, t in _constants(gm))),
    }
    return traced, widened, contract


def check_capture(spec, capture, stored=None, const_bytes_max=None):
    """Run the GL4xx pack over one registered program.

    Returns ``(findings, contract)``.  ``stored`` is the committed
    contract row to diff against (GL406); ``None`` skips the drift check
    (the caller handles missing manifests itself).
    """
    limit = CONST_BYTES_MAX if const_bytes_max is None else const_bytes_max
    findings = []
    traced, widened, contract = build_contract(capture)
    gm, rec, mutated, _ = traced

    # GL401: host reads have no place inside a hot program -- unless the
    # registration DECLARES them (allowed_syncs, pinned in the manifest)
    allowed = frozenset(capture.allowed_syncs or ())
    found = set(contract["syncs"])
    for name in sorted(found - allowed):
        findings.append(_finding(
            spec, "GL401",
            f"host read {name!r} inside a hot program: a launch sequence "
            "now waits for the card (and a captured graph bakes the value "
            "read at capture); keep it on the card, or -- if the read is "
            "deliberate -- declare it in the registration's allowed_syncs",
        ))
    for name in sorted(allowed - found):
        findings.append(_finding(
            spec, "GL401",
            f"allowed_syncs declares {name!r} but the traced program makes "
            "no such read: remove the stale declaration (the allowlist is "
            "a contract, not a mute button)",
        ))

    # GL405: a transfer inside the program (placement is the caller's)
    for name in sorted(rec.transfers):
        findings.append(_finding(
            spec, "GL405",
            f"device transfer {name} inside the program: placement belongs "
            "to the caller (the resident history, device_arrays), not the "
            "program body",
        ))

    # GL402: float64/complex128 ops that a float64 default dtype adds
    # (a deliberate float64 step, dtype named, is wide in both runs)
    for op, k in sorted((widened or {}).items()):
        if op == "<raised>":
            findings.append(_finding(
                spec, "GL402",
                f"the program fails under torch.set_default_dtype(torch.float64) "
                f"({k}): an un-dtyped factory or scalar widens and meets a "
                "float32 tensor; pin dtype=torch.float32 at the producing site",
            ))
            continue
        findings.append(_finding(
            spec, "GL402",
            f"{k} {op!r} call(s) widen to a 64-bit float under "
            "torch.set_default_dtype(torch.float64): an un-dtyped factory "
            "or scalar is widening silently; pin dtype=torch.float32 at the "
            "producing site",
        ))

    # GL404: oversized closed-over constants
    for name, t in _constants(gm):
        nbytes = t.numel() * t.element_size()
        if nbytes >= limit:
            findings.append(_finding(
                spec, "GL404",
                f"closed-over constant {name} {_val_str(t)} ({nbytes} bytes "
                f">= {limit}) is baked into the program and rides along "
                "with every graph; pass it as an argument (device-resident) "
                "instead",
            ))

    # GL403: the declared static carry vs the inputs actually written
    declared = sorted(int(i) for i in capture.mutates)
    if declared != list(mutated):
        findings.append(_finding(
            spec, "GL403",
            f"mutation contract mismatch: the registration declares inputs "
            f"{declared} written in place, the traced call wrote {list(mutated)} "
            "-- a caller that does not expect the write reads a changed "
            "buffer, one that expects it reads a stale one",
        ))

    if stored is not None:
        for line in _diff_contract(stored, contract):
            findings.append(_finding(spec, "GL406", line))
    return findings, contract


def _diff_contract(stored, fresh):
    """Field-level readable diff lines, empty when identical."""
    out = []
    for key in _CONTRACT_KEYS:
        a, b = stored.get(key), fresh.get(key)
        if a != b:
            out.append(
                f"contract drift in {key!r}: committed {a!r} != traced {b!r} "
                "(accept deliberate changes with `hyperopt-tpu-torch-lint "
                "--ir --update-contracts`)"
            )
    return out


def load_contracts(path):
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    if payload.get("version") != CONTRACTS_VERSION:
        raise ValueError(
            f"contracts manifest {path!r} has version {payload.get('version')!r}; "
            f"this checker reads version {CONTRACTS_VERSION}"
        )
    return payload


def write_contracts(path, programs, params):
    payload = {
        "version": CONTRACTS_VERSION,
        "params": {
            "n_obs": params.n_obs,
            "batch": params.batch,
            "k_spec": params.k_spec,
            "n_studies": params.n_studies,
            "space_dims": params.space.n_dims,
        },
        "programs": programs,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


#: per-process memo of the default-parameterization results (name ->
#: (findings without GL406, contract)): source cannot change under a
#: live process, and tracing every program costs a minute, so repeated
#: calls in one process diff only the manifest
_DEFAULT_TRACE_CACHE = {}


def _trace_once(name, spec, params, cache):
    if cache is not None and name in cache:
        fs, contract = cache[name]
        return list(fs), contract
    fs, contract = check_capture(spec, spec.build(params))
    if cache is not None:
        cache[name] = (tuple(fs), contract)
    return list(fs), contract


def check_programs(contracts_path=None, update=False, params=None, names=None):
    """Run the GL4xx pack over the registered programs (``names``: a
    subset, by registry name; the manifest's other rows are then not
    checked for staleness).

    ``contracts_path`` defaults to the committed manifest.
    ``update=True`` re-pins the manifest instead of diffing (GL401-405
    still report).  Returns :class:`IRResult`.
    """
    from ..ops.compile import default_program_params, registered_programs

    path = contracts_path or default_contracts_path()
    specs = registered_programs()
    if names is not None:
        missing = sorted(set(names) - set(specs))
        if missing:
            raise ValueError(f"no registered program named {missing}")
        specs = {n: specs[n] for n in specs if n in set(names)}
    cache = None
    if params is None:
        params = default_program_params()
        cache = _DEFAULT_TRACE_CACHE

    manifest = {}
    manifest_missing = not os.path.exists(path)
    if not manifest_missing:
        manifest = load_contracts(path).get("programs", {})

    findings = []
    fresh = {}
    drift = 0
    for name, spec in specs.items():
        fs, contract = _trace_once(name, spec, params, cache)
        fresh[name] = contract
        stored = None if update else manifest.get(name)
        if stored is not None:
            fs.extend(_finding(spec, "GL406", line)
                      for line in _diff_contract(stored, contract))
        if not update and stored is None:
            fs.append(_finding(
                spec, "GL406",
                "no committed contract" + (" (manifest missing)" if manifest_missing else "")
                + "; pin it with `hyperopt-tpu-torch-lint --ir --update-contracts`",
            ))
        if any(f.rule == "GL406" for f in fs):
            drift += 1
        findings.extend(fs)

    if names is None and not update:
        # stale manifest rows: a program that no longer registers
        for name in sorted(set(manifest) - set(specs)):
            f = Finding(
                path=os.path.basename(path),
                rule="GL406", line=1, col=0,
                message=f"[{name}] manifest pins a program no longer in the registry; "
                "refresh with `hyperopt-tpu-torch-lint --ir --update-contracts`",
            )
            object.__setattr__(f, "_scope_lines", [])
            findings.append(f)
            drift += 1

    if update:
        programs = fresh if names is None else {**manifest, **fresh}
        write_contracts(path, programs, params)

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return IRResult(
        findings=findings,
        programs_checked=len(specs),
        contract_drift=drift,
        contracts_path=path,
        updated=bool(update),
    )
