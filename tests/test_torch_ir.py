"""The port's program-contract pack (GL4xx, ``hyperopt-tpu-torch-lint
--ir``) and its program registry.

* each of GL401-GL406 trips on a small hand-built bad program and stays
  quiet on its good twin;
* ``--update-contracts`` round-trips, the CLI's exit codes and JSON, and
  findings identical from any cwd (the reference's suite,
  ``tests/test_graftir.py``, on a registry of small programs);
* the committed manifest covers the registry (no tracing), and every
  program family the entry points reach is claimed by a registration;
* the output shapes and dtypes of every port program with a reference
  twin of the same signature equal the reference's committed
  ``program_contracts.json``;
* the four main-path programs traced against the committed manifest,
  once for the module.  The whole 26-program gate (a minute or two of
  tracing) runs under ``-m slow``.
"""

import dataclasses
import json
import os
import sys

import pytest
import torch

from hyperopt_tpu_torch import device_loop
from hyperopt_tpu_torch.analysis import ir
from hyperopt_tpu_torch.analysis.cli import main
from hyperopt_tpu_torch.ops import compile as C
from hyperopt_tpu_torch.ops.compile import (
    ProgramCapture, ProgramSpec, default_program_params, program_family, registered_programs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_CONTRACTS = os.path.join(REPO, "program_contracts.json")
MAIN_PROGRAMS = ("compile.sample_prior", "tpe.suggest", "tpe.fused_tell_ask",
                 "gmm_scores.gmm_llr")

#: port program -> its reference twin of the same signature
TWINS = {
    "compile.sample_prior": "compile.sample_prior",
    "torch_trials.apply_delta": "jax_trials.apply_delta",
    "tpe.suggest": "tpe_jax.suggest",
    "tpe.fused_tell_ask": "tpe_jax.fused_tell_ask",
    "tpe.speculative_redraw": "tpe_jax.speculative_redraw",
    "anneal.suggest": "anneal_jax.suggest",
    "anneal.fused_tell_ask": "anneal_jax.fused_tell_ask",
    "atpe.device_step": "atpe_jax.device_step",
    "sharded.suggest": "sharded.suggest",
    "serve.batched_step": "serve.batched_step",
    "serve.batched_anneal_step": "serve.batched_anneal_step",
    "serve.batched_apply_delta": "serve.batched_apply_delta",
    "serve.guard_finite_check": "serve.guard_finite_check",
}
#: (port output, reference output) pairs that differ on purpose, with why:
#: none among the twins above -- the port's int64 counters and keys sit
#: in the compiled loop's carry, whose programs have another signature
DTYPE_DIFFERENCES = {}
#: port programs with no twin of the same signature, and why
NO_TWIN = {
    "gmm_scores.gmm_llr": "candidates [B, Dg, S] against the Pallas kernel's rows [R, S]",
    "device_loop.step_prior": "one captured step over the carry, not the whole scan",
    "device_loop.step_model": "one captured step over the carry, not the whole scan",
    "device_loop.chunk_summary": "the chunk boundary's row, not the chunk's scan",
    "device_loop.train_step": "one captured step over the carry, not the whole scan",
    "device_loop.asha_bracket_prior": "one captured bracket, not the whole scan",
    "device_loop.asha_bracket_model": "one captured bracket, not the whole scan",
    "device_loop.asha_chunk_summary": "the chunk boundary's row, not the chunk's scan",
    "serve.batched_step_mesh": "the state as per-shard tensors (ShardedBatchState)",
    "serve.batched_delta_mesh": "the state as per-shard tensors (ShardedBatchState)",
    "pbt.sharded_round": "one captured round over static tensors, not the schedule",
    "hyperband.sha_rung_mesh": "one captured rung over static tensors",
    "obs.device_metrics": "one host read of the row, not an io_callback",
}


def _spec(name="tiny.program"):
    return ProgramSpec(name=name, build=None, families=(), path="tests/test_torch_ir.py",
                       line=1)


def _check(fn, args=(), **kw):
    findings, contract = ir.check_capture(_spec(), ProgramCapture(fn=fn, args=args, **kw))
    return sorted({f.rule for f in findings}), contract


X = torch.linspace(-1.0, 1.0, 8)
BIG = torch.zeros(ir.CONST_BYTES_MAX // 4 + 1)
SMALL = torch.ones(4)


# -- GL401-GL406 on hand-built programs ---------------------------------------

@pytest.mark.parametrize("rule,bad,good", [
    ("GL401",
     dict(fn=lambda x: x * x.sum().item(), args=(X,)),
     dict(fn=lambda x: x * x.sum(), args=(X,))),
    ("GL401",  # a declared read the program no longer makes is stale
     dict(fn=lambda x: x * x.sum(), args=(X,), allowed_syncs=("item",)),
     dict(fn=lambda x: x * x.sum().item(), args=(X,), allowed_syncs=("item",))),
    ("GL401",  # a tensor's truth value is a host read too
     dict(fn=lambda x: x * 2 if bool(x.sum() > 0) else x, args=(X,)),
     dict(fn=lambda x: torch.where(x.sum() > 0, x * 2, x), args=(X,))),
    ("GL402",
     dict(fn=lambda x: x + torch.ones(x.shape), args=(X,)),
     dict(fn=lambda x: x + torch.ones(x.shape, dtype=x.dtype), args=(X,))),
    ("GL403",
     dict(fn=lambda x, y: x + y.add_(1.0), args=(X, SMALL.repeat(2))),
     dict(fn=lambda x, y: x + y.add_(1.0), args=(X, SMALL.repeat(2)), mutates=(1,))),
    ("GL404",
     dict(fn=lambda x: x + BIG[:8], args=(X,)),
     dict(fn=lambda x: x + SMALL.repeat(2), args=(X,))),
    ("GL405",
     dict(fn=lambda x: x.to("cpu") * 2, args=(X,)),
     dict(fn=lambda x: x.to(torch.float32) * 2, args=(X,))),
], ids=["GL401", "GL401_stale", "GL401_truth", "GL402", "GL403", "GL404", "GL405"])
def test_program_rule_bad_and_good(rule, bad, good):
    rules, _ = _check(**bad)
    assert rules == [rule]
    rules, _ = _check(**good)
    assert rules == []


def test_gl402_passes_a_named_float64_step():
    """A float64 step with its dtype named is no creep: it is wide in both
    runs (``random._fma``'s exact products)."""
    rules, contract = _check(lambda x: (x.double() * x + 1.0).float(), args=(X,))
    assert rules == [] and contract["outputs"] == ["float32[8]"]


def test_gl402_reports_a_program_a_float64_default_breaks():
    def fn(x):
        out = torch.zeros_like(x)
        out[:4] = torch.linspace(0.0, 1.0, 4)  # float64 under the default: raises
        return out

    rules, _ = _check(fn, args=(X,))
    assert rules == ["GL402"]


def test_gl406_contract_drift_bad_and_good():
    capture = ProgramCapture(fn=lambda x: (x * 2, x > 0), args=(X,))
    _, fresh = ir.check_capture(_spec(), capture)
    assert fresh["outputs"] == ["float32[8]", "bool[8]"] and fresh["mutated"] == []
    assert fresh["nodes"] == 2 and fresh["const_bytes"] == 0
    good, _ = ir.check_capture(_spec(), capture, stored=dict(fresh))
    assert good == []
    for key, value in (("outputs", ["float32[9]", "bool[8]"]), ("nodes", 3),
                       ("flops", 1), ("const_bytes", 4), ("syncs", ["item"]),
                       ("mutated", [0])):
        bad, _ = ir.check_capture(_spec(), capture, stored=dict(fresh, **{key: value}))
        assert [f.rule for f in bad] == ["GL406"] and repr(key) in bad[0].message


def test_flops_come_from_the_graph():
    w = torch.ones(4, 8)
    _, contract = _check(lambda x: w @ x, args=(X.reshape(8, 1),))
    assert contract["flops"] == 2 * 4 * 8


# -- the CLI over a registry of small programs ---------------------------------

def _tiny_registry(scale=2.0):
    def build(p):
        return ProgramCapture(fn=lambda x: x * scale, args=(torch.ones(3),))

    return {"tiny.scale": ProgramSpec(name="tiny.scale", build=build,
                                      families=("tests:tiny",),
                                      path="tests/test_torch_ir.py", line=1)}


@pytest.fixture
def tiny(monkeypatch):
    """The CLI's --ir over a registry of one small program."""
    monkeypatch.setattr(ir, "_DEFAULT_TRACE_CACHE", {})
    monkeypatch.setattr(C, "registered_programs", _tiny_registry)
    return monkeypatch


def _run(args, capsys):
    rc = main(args)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_ir_exit_codes_and_json(tiny, tmp_path, capsys):
    path = str(tmp_path / "contracts.json")
    rc, out, err = _run(["--ir", "--contracts", path], capsys)
    assert rc == 1 and "GL406" in out and "manifest missing" in out
    rc, _, err = _run(["--ir", "--update-contracts", "--contracts", path], capsys)
    assert rc == 0 and "pinned 1 program contract(s)" in err
    payload = json.load(open(path))
    assert payload["version"] == 1 and list(payload["programs"]) == ["tiny.scale"]
    assert payload["programs"]["tiny.scale"]["outputs"] == ["float32[3]"]
    rc, out, _ = _run(["--ir", "--contracts", path, "--format", "json"], capsys)
    summary = json.loads(out)["summary"]
    assert rc == 0 and summary["total"] == 0 and summary["programs_checked"] == 1
    assert summary["contract_drift"] == 0 and summary["updated"] is False
    # a drifted program: exit 1, one field-level GL406
    tiny.setattr(ir, "_DEFAULT_TRACE_CACHE", {})
    tiny.setattr(C, "registered_programs", lambda: {
        "tiny.scale": dataclasses.replace(_tiny_registry()["tiny.scale"], build=lambda p:
                                          ProgramCapture(fn=lambda x: (x * 2.0).sum(),
                                                         args=(torch.ones(3),)))})
    rc, out, _ = _run(["--ir", "--contracts", path, "--format", "json"], capsys)
    findings = json.loads(out)["findings"]
    assert rc == 1 and {f["rule"] for f in findings} == {"GL406"}
    assert any("'outputs'" in f["message"] for f in findings)
    # a manifest of another version, and one that does not parse: exit 2
    (tmp_path / "v2.json").write_text(json.dumps({"version": 2, "programs": {}}))
    assert _run(["--ir", "--contracts", str(tmp_path / "v2.json")], capsys)[0] == 2
    (tmp_path / "bad.json").write_text("{not json")
    assert _run(["--ir", "--contracts", str(tmp_path / "bad.json")], capsys)[0] == 2


def test_update_contracts_round_trips(tiny, tmp_path, capsys):
    path = str(tmp_path / "contracts.json")
    res = ir.check_programs(contracts_path=path, update=True)
    assert res.updated and res.clean
    first = open(path).read()
    assert ir.check_programs(contracts_path=path).clean
    ir.check_programs(contracts_path=path, update=True)
    assert open(path).read() == first
    # a stale row (a program no longer registered) is drift
    payload = json.loads(first)
    payload["programs"]["gone.program"] = payload["programs"]["tiny.scale"]
    with open(path, "w") as f:
        json.dump(payload, f)
    res = ir.check_programs(contracts_path=path)
    assert [f.rule for f in res.findings] == ["GL406"] and "gone.program" in res.findings[0].message


def test_cli_findings_identical_from_any_cwd(tiny, tmp_path, capsys):
    path = str(tmp_path / "contracts.json")
    outs = []
    for cwd in (REPO, tmp_path, os.path.dirname(REPO)):
        tiny.chdir(cwd)
        rc, out, _ = _run(["--ir", "--contracts", path, "--format", "json"], capsys)
        outs.append((rc, out))
    assert outs[0][0] == 1 and len(set(outs)) == 1
    assert ir.default_contracts_path() == os.path.join(
        REPO, "hyperopt_tpu_torch", "analysis", "program_contracts.json")


# -- the registry and the committed manifest (no tracing) ---------------------

def test_manifest_covers_the_registry():
    specs = registered_programs()
    payload = ir.load_contracts(ir.default_contracts_path())
    assert sorted(payload["programs"]) == sorted(specs)
    assert len(specs) == 26
    assert len({spec.path for spec in specs.values()}) == 12
    p = default_program_params()
    assert payload["params"] == {"n_obs": p.n_obs, "batch": p.batch, "k_spec": p.k_spec,
                                 "n_studies": p.n_studies, "space_dims": p.space.n_dims}
    for name, spec in specs.items():
        assert spec.families and os.path.exists(os.path.join(REPO, spec.path)), name
        assert set(payload["programs"][name]) == set(ir._CONTRACT_KEYS), name


def test_outputs_equal_the_reference_manifest_where_signatures_match():
    port = ir.load_contracts(ir.default_contracts_path())["programs"]
    with open(REFERENCE_CONTRACTS) as f:
        ref = json.load(f)["programs"]
    assert sorted(set(TWINS) | set(NO_TWIN)) == sorted(port)
    assert not set(TWINS) & set(NO_TWIN)
    for name, twin in TWINS.items():
        want = [DTYPE_DIFFERENCES.get((name, i), o) for i, o in enumerate(ref[twin]["outputs"])]
        assert port[name]["outputs"] == want, (name, twin)


def _drive_entry_points():
    """fmin, compile_fmin and the serve engine on the CPU, small."""
    import numpy as np

    import hyperopt_tpu_torch as H
    from hyperopt_tpu_torch.serve.service import SuggestService

    space = C.reference_space()

    def loss(cfg):
        return float((cfg["x"] - 1.0) ** 2 + abs(np.log(cfg["lr"]) + 2.0))

    H.fmin(loss, space, algo=H.tpe.suggest, max_evals=22, trials=H.Trials(),
           rstate=np.random.default_rng(0), device="cpu")
    device_loop.compile_fmin(lambda cfg: (cfg["x"] - 1.0) ** 2, space, max_evals=4,
                             batch_size=2, n_startup_jobs=2, n_EI_candidates=8,
                             chunk_size=2, device="cpu")(seed=0)
    svc = SuggestService(space, max_batch=4, background=False, n_startup_jobs=1,
                         device="cpu", n_cand=8, n_cand_cat=8)
    try:
        handles = [svc.create_study(f"s{i}", seed=i) for i in range(2)]
        for _ in range(3):
            futs = [(h, h.ask_async()) for h in handles]
            svc.pump()
            for h, fut in futs:
                tid, vals = fut.result(timeout=10)
                h.tell(tid, loss(vals))
    finally:
        svc.shutdown()


def test_every_family_the_entry_points_reach_is_claimed(monkeypatch):
    """Record the program family of every closure a ``build_*_fn`` builder
    returns and of every step the compiled loop hands ``capture_graph``
    (on the CPU nothing is captured: each program's steps go through a
    recorder once), while driving fmin, compile_fmin and the serve
    engine; each must be claimed by a registration."""
    seen = set()

    def profile(frame, event, arg):
        code = frame.f_code
        if (event == "return" and code.co_name.startswith("build_")
                and code.co_name.endswith("_fn") and callable(arg)
                and frame.f_globals.get("__name__", "").startswith("hyperopt_tpu_torch.")):
            seen.add(program_family(arg))

    real_init = device_loop._Program.__init__

    def recorded(step, device):
        seen.add(program_family(step))
        step()
        return None

    def init(self, loop, n_seeds):
        real_init(self, loop, n_seeds)
        with monkeypatch.context() as m:
            m.setattr(device_loop, "capture_graph", recorded)
            for regime in loop.regimes:
                self._capture(regime)
        self.graphs.clear()

    monkeypatch.setattr(device_loop._Program, "__init__", init)
    sys.setprofile(profile)
    try:
        _drive_entry_points()
    finally:
        sys.setprofile(None)
    claimed = {f for spec in registered_programs().values() for f in spec.families}
    assert "hyperopt_tpu_torch.device_loop:_Program._capture" in seen
    assert "hyperopt_tpu_torch.tpe:build_suggest_fn" in seen
    assert "hyperopt_tpu_torch.serve.batched:build_batched_step_fn" in seen
    assert seen <= claimed, sorted(seen - claimed)


# -- the main-path programs against the committed manifest --------------------

@pytest.fixture(scope="module")
def main_path():
    return ir.check_programs(names=MAIN_PROGRAMS)


def test_main_path_programs_match_the_manifest(main_path):
    assert main_path.programs_checked == len(MAIN_PROGRAMS)
    assert main_path.findings == [], [f.to_dict() for f in main_path.findings]
    assert main_path.contract_drift == 0


@pytest.mark.slow
def test_every_registered_program_matches_the_manifest():
    res = ir.check_programs()
    assert res.programs_checked == 26
    assert res.findings == [], [f.to_dict() for f in res.findings]
