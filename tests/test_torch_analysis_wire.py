"""The port's wire pack (GL6xx) held against the reference's on the
reference's fixture corpus, and its mutation kill-checks on the port's
own ``serve/service.py`` and ``client.py``.

Each fixture is a one-file universe fed to both packages' ``analyze``
wearing the same role hats; the findings must match (rule, line, col)
for (rule, line, col).  The mutation checks feed the port's
``check_wire`` the real files with ONE seam textually broken -- no
server is started, no test is executed.
"""

import os

import pytest

from hyperopt_tpu.analysis.wire import analyze as ref_analyze
from hyperopt_tpu_torch.analysis.wire import (
    DEFAULT_CONTRACTS,
    analyze,
    check_wire,
    load_contracts,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
SERVICE = "hyperopt_tpu_torch/serve/service.py"
CLIENT = "hyperopt_tpu_torch/client.py"


def _read(name):
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as f:
        return f.read()


def _real(rel):
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        return f.read()


def _roles_for(rule, src, kind):
    """The role hats each fixture universe wears (the reference suite's):
    GL604's good twin doubles as its own arming test; its bad twin ships
    with no test evidence (that absence IS the finding)."""
    path = "fixture.py"
    if rule == "GL603":
        return {"exceptions": {path: src}, "reply_seam": {path: src}}
    if rule == "GL604":
        roles = {"faults": {path: src}}
        if kind == "good":
            roles["tests"] = {"test_fixture.py": src}
        return roles
    if rule == "GL605":
        return {"durable": {path: src}}
    return {"server": {path: src}, "clients": {path: src}}


def _key(findings):
    return [(f.rule, f.line, f.col) for f in findings]


EXPECTED_COUNTS = {"GL601": 3, "GL602": 2, "GL603": 1, "GL604": 2, "GL605": 1, "GL606": 1}
CASES = [(r, k) for r in sorted(EXPECTED_COUNTS) for k in ("bad", "good")]


@pytest.mark.parametrize("rule,kind", CASES, ids=[f"{r}_{k}" for r, k in CASES])
def test_fixture_findings_equal_the_reference(rule, kind):
    src = _read(f"{rule.lower()}_{kind}.py")
    roles = _roles_for(rule, src, kind)
    contracts = None
    if rule == "GL602":
        # drift is measured against a manifest pinned from the good twin
        good = _roles_for(rule, _read("gl602_good.py"), "good")
        _, _, contracts = analyze(**good)
        _, _, ref_contracts = ref_analyze(**good)
        assert contracts == ref_contracts
    port, stats, _ = analyze(contracts=contracts, **roles)
    ref, ref_stats, _ = ref_analyze(contracts=contracts, **roles)
    assert _key(port) == _key(ref), (_key(port), _key(ref))
    assert stats == ref_stats
    want = [] if kind == "good" else [rule] * EXPECTED_COUNTS[rule]
    assert [f.rule for f in port] == want, _key(port)


def test_gl601_names_each_asymmetry():
    findings, _, _ = analyze(**_roles_for("GL601", _read("gl601_bad.py"), "bad"))
    msgs = " | ".join(f.message for f in findings)
    assert "'frobnicate'" in msgs  # client op nothing handles
    assert "no client or test caller" in msgs  # handler nothing calls
    assert "not by the router front" in msgs  # global-op asymmetry


def test_pragma_suppresses_wire_findings():
    src = _read("gl606_bad.py").replace(
        "def _handle_request(service, req):",
        "def _handle_request(service, req):  # graftlint: disable=GL606 fixture-only refusal hint",
    )
    findings, stats, _ = analyze(server={"fixture.py": src}, clients={"fixture.py": src})
    assert findings == [] and stats["n_suppressed"] == 1


# ---------------------------------------------------------------------------
# mutation kill-checks on the port's own sources
# ---------------------------------------------------------------------------


def _mutant(rel, old, new):
    src = _real(rel)
    assert src.count(old) == 1, old
    return check_wire(root=REPO, sources={rel: src.replace(old, new)})


def test_mutation_deleted_tell_handler_trips_gl601():
    res = _mutant(SERVICE, 'if op == "tell":', 'if op == "tell_disabled":')
    assert [f for f in res.findings if f.rule == "GL601" and "'tell'" in f.message], res.findings


def test_mutation_renamed_reply_field_trips_gl602():
    res = _mutant(SERVICE, 'return {"ok": True, "tid": tid, "vals": vals}',
                  'return {"ok": True, "tid": tid, "values": vals}')
    assert [f for f in res.findings if f.rule == "GL602" and "'ask'" in f.message
            and "'vals'" in f.message and "'values'" in f.message], res.findings


def test_mutation_dropped_reply_error_trips_gl603():
    res = _mutant(CLIENT, '    "StudyPoisoned": StudyPoisoned,\n', "")
    assert [f for f in res.findings
            if f.rule == "GL603" and "StudyPoisoned" in f.message], res.findings


def test_mutation_hand_built_retry_after_trips_gl606():
    res = _mutant(SERVICE, "min(0.05, RETRY_AFTER_CAP) if e.retry_after is None",
                  "0.05 if e.retry_after is None")
    assert [f.rule for f in res.findings] == ["GL606"], res.findings


def test_port_wire_surface_is_the_reference_manifest():
    # the port serves the reference's protocol: its pinned reply shapes
    # are the reference's, op for op
    port = load_contracts(os.path.join(REPO, DEFAULT_CONTRACTS))
    ref = load_contracts(os.path.join(REPO, "wire_contracts.json"))
    assert port == ref


def test_evidence_is_the_ports_tests_only():
    from hyperopt_tpu_torch.analysis.wire import _iter_test_files

    names = _iter_test_files(REPO)
    assert names and all(n.startswith("tests/test_torch_") for n in names)
