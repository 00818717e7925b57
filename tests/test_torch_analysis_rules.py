"""The port's AST (GL0xx/GL3xx) and concurrency (GL5xx) packs held
against the reference checker on the reference's fixture corpus.

Every fixture of a ported rule goes through both packages' engines: the
port's findings must be the reference's, (rule, line, col) for
(rule, line, col); each bad fixture trips exactly its rule and each good
fixture is clean.  The suppression, GL001/GL002 and baseline cases of
the reference's suite run through the port's engine.
"""

import os
import textwrap

import pytest

from hyperopt_tpu.analysis.engine import lint_source as ref_lint_source
from hyperopt_tpu_torch.analysis import RULES
from hyperopt_tpu_torch.analysis.baseline import apply_baseline, load_baseline, write_baseline
from hyperopt_tpu_torch.analysis.engine import lint_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")

AST_RULES = ["GL301", "GL302", "GL303", "GL304", "GL305", "GL306", "GL307", "GL308", "GL309"]
TRACE_RULES = ["GL501", "GL502", "GL503", "GL504", "GL505", "GL506", "GL507"]

#: exact finding counts of the multi-site bad fixtures (the reference's
#: suites pin the same numbers)
EXPECTED_COUNTS = {
    "GL301": 1, "GL304": 2, "GL305": 2, "GL306": 2, "GL307": 3, "GL308": 2, "GL309": 3,
    "GL501": 2, "GL502": 2, "GL503": 2, "GL504": 1, "GL505": 2, "GL506": 1, "GL507": 1,
    "engine_thread": 2,
}


def _fixture(name):
    """Repo-relative path of a fixture: path-scoped rules read the
    ``distributed/`` part of it."""
    sub = os.path.join("tests", "lint_fixtures", "distributed", name)
    return sub if os.path.exists(os.path.join(REPO, sub)) else os.path.join(
        "tests", "lint_fixtures", name)


def _both(rel, pack):
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        source = f.read()
    port, _ = lint_source(source, path=rel, pack=pack)
    ref, _ = ref_lint_source(source, path=rel, pack=pack)
    return port, ref


def _key(findings):
    return [(f.rule, f.line, f.col) for f in findings]


CASES = (
    [("ast", r, kind) for r in AST_RULES for kind in ("bad", "good")]
    + [("trace", r, kind) for r in TRACE_RULES for kind in ("bad", "good")]
    + [("trace", "engine_thread", kind) for kind in ("bad", "good")]
)


@pytest.mark.parametrize("pack,rule,kind", CASES,
                         ids=[f"{r}_{k}" for _, r, k in CASES])
def test_fixture_findings_equal_the_reference(pack, rule, kind):
    rel = _fixture(f"{rule.lower()}_{kind}.py")
    port, ref = _both(rel, pack)
    assert _key(port) == _key(ref), (_key(port), _key(ref))
    if kind == "good":
        assert port == [], _key(port)
        return
    want = "GL501" if rule == "engine_thread" else rule
    assert port and {f.rule for f in port} == {want}, _key(port)
    # engine_thread: _drain's store and _bump's aug-store, each a root
    # only through the bound-method / partial thread-target resolution
    if rule in EXPECTED_COUNTS:
        assert len(port) == EXPECTED_COUNTS[rule], _key(port)


def test_every_ported_rule_has_a_fixture_pair():
    names = set()
    for fixtures in (FIXTURES, os.path.join(REPO, "tests", "lint_fixtures_torch")):
        for _root, _dirs, files in os.walk(fixtures):
            names.update(files)
    capture = [f"GL10{i}" for i in range(1, 5)] + [f"GL20{i}" for i in range(1, 4)]
    # the program pack's rules hold on hand-built programs
    # (tests/test_torch_ir.py), not on source fixtures
    program = [f"GL40{i}" for i in range(1, 7)]
    ported = sorted(r for r in RULES if r not in ("GL001", "GL002"))
    assert ported == sorted(AST_RULES + TRACE_RULES + [f"GL60{i}" for i in range(1, 7)]
                            + capture + program)
    for rule in ported:
        if rule in program:
            continue
        assert f"{rule.lower()}_bad.py" in names and f"{rule.lower()}_good.py" in names, rule


def test_findings_carry_location_and_hash():
    (f,), _ = _both(_fixture("gl301_bad.py"), "ast")
    assert f.line > 0 and f.col >= 0
    assert "os.replace" in f.source_line
    assert len(f.content_hash()) == 40
    d = f.to_dict()
    assert d["rule"] == "GL301" and d["content_hash"] == f.content_hash()


# -- the port's own idiom: torch's global generator and torch.save ---------

TORCH_RNG = textwrap.dedent(
    """\
    import torch


    def init(n, gen):
        torch.manual_seed(0)
        a = torch.randn(n)
        b = torch.randn(n, generator=gen)
        torch.cuda.manual_seed_all(1)
        return a, b
    """
)

TORCH_SAVE = textwrap.dedent(
    """\
    import io
    import os

    import torch


    def save_in_place(state, path):
        with open(path, "wb") as f:
            torch.save(state, f)


    def save_durable(state, path):
        with open(path, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())


    def to_bytes(state):
        buf = io.BytesIO()
        torch.save(state, buf)
        return buf.getvalue()
    """
)


def test_gl304_sees_torch_global_generator():
    findings, _ = lint_source(TORCH_RNG, path="pkg/mod.py")
    assert [(f.rule, f.line) for f in findings] == [("GL304", 5), ("GL304", 6), ("GL304", 8)]
    # a test file may seed the global stream
    assert lint_source(TORCH_RNG, path="tests/test_x.py")[0] == []


def test_gl305_sees_torch_save():
    findings, _ = lint_source(TORCH_SAVE, path="pkg/mod.py")
    assert [(f.rule, f.line) for f in findings] == [("GL305", 9)]


# -- pragma placement (the reference's suppression cases) ------------------

BAD_SLEEP = textwrap.dedent(
    """\
    import time


    def fetch(op):
        for _ in range(3):
            try:
                return op()
            except OSError:
                time.sleep(0.05)
    """
)


def _findings(source, path="pkg/mod.py"):
    fs, _ = lint_source(source, path=path)
    return fs


def test_pragma_on_violating_line_suppresses():
    src = BAD_SLEEP.replace(
        "time.sleep(0.05)", "time.sleep(0.05)  # graftlint: disable=GL303 supervisor backoff")
    assert _findings(src) == []
    _, n = lint_source(src, path="pkg/mod.py")
    assert n == 1  # counted as suppressed, not silently dropped


def test_pragma_on_enclosing_def_suppresses_scope():
    src = BAD_SLEEP.replace(
        "def fetch(op):", "def fetch(op):  # graftlint: disable=GL303 hand-rolled by design")
    assert _findings(src) == []


def test_pragma_on_unrelated_line_does_not_suppress():
    src = BAD_SLEEP.replace(
        "except OSError:", "except OSError:  # graftlint: disable=GL303 wrong line")
    assert [f.rule for f in _findings(src)] == ["GL303"]


def test_pragma_for_different_rule_does_not_suppress():
    src = BAD_SLEEP.replace(
        "time.sleep(0.05)", "time.sleep(0.05)  # graftlint: disable=GL304 wrong rule")
    assert [f.rule for f in _findings(src)] == ["GL303"]


def test_multi_rule_pragma():
    src = BAD_SLEEP.replace(
        "time.sleep(0.05)", "time.sleep(0.05)  # graftlint: disable=GL304,GL303 both named")
    assert _findings(src) == []


def test_pragma_suppresses_trace_findings():
    src = textwrap.dedent(
        """\
        import threading
        import time


        class P:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def tick(self):
                with self._lock:
                    self.n += 1
                    time.sleep(0.01)  # graftlint: disable=GL503 deliberate
        """
    )
    findings, n = lint_source(src, path="pkg/mod.py", pack="trace")
    assert findings == [] and n == 1


# -- GL001 / GL002 -----------------------------------------------------------

def test_unknown_rule_id_in_pragma_is_itself_a_finding():
    fs = _findings("x = 1  # graftlint: disable=GL999 no such rule\n")
    assert [f.rule for f in fs] == ["GL001"]
    assert "GL999" in fs[0].message


def test_pragma_naming_an_unported_rule_is_gl001():
    # every pack of the reference is ported (GL1xx/GL2xx as capture
    # rules, GL4xx over aten graphs): a pragma naming one of them
    # validates, one naming an ID no pack defines protects nothing
    assert _findings("x = 1  # graftlint: disable=GL101 captured scope\n") == []
    fs = _findings("x = 1  # graftlint: disable=GL105 no such rule\n")
    assert [f.rule for f in fs] == ["GL001"]


def test_valid_pragma_with_reason_is_not_gl001():
    src = BAD_SLEEP.replace(
        "time.sleep(0.05)", "time.sleep(0.05)  # graftlint: disable=GL303 reason text here")
    assert _findings(src) == []


def test_syntax_error_is_gl002():
    assert [f.rule for f in _findings("def broken(:\n")] == ["GL002"]


def test_unknown_pack_is_refused():
    with pytest.raises(ValueError):
        lint_source("x = 1\n", pack="ir")


# -- baseline: content-hash keying ------------------------------------------

def test_baseline_survives_unrelated_line_shift(tmp_path):
    fs = _findings(BAD_SLEEP)
    bl = str(tmp_path / "baseline.json")
    write_baseline(bl, fs)
    shifted = _findings("import os\n\nUNRELATED = os.sep  # new code above\n" + BAD_SLEEP)
    assert shifted[0].line != fs[0].line
    kept, matched = apply_baseline(shifted, load_baseline(bl))
    assert kept == [] and matched == 1


def test_baseline_entry_dies_when_violating_line_changes(tmp_path):
    bl = str(tmp_path / "baseline.json")
    write_baseline(bl, _findings(BAD_SLEEP))
    edited = BAD_SLEEP.replace("time.sleep(0.05)", "time.sleep(0.25)")
    kept, matched = apply_baseline(_findings(edited), load_baseline(bl))
    assert matched == 0 and [f.rule for f in kept] == ["GL303"]


def test_baseline_is_keyed_by_path_too(tmp_path):
    bl = str(tmp_path / "baseline.json")
    write_baseline(bl, _findings(BAD_SLEEP, path="pkg/a.py"))
    kept, matched = apply_baseline(_findings(BAD_SLEEP, path="pkg/b.py"), load_baseline(bl))
    assert matched == 0 and len(kept) == 1


def test_baseline_is_a_multiset(tmp_path):
    double = BAD_SLEEP.replace(
        "time.sleep(0.05)", "time.sleep(0.05)\n            time.sleep(0.05)")
    fs = _findings(double)
    assert len(fs) == 2
    bl = str(tmp_path / "baseline.json")
    write_baseline(bl, fs[:1])
    kept, matched = apply_baseline(fs, load_baseline(bl))
    assert matched == 1 and len(kept) == 1


def test_baseline_hash_equals_the_reference(tmp_path):
    # one key format for both packages: a baseline either writes reads
    # in the other
    from hyperopt_tpu.analysis.engine import lint_source as ref

    (mine,), (theirs,) = _findings(BAD_SLEEP), ref(BAD_SLEEP, path="pkg/mod.py")[0]
    assert mine.content_hash() == theirs.content_hash()
    assert mine.to_dict() == theirs.to_dict()
