"""The port's capture-discipline (GL1xx) and dispatch-hygiene (GL2xx)
rules on their torch fixture pairs, and the port itself clean under them.

The reference's GL1xx/GL2xx fixtures are JAX code; the port's rules read
"captured scope" (a step handed to ``capture_graph``, to
``torch.cuda.make_graphed_callables`` or called from a ``with
torch.cuda.graph`` body, and its same-file callees) where the reference
read "jitted scope", so each rule has a torch twin of the reference's
bad/good pair under ``tests/lint_fixtures_torch/``.  Each bad fixture
trips exactly its rule, at pinned counts; each good fixture is clean.
"""

import ast
import os

import pytest

from hyperopt_tpu_torch.analysis import RULES
from hyperopt_tpu_torch.analysis.baseline import load_baseline
from hyperopt_tpu_torch.analysis.engine import FileContext, lint_paths, lint_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures_torch")
PACKAGE = os.path.join(REPO, "hyperopt_tpu_torch")

#: findings of each bad fixture, one per violating site
EXPECTED_COUNTS = {
    "GL101": 5, "GL102": 1, "GL103": 1, "GL104": 3,
    "GL201": 2, "GL202": 3, "GL203": 2,
}
CASES = [(r, kind) for r in EXPECTED_COUNTS for kind in ("bad", "good")]

#: the port's capture sites and the steps (with their same-file callees)
#: the engine must see in captured scope there
CAPTURED = {
    "device_loop.py": {"counted_step", "step", "ask", "tell", "_write", "bracket",
                       "_suggest", "_evaluate"},
    "pbt.py": {"one_round", "rank_train", "rank_exploit", "train_blocks", "exploit"},
    "hyperband.py": {"rung_step", "rank_train", "rank_promote", "_train", "_promote"},
    "models/transformer.py": {"step"},
}


def _lint(name):
    rel = os.path.join("tests", "lint_fixtures_torch", name)
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        return lint_source(f.read(), path=rel)[0]


@pytest.mark.parametrize("rule,kind", CASES, ids=[f"{r}_{k}" for r, k in CASES])
def test_fixture_trips_exactly_its_rule(rule, kind):
    fs = _lint(f"{rule.lower()}_{kind}.py")
    keys = [(f.rule, f.line) for f in fs]
    if kind == "good":
        assert fs == [], keys
        return
    assert {f.rule for f in fs} == {rule}, keys
    assert len(fs) == EXPECTED_COUNTS[rule], keys


def test_every_capture_rule_has_a_fixture_pair():
    rules = sorted(r for r in RULES if r[2] in "12" and r[:3] in ("GL1", "GL2"))
    assert rules == sorted(EXPECTED_COUNTS)
    for rule in rules:
        for kind in ("bad", "good"):
            assert os.path.exists(os.path.join(FIXTURES, f"{rule.lower()}_{kind}.py"))


@pytest.mark.parametrize("rel", sorted(CAPTURED))
def test_capture_sites_resolve_their_steps(rel):
    path = os.path.join(PACKAGE, rel)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    ctx = FileContext(rel, src, ast.parse(src))
    names = {getattr(fn, "name", "<lambda>") for fn in ctx.captured}
    assert CAPTURED[rel] <= names, CAPTURED[rel] - names


def test_capture_sites_lint_clean_against_the_zero_entry_baseline():
    """The files that capture (and ``utils``' ``capture_graph``) under
    every AST rule, GL1xx/GL2xx included, against the committed baseline,
    which holds no entry (the whole tree is linted in
    ``test_torch_analysis_cli.py``)."""
    baseline_path = os.path.join(PACKAGE, "analysis", "lint_baseline.json")
    counter = load_baseline(baseline_path)
    assert sum(counter.values()) == 0
    files = [os.path.join(PACKAGE, rel) for rel in sorted(CAPTURED)]
    files.append(os.path.join(PACKAGE, "utils", "__init__.py"))
    res = lint_paths(files, baseline=counter, root=REPO)
    assert res.findings == [], [(f.path, f.rule, f.line) for f in res.findings]


@pytest.mark.parametrize("rule", sorted(EXPECTED_COUNTS) + ["GL401", "GL406"])
def test_pragma_naming_a_capture_or_program_rule_validates(rule):
    fs, suppressed = lint_source(f"x = 1  # graftlint: disable={rule} deliberate\n")
    assert fs == [] and suppressed == 0


def test_a_replay_read_needs_a_static_buffer():
    """GL201's near-miss in one file: a name bound to a plain tensor (not
    a graph's static output or carry) may be read across replays."""
    src = (
        "import torch\n"
        "from hyperopt_tpu_torch.utils import capture_graph\n"
        "def run(graph, x):\n"
        "    y = x\n"
        "    graph.replay()\n"
        "    graph.replay()\n"
        "    return y\n"
    )
    assert lint_source(src)[0] == []
