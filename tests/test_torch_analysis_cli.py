"""The port's lint CLI (``hyperopt-tpu-torch-lint``): the exit-code
contract, cwd-independence, and the port's own tree clean under every
pack against its zero-entry baseline and its own wire manifest.

The whole-tree passes run under a 30 s clock each: a budget a loaded
six-worker run meets (one pass takes a few seconds alone).
"""

import json
import os
import textwrap
import time

import pytest

from hyperopt_tpu_torch.analysis import format_text, lint_paths, load_baseline
from hyperopt_tpu_torch.analysis.cli import DEFAULT_BASELINE, main
from hyperopt_tpu_torch.analysis.wire import DEFAULT_CONTRACTS, check_wire, load_contracts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "hyperopt_tpu_torch")
PASS_BUDGET_S = 30.0

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


@pytest.fixture
def bad_tree(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(BAD_SLEEP)
    (pkg / "clean.py").write_text("x = 1\n")
    return pkg


# -- the port's tree is clean ------------------------------------------------


@pytest.mark.parametrize("pack", ["ast", "trace"])
def test_port_tree_is_clean(pack):
    t0 = time.perf_counter()
    result = lint_paths([PACKAGE], baseline=load_baseline(DEFAULT_BASELINE), root=REPO, pack=pack)
    elapsed = time.perf_counter() - t0
    assert result.clean, "\n" + format_text(result)
    assert elapsed < PASS_BUDGET_S, f"{pack} pass took {elapsed:.2f}s"
    assert result.n_files > 80  # the whole package, not a subset
    assert result.n_suppressed > 0  # the reasoned pragmas are seen


def test_port_tree_is_wire_clean():
    t0 = time.perf_counter()
    result = check_wire(root=REPO, baseline=load_baseline(DEFAULT_BASELINE))
    elapsed = time.perf_counter() - t0
    assert result.clean, result.findings
    assert elapsed < PASS_BUDGET_S, f"wire pass took {elapsed:.2f}s"
    assert result.contracts_path == os.path.join(REPO, DEFAULT_CONTRACTS)
    assert result.ops_checked >= 15  # both fronts, not a subset
    assert result.crash_points_total > 0
    assert result.crash_points_armed == result.crash_points_total


def test_port_baseline_is_empty():
    # nothing is grandfathered: a finding is repaired or suppressed
    # inline with its reason
    assert sum(load_baseline(DEFAULT_BASELINE).values()) == 0
    assert os.path.dirname(DEFAULT_BASELINE) == os.path.join(PACKAGE, "analysis")


# -- exit codes --------------------------------------------------------------


def test_cli_exit_1_on_findings(bad_tree, capsys):
    assert main([str(bad_tree)]) == 1
    out = capsys.readouterr().out
    assert "GL303" in out and "1 finding(s)" in out


def test_cli_exit_0_on_clean(tmp_path, capsys):
    (tmp_path / "ok.py").write_text("x = 1\n")
    assert main([str(tmp_path)]) == 0


def test_cli_exit_2_on_bad_path(tmp_path, capsys):
    assert main([str(tmp_path / "does_not_exist")]) == 2
    assert "error" in capsys.readouterr().err


def test_cli_exit_2_on_unreadable_baseline(bad_tree, tmp_path, capsys):
    bl = tmp_path / "corrupt.json"
    bl.write_text("{not json")
    assert main([str(bad_tree), "--baseline", str(bl)]) == 2


def test_cli_json_format(bad_tree, capsys):
    assert main([str(bad_tree), "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["summary"]["total"] == 1
    (finding,) = payload["findings"]
    assert finding["rule"] == "GL303" and finding["content_hash"]


def test_cli_write_baseline_roundtrip(bad_tree, tmp_path, capsys):
    bl = tmp_path / "bl.json"
    assert main([str(bad_tree), "--baseline", str(bl), "--write-baseline"]) == 0
    assert main([str(bad_tree), "--baseline", str(bl)]) == 0  # grandfathered
    assert main([str(bad_tree), "--baseline", str(bl), "--no-baseline"]) == 1


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("GL001", "GL101", "GL203", "GL301", "GL309", "GL401", "GL406", "GL501",
                "GL606"):
        assert rid in out


def test_cli_pack_selection_exit_codes(tmp_path, capsys):
    assert main(["--trace", "--wire"]) == 2
    assert main(["--ir", "--trace"]) == 2
    assert main(["--update-contracts"]) == 2  # needs --ir or --wire
    with pytest.raises(SystemExit) as e:  # argparse's own usage error
        main(["--no-such-pack"])
    assert e.value.code == 2
    capsys.readouterr()


def test_cli_wire_exit_codes(tmp_path, capsys):
    garbage = tmp_path / "wire_contracts.json"
    garbage.write_text("{not json")
    assert main(["--wire", "--contracts", str(garbage)]) == 2
    payload = load_contracts(os.path.join(REPO, DEFAULT_CONTRACTS))
    payload["fronts"]["service"]["ask"] = ["ok"]
    drifted = tmp_path / "drifted.json"
    drifted.write_text(json.dumps(payload))
    assert main(["--wire", "--contracts", str(drifted)]) == 1
    # --update-contracts re-pins a manifest (here a copy) to the tree
    assert main(["--wire", "--contracts", str(drifted), "--update-contracts"]) == 0
    assert load_contracts(str(drifted)) == load_contracts(os.path.join(REPO, DEFAULT_CONTRACTS))
    capsys.readouterr()


@pytest.mark.parametrize("pack", [[], ["--trace"], ["--wire"]], ids=["ast", "trace", "wire"])
def test_cli_findings_identical_from_any_cwd(pack, monkeypatch, capsys, tmp_path):
    # the AST packs on one subpackage, named relative to the repo and
    # absolute from elsewhere (the whole tree is linted above); the wire
    # pack checks its fixed surfaces.  A clean report would compare two
    # empty lists: the pragma suppressions carry the anchored paths' work
    sub = [] if pack == ["--wire"] else [os.path.join("hyperopt_tpu_torch", "serve")]
    monkeypatch.chdir(REPO)
    assert main(pack + sub + ["--format", "json"]) == 0
    here = json.loads(capsys.readouterr().out)
    monkeypatch.chdir(tmp_path)
    assert main(pack + [os.path.join(REPO, p) for p in sub] + ["--format", "json"]) == 0
    there = json.loads(capsys.readouterr().out)
    assert here == there
    assert here["summary"]["pragma_suppressed"] > 0


def test_cli_finding_paths_are_anchored_at_the_package_parent(monkeypatch, capsys, tmp_path):
    # a finding planted in a copy of one port file reports the same
    # repo-relative path whatever the cwd
    rel = "hyperopt_tpu_torch/serve/scheduler.py"
    root = tmp_path / "tree"
    (root / "hyperopt_tpu_torch" / "serve").mkdir(parents=True)
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        src = f.read()
    old = "        with self._lock:\n            self.circuit_open = False\n"
    assert src.count(old) == 1
    (root / rel).write_text(src.replace(old, old + "            time.sleep(0)\n"))
    paths = []
    for cwd in (REPO, str(tmp_path)):
        monkeypatch.chdir(cwd)
        assert main([str(root / rel), "--root", str(root), "--trace", "--format", "json"]) == 1
        paths.append([f["path"] for f in json.loads(capsys.readouterr().out)["findings"]])
    assert paths[0] == paths[1] == [rel]
