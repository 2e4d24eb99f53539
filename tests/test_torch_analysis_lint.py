"""The port's REP lint (mirrors ``tests/test_analysis_lint.py``): every
seeded-violation fixture in ``tests/torch_analysis_fixtures`` fires its
rule, every clean twin passes, suppression requires a justification,
and ``src/repro_torch`` lints clean.  The rules the port shares with the
JAX package (REP001, REP002, REP006) and its suppression handling find
what ``repro.analysis.lint`` finds, line for line, on both packages'
fixtures."""
import ast
import os
import subprocess
import sys

import pytest

from repro_torch.analysis import lint
from repro_torch.analysis.rules import NOT_PORTED, RULES

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_analysis_fixtures")
PORT = os.path.join(os.path.dirname(HERE), "src", "repro_torch")
CODES = ("rep001", "rep002", "rep003", "rep005", "rep006")


def _fixture(name):
    return os.path.join(FIXTURES, name)


def _codes(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# seeded violations fire; clean twins pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code,expected", [
    ("rep001", ["REP001"]),
    ("rep002", ["REP002"]),
    ("rep003", ["REP003"]),
    ("rep005", ["REP005"] * 6),
    ("rep006", ["REP006"] * 3),
])
def test_seeded_violation_fires(code, expected):
    findings = lint.run([_fixture(f"{code}_bad.py")])
    assert _codes(findings) == expected, [f.format() for f in findings]
    for f in findings:
        assert f.path.endswith(f"{code}_bad.py") and f.line > 0


@pytest.mark.parametrize("code", CODES)
def test_clean_twin_passes(code):
    findings = lint.run([_fixture(f"{code}_clean.py")])
    assert findings == [], [f.format() for f in findings]


def test_every_ported_rule_has_fixtures():
    assert sorted(RULES) == sorted(c.upper() for c in CODES)
    assert set(NOT_PORTED) == {"REP004"}
    for code in CODES:
        for kind in ("bad", "clean"):
            assert os.path.exists(_fixture(f"{code}_{kind}.py"))


def test_rep005_names_each_sync_kind():
    msgs = [f.message for f in lint.run([_fixture("rep005_bad.py")])]
    for kind in ("float(", "np.asarray", ".item()", ".cpu()", ".tolist()",
                 ".numpy()"):
        assert any(kind in m for m in msgs), kind


def test_bare_suppression_is_rep000_and_does_not_suppress():
    findings = lint.run([_fixture("rep000_bad.py")])
    assert _codes(findings) == ["REP000", "REP003"], [
        f.format() for f in findings]


def test_justified_suppression_silences_the_rule():
    # rep003_clean.py holds a REAL violation on its last function under a
    # justified suppression: without the comment the line flags
    path = _fixture("rep003_clean.py")
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    assert "rep-noqa: REP003 --" in text
    stripped = text[:text.index("  # rep-noqa")] + "\n"
    ast.parse(stripped)
    f = lint.SourceFile(path, stripped)
    ctx = lint.ProjectContext([f])
    assert _codes(RULES["REP003"].check(f, ctx)) == ["REP003"]


# ---------------------------------------------------------------------------
# the gate: the port's own source lints clean
# ---------------------------------------------------------------------------

def test_port_lints_clean():
    findings = lint.run([PORT])
    assert findings == [], "\n".join(f.format() for f in findings)


def _rep003_candidates(f):
    """Divisions by a static config count in the file's traced bodies,
    before the rule's two exemptions."""
    from repro_torch.analysis import rules
    rule = RULES["REP003"]
    out = []
    for fn in rules._functions(f.tree):
        if not rule._is_traced_body(fn):
            continue
        cfg = rule._config_names(fn)
        for node in ast.walk(fn):
            r = getattr(node, "right", None)
            if (isinstance(node, ast.BinOp)
                    and isinstance(node.op, (ast.Div, ast.FloorDiv))
                    and isinstance(r, ast.Attribute)
                    and rules._COUNT_ATTR.match(r.attr)
                    and isinstance(r.value, ast.Name) and r.value.id in cfg):
                out.append(ast.unparse(node))
    return out


def test_port_rep003_candidates_are_the_reference_exemptions():
    """The port's two REP003 candidates are exempt under the reference's
    own exemptions: a divisor inside ``.reshape`` (the ``fl_step``
    executor's microbatch split) and config-on-config arithmetic (the kv
    heads per query head); the rule reports neither."""
    found = {}
    for path in lint.collect_files([PORT]):
        with open(path, encoding="utf-8") as fh:
            f = lint.SourceFile(path, fh.read())
        cands = _rep003_candidates(f)
        if cands:
            found[os.path.relpath(path, PORT)] = cands
            assert RULES["REP003"].check(f, lint.ProjectContext([f])) == []
    assert found == {"engine/cohort_step.py": ["b // fl_cfg.n_micro"],
                     "models/layers.py": ["cfg.n_heads // cfg.n_kv_heads"]}


# ---------------------------------------------------------------------------
# held to the JAX package's lint on the same sources
# ---------------------------------------------------------------------------

SHARED = ("REP001", "REP002", "REP006")
REF_FIXTURES = os.path.join(HERE, "analysis_fixtures")
SHARED_SOURCES = [
    os.path.join(d, name) for d in (REF_FIXTURES, FIXTURES)
    for name in ["rep000_bad.py"] + [f"{c}_{k}.py"
                                     for c in ("rep001", "rep002", "rep006")
                                     for k in ("bad", "clean")]]


def _found(linter, paths):
    return [(f.rule, os.path.basename(f.path), f.line)
            for f in linter.run(paths, select=SHARED)]


@pytest.mark.parametrize("path", SHARED_SOURCES, ids=lambda p: os.path.join(
    os.path.basename(os.path.dirname(p)), os.path.basename(p)))
def test_shared_rules_find_what_the_reference_finds(path):
    from repro.analysis import lint as ref_lint
    assert _found(lint, [path]) == _found(ref_lint, [path])


def test_shared_rules_agree_over_all_sources_at_once():
    """One invocation over both fixture sets: the project context (the
    dataclass and spec registries) spans the files in both packages."""
    from repro.analysis import lint as ref_lint
    ours = _found(lint, SHARED_SOURCES)
    assert ours == _found(ref_lint, SHARED_SOURCES)
    assert {r for r, _, _ in ours} == {"REP000", *SHARED}


@pytest.mark.parametrize("justified", [True, False],
                         ids=["justified", "bare"])
@pytest.mark.parametrize("fixtures", [REF_FIXTURES, FIXTURES],
                         ids=["jax_fixture", "torch_fixture"])
def test_suppression_matches_the_reference(tmp_path, fixtures, justified):
    """The first REP006 line of ``rep006_bad.py`` suppressed: a justified
    suppression silences it in both packages, a bare one silences
    nothing and is REP000 in both."""
    from repro.analysis import lint as ref_lint
    path = os.path.join(fixtures, "rep006_bad.py")
    before = _found(ref_lint, [path])
    line = before[0][2]
    with open(path, encoding="utf-8") as fh:
        src = fh.read().splitlines()
    src[line - 1] += "  # rep-noqa: REP006" + (
        " -- the store owns this loop" if justified else "")
    out = tmp_path / "rep006_bad.py"
    out.write_text("\n".join(src) + "\n", encoding="utf-8")
    ours, ref = _found(lint, [str(out)]), _found(ref_lint, [str(out)])
    assert ours == ref
    if justified:
        assert ref == before[1:]
    else:
        assert ref == sorted(before + [("REP000", "rep006_bad.py", line)],
                             key=lambda x: (x[2], x[0]))


# ---------------------------------------------------------------------------
# engine/CLI behavior
# ---------------------------------------------------------------------------

def test_select_restricts_rules():
    assert lint.run([_fixture("rep005_bad.py")], select=["REP001"]) == []
    assert _codes(lint.run([_fixture("rep005_bad.py")],
                           select=["REP005"])) == ["REP005"] * 6
    # REP000 runs whatever is selected
    assert _codes(lint.run([_fixture("rep000_bad.py")],
                           select=["REP001"])) == ["REP000"]
    with pytest.raises(ValueError, match="REP004"):
        lint.run([_fixture("rep005_bad.py")], select=["REP004"])


def test_main_exit_codes(capsys):
    assert lint.main([_fixture("rep001_bad.py")]) == 1
    out = capsys.readouterr().out
    assert "REP001" in out and "rep001_bad.py" in out
    assert lint.main([_fixture("rep001_clean.py")]) == 0
    assert lint.main(["/nonexistent/thing"]) == 2
    assert lint.main(["--select", "REP999", _fixture("rep001_bad.py")]) == 2


def test_cli_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.dirname(PORT))
    res = [subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        env=env, capture_output=True, text=True, timeout=120)
        for args in ([PORT], [_fixture("rep006_bad.py")], [])]
    assert [r.returncode for r in res] == [0, 1, 2], [r.stderr for r in res]
    assert "3 finding(s)" in res[1].stderr


def test_project_context_registries():
    files = []
    for name in ("rep002_bad.py", "rep001_bad.py"):
        path = _fixture(name)
        with open(path, encoding="utf-8") as fh:
            files.append(lint.SourceFile(path, fh.read()))
    ctx = lint.ProjectContext(files)
    assert {"InnerConfig", "OuterSpec"} <= set(ctx.dataclasses)
    assert ctx.spec_registries[0].names == ["OuterSpec"]
