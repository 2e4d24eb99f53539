"""``python -m repro_torch.analysis.lint`` — AST lint pass for the repo's
own bug classes, over the PyTorch port's sources (port of
``repro/analysis/lint.py``; the pure-AST engine is copied, not imported).

Generic linters catch generic bugs; the expensive failures this repo has
hit were REPO-SPECIFIC invariant violations (a config field missing from
a step-cache key, a dataclass half-registered in the spec codec, a
static divisor where a batch-derived one was meant, a host sync in the
pipelined hot loop, a per-client loop in a store region).  The REP rules
in :mod:`repro_torch.analysis.rules` codify those classes for PyTorch
code; this module is the engine: file loading, project-wide context
(dataclass registry, spec-type registries), suppression handling, and
the CLI.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis.lint path/to/a.py
    PYTHONPATH=src python -m repro_torch.analysis.lint --select REP005 PATH

Suppression: append a ``rep-noqa`` comment naming the code, then two
dashes and the reason, to the flagged line, e.g.
``# rep-noqa: REP003 -- <why this is safe>``.  The reason is REQUIRED —
a suppression without it produces REP000.  Several rules:
``# rep-noqa: REP001, REP005 -- ...``.

Exit status: 0 when no findings, 1 when any finding survives
suppression, 2 on usage/parse errors.

REP004 (a donated buffer read after donation) has no counterpart: PyTorch
has no ``donate_argnums``; the port's arenas are written in place, which
:func:`repro_torch.analysis.audits.audit_donation` checks on the run.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import re
import sys

_SUPPRESS_RE = re.compile(
    r"#\s*rep-noqa:\s*(REP\d{3}(?:\s*,\s*REP\d{3})*)(\s*--\s*(\S.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class SourceFile:
    """One parsed file: tree, parent links, and suppression table."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.lines = text.splitlines()
        self.parents: dict = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        # line -> set of suppressed rule codes; lines whose suppression
        # lacks the "-- reason" tail get REP000 instead
        self.suppressions: dict = {}
        self.bare_suppressions: list = []
        for i, raw in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(raw)
            if m is None:
                continue
            codes = {c.strip() for c in m.group(1).split(",")}
            if m.group(3) is None:
                self.bare_suppressions.append((i, sorted(codes)))
            else:
                self.suppressions[i] = codes

    def ancestors(self, node):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None


# ---------------------------------------------------------------------------
# project context: cross-file registries the rules consult
# ---------------------------------------------------------------------------

def _is_dataclass_decorator(dec) -> bool:
    if isinstance(dec, ast.Call):
        dec = dec.func
    if isinstance(dec, ast.Name):
        return dec.id == "dataclass"
    if isinstance(dec, ast.Attribute):
        return dec.attr == "dataclass"
    return False


@dataclasses.dataclass
class DataclassInfo:
    name: str
    path: str
    line: int
    fields: list            # annotated field names, in order
    refs: set               # identifiers referenced by annotations/defaults


@dataclasses.dataclass
class SpecRegistry:
    """An ``_SPEC_TYPES``-style codec registry assignment."""
    path: str
    line: int
    names: list             # registered class names


class ProjectContext:
    """Registries built over ALL linted files before per-file rules run.

    The context is scoped to the lint invocation: linting
    ``src/repro_torch`` sees the whole package; linting one fixture file
    sees only that file, so seeded-violation fixtures are self-contained.
    """

    def __init__(self, files):
        self.files = files
        self.dataclasses: dict = {}
        self.spec_registries: list = []
        for f in files:
            self._scan(f)

    def _scan(self, f: SourceFile):
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef) and any(
                    _is_dataclass_decorator(d) for d in node.decorator_list):
                fields, refs = [], set()
                for stmt in node.body:
                    if not isinstance(stmt, ast.AnnAssign):
                        continue
                    if isinstance(stmt.target, ast.Name):
                        fields.append(stmt.target.id)
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Name):
                            refs.add(sub.id)
                self.dataclasses[node.name] = DataclassInfo(
                    node.name, f.path, node.lineno, fields, refs)
            elif isinstance(node, ast.Assign):
                self._scan_spec_registry(f, node)

    def _scan_spec_registry(self, f: SourceFile, node: ast.Assign):
        if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name):
            return
        if not node.targets[0].id.endswith("_SPEC_TYPES"):
            return
        names = []
        v = node.value
        if isinstance(v, ast.DictComp) and v.generators:
            it = v.generators[0].iter
            if isinstance(it, (ast.Tuple, ast.List)):
                names = [e.id for e in it.elts if isinstance(e, ast.Name)]
        elif isinstance(v, ast.Dict):
            names = [val.id for val in v.values if isinstance(val, ast.Name)]
        if names:
            self.spec_registries.append(
                SpecRegistry(f.path, node.lineno, names))


# ---------------------------------------------------------------------------
# running the rules and the CLI
# ---------------------------------------------------------------------------

def collect_files(paths) -> list:
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs.sort()
                for n in sorted(names):
                    if n.endswith(".py"):
                        out.append(os.path.join(root, n))
        elif p.endswith(".py"):
            out.append(p)
        else:
            raise ValueError(f"not a python file or directory: {p}")
    return out


def run(paths, select=None) -> list:
    """Lint ``paths`` (files and/or directories); returns surviving
    :class:`Finding`\\ s.  ``select`` restricts to the given rule codes
    (suppression hygiene REP000 always runs)."""
    from repro_torch.analysis.rules import RULES
    if select:
        unknown = sorted(set(select) - set(RULES))
        if unknown:
            raise ValueError(f"unknown rule code(s): {', '.join(unknown)}")
    files = []
    for path in collect_files(paths):
        with open(path, encoding="utf-8") as fh:
            files.append(SourceFile(path, fh.read()))
    ctx = ProjectContext(files)
    findings = []
    for f in files:
        for line, codes in f.bare_suppressions:
            findings.append(Finding(
                "REP000", f.path, line, 0,
                f"rep-noqa for {', '.join(codes)} has no justification — "
                "add ` -- why this is safe` after the code(s)"))
        for code, rule in RULES.items():
            if select and code not in select:
                continue
            for finding in rule.check(f, ctx):
                if finding.rule in f.suppressions.get(finding.line, ()):
                    continue
                findings.append(finding)
    return sorted(findings, key=lambda x: (x.path, x.line, x.rule))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-specific AST lint (REP rules) for the PyTorch "
                    "port; see the README's port section")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--select", action="append", default=None,
                    metavar="REPNNN", help="run only these rule codes")
    args = ap.parse_args(argv)
    try:
        findings = run(args.paths, select=args.select)
    except (SyntaxError, ValueError, OSError) as e:
        print(f"lint error: {e}", file=sys.stderr)
        return 2
    for f in findings:
        print(f.format())
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
