"""graftlint core: findings model, source loading, check registry.

A check is a class with `id`, `name`, `severity`, a one-line `describe`,
and `run(project) -> Iterable[Finding]`. Checks see the whole `Project`
(every parsed file) so cross-file rules (config drift) and single-file
rules (trace purity) share one plugin shape. Findings carry a content
hash of their anchor line so baseline suppressions survive line-number
drift and file moves (see baseline.py).

Inline suppression: a ``# graftlint: ignore[GL201]`` comment on the
finding's line drops that finding; placed on a ``def`` line it drops
the check's findings for the whole function (the runner resolves the
enclosing function from the AST). ``# graftlint: ignore`` (no id)
suppresses every check on that line.
"""

from __future__ import annotations

import ast
import hashlib
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SEVERITIES = ("warning", "error")

# Directories never worth linting (generated trees, caches, VCS).
EXCLUDED_DIRS = {"build", "dist", "__pycache__", ".git", ".tox", ".venv",
                 "node_modules"}

_IGNORE_RE = re.compile(r"#\s*graftlint:\s*ignore(?:\[([A-Z0-9, ]+)\])?")


@dataclass
class Finding:
    check: str      # check id, e.g. "GL201"
    name: str       # check slug, e.g. "lock-discipline"
    severity: str   # "error" | "warning"
    path: str       # display path (relative when possible)
    line: int       # 1-based anchor line
    message: str
    snippet: str = ""  # stripped source of the anchor line

    @property
    def content_hash(self) -> str:
        """Identity for baseline matching: the check plus the anchor
        line's stripped text. Deliberately excludes path and line
        number so renames and drift don't orphan suppressions."""
        key = f"{self.check}:{self.snippet.strip()}"
        return hashlib.sha1(key.encode("utf-8", "replace")).hexdigest()[:16]

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.check} [{self.severity}] "
                f"{self.message}")


@dataclass
class SourceFile:
    path: str              # absolute
    rel: str               # display-relative
    source: str
    tree: Optional[ast.Module]
    parse_error: Optional[str] = None
    lines: List[str] = field(default_factory=list)

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


@dataclass
class Project:
    root: str                       # anchor for display paths / docs lookup
    files: List[SourceFile] = field(default_factory=list)

    def find(self, rel_suffix: str) -> Optional[SourceFile]:
        """First file whose path ends with `rel_suffix` (posix-style)."""
        suffix = rel_suffix.replace("/", os.sep)
        for f in self.files:
            if f.path.endswith(suffix):
                return f
        return None


def _iter_py_files(path: str) -> Iterable[str]:
    if os.path.isfile(path):
        yield path
        return
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in EXCLUDED_DIRS
                             and not d.endswith(".egg-info"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def load_project(paths: Sequence[str]) -> Project:
    """Parse every .py under `paths` into a Project. Syntax errors are
    recorded per-file (the runner reports them as GL000 findings rather
    than crashing the whole pass)."""
    abs_paths = [os.path.abspath(p) for p in paths]
    root = os.path.commonpath([p if os.path.isdir(p) else os.path.dirname(p)
                               for p in abs_paths]) if abs_paths else os.getcwd()
    proj = Project(root=root)
    seen = set()
    for p in abs_paths:
        for fp in _iter_py_files(p):
            if fp in seen:
                continue
            seen.add(fp)
            try:
                with open(fp, encoding="utf-8", errors="replace") as fh:
                    src = fh.read()
            except OSError as e:
                proj.files.append(SourceFile(fp, _rel(fp, root), "", None,
                                             parse_error=str(e)))
                continue
            try:
                tree = ast.parse(src, filename=fp)
                err = None
            except SyntaxError as e:
                tree, err = None, f"syntax error: {e.msg} (line {e.lineno})"
            proj.files.append(SourceFile(fp, _rel(fp, root), src, tree,
                                         parse_error=err,
                                         lines=src.splitlines()))
    return proj


def _rel(path: str, root: str) -> str:
    try:
        r = os.path.relpath(path, root)
    except ValueError:
        return path
    return path if r.startswith("..") else r


# -- inline suppression ------------------------------------------------------


def _line_suppressions(sf: SourceFile) -> Dict[int, Optional[set]]:
    """lineno -> set of suppressed check ids (None = all checks)."""
    out: Dict[int, Optional[set]] = {}
    for i, text in enumerate(sf.lines, start=1):
        m = _IGNORE_RE.search(text)
        if not m:
            continue
        ids = m.group(1)
        out[i] = (None if ids is None
                  else {s.strip() for s in ids.split(",") if s.strip()})
    return out


def _function_spans(sf: SourceFile) -> List[Tuple[int, int, int]]:
    """(def_lineno, body_start, body_end) for every function — used to
    widen a def-line suppression to the whole function."""
    spans = []
    if sf.tree is None:
        return spans
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = getattr(node, "end_lineno", node.lineno)
            spans.append((node.lineno, node.lineno, end))
    return spans


def _suppressed(finding: Finding, sf: SourceFile,
                line_supp: Dict[int, Optional[set]],
                spans: List[Tuple[int, int, int]]) -> bool:
    def matches(ids: Optional[set]) -> bool:
        return ids is None or finding.check in ids

    if finding.line in line_supp and matches(line_supp[finding.line]):
        return True
    # A suppression on a def line covers the whole function body.
    for lineno, start, end in spans:
        if lineno in line_supp and matches(line_supp[lineno]) \
                and start <= finding.line <= end:
            return True
    return False


# -- registry / runner -------------------------------------------------------


def all_checks() -> List:
    """Every shipped check class, id-sorted (plugin modules under
    lint/checks/ register by being imported here)."""
    from generativeaiexamples_tpu_torch.lint.checks import ALL_CHECKS

    return sorted(ALL_CHECKS, key=lambda c: c.id)


def run_checks(project: Project, checks: Optional[Sequence] = None,
               ) -> List[Finding]:
    """Run `checks` (default: all) over the project; returns findings
    sorted by (path, line, check), inline suppressions already applied.
    Unparseable files surface as GL000 findings."""
    findings: List[Finding] = []
    for sf in project.files:
        if sf.parse_error is not None:
            findings.append(Finding(
                check="GL000", name="parse-error", severity="error",
                path=sf.rel, line=1, message=sf.parse_error, snippet=""))
    chk_list = list(checks) if checks is not None else \
        [c() for c in all_checks()]
    for chk in chk_list:
        findings.extend(chk.run(project))
    # Apply inline suppressions per file.
    by_path = {sf.rel: sf for sf in project.files}
    kept = []
    supp_cache: Dict[str, Tuple[dict, list]] = {}
    for f in findings:
        sf = by_path.get(f.path)
        if sf is None:
            kept.append(f)
            continue
        if sf.rel not in supp_cache:
            supp_cache[sf.rel] = (_line_suppressions(sf), _function_spans(sf))
        line_supp, spans = supp_cache[sf.rel]
        if line_supp and _suppressed(f, sf, line_supp, spans):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.check))
    return kept


class Check:
    """Base class for a lint check plugin.

    Subclasses set `id` (GLnnn), `name` (kebab-case slug), `severity`,
    `describe` (one line for --list-checks) and implement
    `run(project)`. `finding()` is a convenience that fills the
    snippet from the source file."""

    id = "GL999"
    name = "unnamed"
    severity = "error"
    describe = ""

    def run(self, project: Project) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, sf: SourceFile, line: int, message: str) -> Finding:
        return Finding(check=self.id, name=self.name, severity=self.severity,
                       path=sf.rel, line=line, message=message,
                       snippet=sf.line(line))
