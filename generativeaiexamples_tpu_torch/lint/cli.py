"""graftlint CLI: `python -m generativeaiexamples_tpu_torch.lint [paths...]`.

Exit-code contract (tests/test_torch_lint.py pins it):
  0 — clean (no findings after baseline + severity filtering)
  1 — findings
  2 — usage error (bad flag, unknown check id, missing path)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Sequence, Set

from generativeaiexamples_tpu_torch.lint.baseline import (
    BASELINE_FILENAME, Baseline)
from generativeaiexamples_tpu_torch.lint.core import (
    SEVERITIES, Finding, all_checks, load_project, run_checks)


class UsageError(Exception):
    pass


def lint_paths(paths: Sequence[str], *, select: Optional[Sequence[str]] = None,
               ignore: Optional[Sequence[str]] = None,
               baseline: Optional[Baseline] = None,
               min_severity: str = "warning") -> List[Finding]:
    """Programmatic entry point (tests use this): run the selected
    checks over `paths`, apply the baseline and the severity floor,
    return surviving findings."""
    checks = resolve_checks(select, ignore)
    project = load_project(paths)
    findings = run_checks(project, checks)
    floor = SEVERITIES.index(min_severity)
    findings = [f for f in findings
                if SEVERITIES.index(f.severity) >= floor]
    if baseline is not None:
        findings = baseline.filter(findings)
    return findings


def resolve_checks(select: Optional[Sequence[str]],
                   ignore: Optional[Sequence[str]]) -> List:
    known = {c.id: c for c in all_checks()}
    # GL501 also emits GL505/GL506 (one plugin, three drift shapes);
    # selection operates on the plugin's primary id.
    def pick(ids: Sequence[str]) -> set:
        out = set()
        for i in ids:
            i = i.strip()
            if not i:
                continue
            if i not in known:
                raise UsageError(
                    f"unknown check id {i!r}; known: "
                    f"{', '.join(sorted(known))}")
            out.add(i)
        return out

    selected = pick(select) if select else set(known)
    ignored = pick(ignore) if ignore else set()
    return [cls() for cid, cls in sorted(known.items())
            if cid in selected and cid not in ignored]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m generativeaiexamples_tpu_torch.lint",
        description="graftlint for the PyTorch port: serving-aware "
                    "static analysis (capture purity, lock discipline, "
                    "thread hygiene, host sync, config drift, multihost "
                    "replay)")
    p.add_argument("paths", nargs="*", help="files or directories to lint")
    p.add_argument("--baseline", metavar="FILE",
                   help="baseline suppression file (default: discover "
                        f"{BASELINE_FILENAME} walking up from the inputs)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline, report everything")
    p.add_argument("--write-baseline", metavar="FILE", nargs="?",
                   const=BASELINE_FILENAME,
                   help="write current findings as a baseline and exit 0")
    p.add_argument("--select", metavar="IDS",
                   help="comma-separated check ids to run (default: all)")
    p.add_argument("--ignore", metavar="IDS",
                   help="comma-separated check ids to skip")
    p.add_argument("--min-severity", choices=SEVERITIES, default="warning",
                   help="report only findings at or above this severity")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text",
                   help="sarif emits SARIF 2.1.0 for CI code annotations")
    p.add_argument("--sarif-out", metavar="FILE",
                   help="ALSO write the findings as SARIF to FILE "
                        "(alongside whatever --format prints) — lets "
                        "the CI gate run produce its annotation "
                        "artifact in the same pass")
    p.add_argument("--changed", action="store_true",
                   help="report only findings in git-changed files and "
                        "their reverse call-graph dependents (fast "
                        "pre-commit run; the full tree is still parsed "
                        "so cross-file checks stay sound)")
    p.add_argument("--fail-stale", action="store_true",
                   help="exit 1 when the baseline has stale entries "
                        "(suppressed nothing) on a complete run — CI "
                        "uses this so the baseline shrinks over time")
    p.add_argument("--explain-hot-path", metavar="FUNC",
                   help="print the hot-path root->FUNC call chain "
                        "(FUNC = name, Class.name, or module.py:name) "
                        "and exit: 0 hot, 1 not hot, 2 unknown")
    p.add_argument("--explain-dispatch-site", metavar="FUNC",
                   help="print FUNC's device-dispatch sites with their "
                        "scheduler-root->FUNC chains and publish "
                        "coverage (the GL701 inventory) and exit: "
                        "0 scheduler-reachable sites, 1 none, "
                        "2 unknown function")
    p.add_argument("--list-checks", action="store_true",
                   help="print the check catalog and exit")
    return p


def _git_changed_files(anchor: str) -> Optional[Set[str]]:
    """Absolute paths of .py files touched vs HEAD (worktree + staged +
    untracked), or None when git is unavailable."""
    def git(*args):
        return subprocess.run(
            ["git", *args], cwd=anchor, text=True, capture_output=True,
            timeout=30)
    top = git("rev-parse", "--show-toplevel")
    if top.returncode != 0:
        return None
    root = top.stdout.strip()
    out: Set[str] = set()
    for args in (("diff", "--name-only", "HEAD"),
                 ("diff", "--name-only", "--cached"),
                 ("ls-files", "--others", "--exclude-standard")):
        proc = git(*args)
        if proc.returncode != 0:
            continue
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line.endswith(".py"):
                out.add(os.path.abspath(os.path.join(root, line)))
    return out


def _changed_scope(project, changed_abs: Set[str]) -> Set[str]:
    """Rel paths to report on: changed project files plus their reverse
    call-graph dependents (a changed callee can push a caller onto the
    hot path or break its lock contract). A changed path that is no
    longer in the project (a DELETED module) has no call-graph nodes to
    walk back from — its former importers are found by matching their
    import tables against the deleted path, so the files whose edges
    just vanished still get re-checked."""
    from generativeaiexamples_tpu_torch.lint import callgraph

    present_abs = {os.path.abspath(sf.path): sf.rel
                   for sf in project.files}
    changed_rels = {present_abs[p] for p in changed_abs
                    if p in present_abs}
    graph = callgraph.build(project)
    scope = changed_rels | graph.dependent_files(changed_rels)
    deleted = [p for p in changed_abs if p not in present_abs]
    for path in deleted:
        # 'a/b/helper.py' is importable as any dotted suffix ending in
        # 'helper'; a file whose import table names such a module
        # depended on the deleted file.
        suffixes = _dotted_suffixes(path)
        for rel, idx in graph.file_index.items():
            imported = set(idx.module_imports.values()) | \
                {mod for mod, _ in idx.from_imports.values()} | \
                {f"{mod}.{orig}" for mod, orig
                 in idx.from_imports.values()}
            if any(m == s or m.endswith("." + s)
                   for m in imported for s in suffixes):
                scope.add(rel)
    return scope


def _dotted_suffixes(path: str) -> List[str]:
    """'/x/pkg/sub/helper.py' -> ['pkg.sub.helper', 'sub.helper',
    'helper'] — the dotted names an import of that file could use."""
    parts = path[:-3].replace(os.sep, "/").split("/")
    parts = [p for p in parts if p][-3:]
    return [".".join(parts[i:]) for i in range(len(parts))]


def _explain_hot_path(project, spec: str) -> int:
    from generativeaiexamples_tpu_torch.lint import callgraph
    from generativeaiexamples_tpu_torch.lint.checks import host_sync

    graph = callgraph.build(project)
    matches = graph.functions_named(spec)
    if not matches:
        print(f"error: no function matching {spec!r} in the linted "
              f"paths (try Class.name or module.py:name)",
              file=sys.stderr)
        return 2
    parent = host_sync.inferred_hot(graph)
    any_hot = False
    for node in matches:
        if node.key in parent:
            any_hot = True
            chain = graph.chain(parent, node.key)
            print(f"{node.sf.rel}:{node.node.lineno} {node.qual} is HOT:")
            for i, k in enumerate(chain):
                n = graph.nodes[k]
                root_mark = " (root)" if parent[k] is None else ""
                print(f"  {'  ' * i}-> {n.module}:{n.qual}{root_mark}")
        else:
            print(f"{node.sf.rel}:{node.node.lineno} {node.qual} is not "
                  f"in the inferred hot set (no call chain from any "
                  f"root: {sorted(host_sync.HOT_ROOTS)})")
    return 0 if any_hot else 1


def _explain_dispatch_site(project, spec: str) -> int:
    """GL701's inventory, queryable: FUNC's dispatch sites (or the
    sites dispatching INTO it when FUNC is a dispatch entry), each with its
    scheduler-root chain and publish coverage."""
    from generativeaiexamples_tpu_torch.lint import callgraph
    from generativeaiexamples_tpu_torch.lint.checks import multihost_safety

    graph = callgraph.build(project)
    inv = multihost_safety.inventory_for(project)
    matches = graph.functions_named(spec)
    keys = [n.key for n in matches]
    if not keys:
        print(f"error: no function matching {spec!r} in the linted "
              f"paths (try Class.name or module.py:name)",
              file=sys.stderr)
        return 2
    publishers = sorted(inv.publish_lines)
    unpub = graph.reachable(sorted(inv.roots), stop_at=publishers)
    any_reachable = False
    for key in keys:
        if key in inv.entries:
            # entry: show every scheduler-side site dispatching into it
            holders = [(k, ln) for k, sites in sorted(inv.sites.items())
                       for ln, dst in sites if dst == key]
            name = callgraph.entry_name(key)
            if not holders:
                print(f"{name} is a dispatch entry with no resolved "
                      f"scheduler-side dispatch site")
                continue
            print(f"{name} is a dispatch entry; dispatch sites:")
            for k, ln in holders:
                n = graph.nodes[k]
                mark = _publish_mark(inv, unpub, k, ln)
                print(f"  {n.sf.rel}:{ln} in {n.qual} [{mark}]")
                any_reachable |= k in inv.reach
            continue
        sites = inv.sites.get(key, [])
        node = graph.nodes[key]
        if not sites:
            print(f"{node.sf.rel}:{node.node.lineno} {node.qual} has no "
                  f"dispatch sites in the inventory")
            continue
        reach_here = key in inv.reach
        any_reachable |= reach_here
        state = "scheduler-reachable" if reach_here else \
            "NOT reachable from a scheduler root"
        print(f"{node.sf.rel}:{node.node.lineno} {node.qual} "
              f"({state}) dispatch sites:")
        for ln, dst in sites:
            mark = _publish_mark(inv, unpub, key, ln)
            print(f"  line {ln}: {callgraph.entry_name(dst)} [{mark}]")
        if reach_here:
            chain = graph.chain(inv.reach, key)
            for i, k in enumerate(chain):
                n = graph.nodes[k]
                root_mark = " (root)" if inv.reach[k] is None else ""
                print(f"  {'  ' * i}-> {n.module}:{n.qual}{root_mark}")
    return 0 if any_reachable else 1


def _publish_mark(inv, unpub, key: str, ln: int) -> str:
    if any(p < ln for p in inv.publish_lines.get(key, ())):
        return "published in-function"
    if key not in inv.reach:
        return "off the scheduler path"
    if key not in unpub:
        return "publish-covered on every scheduler path"
    return "UNPUBLISHED"


# Minimal SARIF 2.1.0 — enough for GitHub/GitLab code-annotation
# ingestion: one run, one rule per check id, results with physical
# locations and the baseline content hash as a stable fingerprint.
def _sarif_payload(findings: List[Finding]) -> dict:
    rules = {}
    for c in all_checks():
        rules[c.id] = {"id": c.id, "name": c.name,
                       "shortDescription": {"text": c.describe}}
    for f in findings:
        rules.setdefault(f.check, {"id": f.check, "name": f.name,
                                   "shortDescription": {"text": f.name}})
    level = {"error": "error", "warning": "warning"}
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                # informationUri omitted deliberately: the schema
                # requires an ABSOLUTE URI and this repo has no
                # canonical public URL; the catalog lives at
                # docs/static_analysis.md.
                "rules": sorted(rules.values(), key=lambda r: r["id"]),
            }},
            "results": [{
                "ruleId": f.check,
                "level": level.get(f.severity, "warning"),
                "message": {"text": f.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace(os.sep, "/")},
                    "region": {"startLine": f.line},
                }}],
                "partialFingerprints": {
                    "graftlintContentHash/v1": f.content_hash},
            } for f in findings],
        }],
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = _build_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        # argparse exits 2 on usage errors, 0 on --help; preserve both.
        return int(e.code or 0)

    if args.list_checks:
        for c in all_checks():
            print(f"{c.id}  {c.name:<22} [{c.severity}] {c.describe}")
        return 0

    if not args.paths:
        print("error: no paths given (try `python -m "
              "generativeaiexamples_tpu_torch.lint "
              "generativeaiexamples_tpu_torch/`)",
              file=sys.stderr)
        return 2

    for p in args.paths:
        if not os.path.exists(p):
            print(f"error: path does not exist: {p}", file=sys.stderr)
            return 2

    try:
        checks = resolve_checks(
            args.select.split(",") if args.select else None,
            args.ignore.split(",") if args.ignore else None)
    except UsageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    project = load_project(args.paths)

    if args.explain_hot_path:
        return _explain_hot_path(project, args.explain_hot_path)

    if args.explain_dispatch_site:
        return _explain_dispatch_site(project, args.explain_dispatch_site)

    findings = run_checks(project, checks)
    floor = SEVERITIES.index(args.min_severity)
    findings = [f for f in findings
                if SEVERITIES.index(f.severity) >= floor]

    scope_note = ""
    if args.changed:
        if args.write_baseline:
            # from_findings builds entries ONLY from current findings:
            # regenerating from a scope-filtered subset would silently
            # drop every curated entry outside the diff.
            print("error: --changed cannot be combined with "
                  "--write-baseline (a diff-scoped run would truncate "
                  "the baseline to the diff's findings)",
                  file=sys.stderr)
            return 2
        # Anchor git at the first input itself (its directory when the
        # input is a file) — the input lives in the repo; its PARENT
        # may not.
        anchor = os.path.abspath(args.paths[0])
        if not os.path.isdir(anchor):
            anchor = os.path.dirname(anchor) or "."
        changed = _git_changed_files(anchor)
        if changed is None:
            print("error: --changed needs a git checkout",
                  file=sys.stderr)
            return 2
        scope = _changed_scope(project, changed)
        findings = [f for f in findings if f.path in scope]
        scope_note = (f" [--changed: {len(scope)} file(s) in scope]"
                      if scope else " [--changed: nothing changed]")

    if args.write_baseline:
        # Merge reasons from the baseline being replaced (explicit or
        # discovered): regenerating must not clobber curated entries.
        try:
            prev = (Baseline.load(args.write_baseline)
                    if os.path.isfile(args.write_baseline)
                    else Baseline.discover(args.paths))
        except (OSError, ValueError, json.JSONDecodeError):
            prev = None
        Baseline.from_findings(findings, previous=prev).save(
            args.write_baseline)
        print(f"wrote {len(findings)} finding(s) to {args.write_baseline}; "
              f"add a real reason to every entry you keep")
        return 0

    baseline = None
    if not args.no_baseline:
        try:
            baseline = (Baseline.load(args.baseline) if args.baseline
                        else Baseline.discover(args.paths))
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: cannot load baseline: {e}", file=sys.stderr)
            return 2
    suppressed = 0
    if baseline is not None:
        before = len(findings)
        findings = baseline.filter(findings)
        suppressed = before - len(findings)

    # Stale-entry accounting only makes sense when every finding
    # reached the baseline: a --select/--ignore/--changed run (or a
    # raised severity floor, which filters findings BEFORE the
    # baseline sees them) legitimately never exercises some entries.
    complete_run = not (args.select or args.ignore or args.changed
                        or args.min_severity != "warning")
    stale = baseline.unused_entries() \
        if baseline is not None and complete_run else []

    if args.sarif_out:
        from generativeaiexamples_tpu_torch.utils.fsio import atomic_write_text

        atomic_write_text(args.sarif_out,
                          json.dumps(_sarif_payload(findings), indent=2)
                          + "\n")

    if args.format == "json":
        print(json.dumps([{
            "check": f.check, "name": f.name, "severity": f.severity,
            "path": f.path, "line": f.line, "message": f.message,
            "hash": f.content_hash,
        } for f in findings], indent=2))
    elif args.format == "sarif":
        print(json.dumps(_sarif_payload(findings), indent=2))
    else:
        for f in findings:
            print(f.format())
        summary = (f"{len(findings)} finding(s), {suppressed} baselined"
                   + (f", {len(stale)} STALE baseline entr"
                      f"{'y' if len(stale) == 1 else 'ies'} "
                      f"(fixed code — prune them)" if stale else "")
                   + scope_note)
        print(summary)
    if args.fail_stale and stale:
        for e in stale:
            print(f"stale baseline entry: {e.get('check')} "
                  f"{e.get('file')}:{e.get('line')} ({e.get('hash')}) — "
                  f"the code it justified was fixed; prune it",
                  file=sys.stderr)
        return 1
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
