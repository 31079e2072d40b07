"""GL502 atomic-persistence: durable artifacts must be written via the
temp-file + ``os.replace`` idiom.

PR 2 established the rule for the vector store (vectors.npz /
docs.jsonl / ivf.npz) and PR 8 for the tiered spill file: a persisted
artifact is NEVER rewritten in place, because a crash mid-write leaves
a truncated file that poisons the next load. The idiom is::

    def write(tmp):
        with open(tmp, "wb") as fh: ...
    _atomic_replace(final_path, write)        # or inline:
    with open(tmp, "w") as fh: ...
    os.replace(tmp, final_path)

This check finds direct writes (``open(path, "w"/"wb"/"a")``,
``np.savez*`` / ``json.dump`` to such a handle) that bypass it, scoped
to PERSISTENCE sites so scratch/upload/report-once files stay quiet:

- the enclosing function is a persistence routine by name
  (``save`` / ``_save_*`` / ``*_persist*`` / ``save_state`` /
  ``_dump_*`` / ``flush_state``), or
- a reverse call-graph chain (lint/callgraph.py) from the write
  reaches a function whose source mentions ``persist_dir`` /
  ``spill_dir`` — the artifact provably lives under the configured
  persistence roots.

Exempt: paths staged through a tmp-named variable or literal (the
idiom's first half), and functions whose own body (or a lexically
enclosing function — the ``_atomic_replace(path, write_fn)`` shape)
performs the ``os.replace`` / ``os.rename``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Set, Tuple

from generativeaiexamples_tpu_torch.lint.core import Check, Finding, Project
from generativeaiexamples_tpu_torch.lint import callgraph
from generativeaiexamples_tpu_torch.lint.checks import _util as u

SAVE_NAME_RE = re.compile(
    r"(^|_)(save|persist|dump|flush)(_|$)|persist", re.IGNORECASE)
TAINT_RE = re.compile(r"persist_dir|spill_dir")
TMP_RE = re.compile(r"tmp|temp", re.IGNORECASE)
WRITE_MODES = ("w", "wb", "w+", "wb+", "a", "ab", "x", "xb")
SAVEZ_NAMES = ("savez", "savez_compressed", "save")
# reverse-chain search depth: enough for save() -> _persist() -> caller
MAX_TAINT_DEPTH = 4


def _expr_text(node: ast.AST) -> str:
    """Identifier parts + string literals of a path expression, joined
    — the haystack for tmp-name detection."""
    parts: List[str] = []
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            parts.append(n.id)
        elif isinstance(n, ast.Attribute):
            parts.append(n.attr)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            parts.append(n.value)
    return " ".join(parts)


def _fn_source(fnode) -> str:
    end = getattr(fnode.node, "end_lineno", fnode.node.lineno)
    return "\n".join(fnode.sf.lines[fnode.node.lineno - 1:end])


class AtomicPersistenceCheck(Check):
    id = "GL502"
    name = "atomic-persistence"
    severity = "warning"
    describe = ("persisted artifact written in place (open/np.savez "
                "without the tmp + os.replace idiom) — a crash "
                "mid-write corrupts the artifact for the next load")

    def run(self, project: Project) -> Iterable[Finding]:
        graph = callgraph.build(project)
        rcalls = graph.reverse_calls()
        for key, fnode in sorted(graph.nodes.items()):
            writes = self._direct_writes(fnode)
            if not writes:
                continue
            if self._replace_in_scope(graph, fnode):
                continue
            why = self._persistence_context(graph, rcalls, key, fnode)
            if why is None:
                continue
            for lineno, what in writes:
                yield self.finding(
                    fnode.sf, lineno,
                    f"{what} writes a persisted artifact in place "
                    f"({why}); a crash mid-write corrupts it — write "
                    f"to a tmp file and os.replace() into place "
                    f"(see vectorstore._atomic_replace)")

    # -- direct non-atomic writes ------------------------------------------

    def _direct_writes(self, fnode) -> List[Tuple[int, str]]:
        fn = fnode.node
        out: List[Tuple[int, str]] = []
        # `with open(...) as fh` aliases: np.savez(fh)/json.dump(_, fh)
        # rides the open() decision, so the alias itself is not a sink.
        open_aliases: Set[str] = set()
        for node in u.walk_stop_at_functions(fn, include_root=False):
            if isinstance(node, ast.With):
                for it in node.items:
                    if isinstance(it.context_expr, ast.Call) and \
                            u.last_part(u.dotted(it.context_expr.func)) \
                            == "open" and isinstance(it.optional_vars,
                                                     ast.Name):
                        open_aliases.add(it.optional_vars.id)
        for node in u.walk_stop_at_functions(fn, include_root=False):
            if not isinstance(node, ast.Call):
                continue
            name = u.dotted(node.func)
            last = u.last_part(name)
            if last == "open" and name in ("open", "io.open") \
                    and node.args:
                mode = None
                if len(node.args) >= 2 and isinstance(node.args[1],
                                                      ast.Constant):
                    mode = node.args[1].value
                for kw in node.keywords:
                    if kw.arg == "mode" and isinstance(kw.value,
                                                       ast.Constant):
                        mode = kw.value.value
                if not (isinstance(mode, str) and mode in WRITE_MODES):
                    continue
                if TMP_RE.search(_expr_text(node.args[0])):
                    continue
                out.append((node.lineno, f'open(..., "{mode}")'))
            elif last in SAVEZ_NAMES and name and \
                    name.split(".")[0] in ("np", "numpy") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Name) and arg.id in open_aliases:
                    continue  # handle from an already-judged open()
                if TMP_RE.search(_expr_text(arg)):
                    continue
                out.append((node.lineno, f"{name}()"))
        return out

    # -- exemption: the idiom is present ------------------------------------

    def _replace_in_scope(self, graph, fnode) -> bool:
        """os.replace/os.rename in the function itself or a lexically
        enclosing function (nested write-fns handed to an atomic
        helper)."""
        node = fnode
        while node is not None:
            for n in u.walk_stop_at_functions(node.node,
                                              include_root=False):
                if isinstance(n, ast.Call) and u.dotted(n.func) in (
                        "os.replace", "os.rename"):
                    return True
            node = graph.nodes.get(node.parent_key) \
                if node.parent_key else None
        return False

    # -- persistence scoping ------------------------------------------------

    def _persistence_context(self, graph, rcalls, key: str,
                             fnode) -> Optional[str]:
        qual = f"{fnode.cls_name}.{fnode.name}" if fnode.cls_name \
            else fnode.name
        if SAVE_NAME_RE.search(fnode.name):
            return f"persistence routine {qual}"
        if TAINT_RE.search(_fn_source(fnode)):
            return f"{qual} handles persist_dir/spill_dir paths"
        # reverse call chains: a caller that provably works under the
        # persistence roots makes this write durable state.
        seen = {key}
        frontier = [key]
        for _ in range(MAX_TAINT_DEPTH):
            nxt: List[str] = []
            for k in frontier:
                for caller in sorted(rcalls.get(k, ())):
                    if caller in seen:
                        continue
                    seen.add(caller)
                    cn = graph.nodes[caller]
                    if TAINT_RE.search(_fn_source(cn)):
                        return (f"called from {cn.module}:{cn.qual}, "
                                f"which handles persist_dir/spill_dir")
                    nxt.append(caller)
            frontier = nxt
        return None
