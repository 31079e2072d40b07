"""GL301/GL302 background-thread hygiene.

GL301 — `threading.Thread(...)` without `daemon=True`: a forgotten
non-daemon worker keeps the process alive after main exits (the chain
server "hangs on shutdown" shape), and a crashed one leaves a zombie.

GL302 — broad `except` on a thread path that swallows the error: a
daemon thread has no caller to propagate to, so an `except Exception:
pass` silently drops the failure and the stats/logs stay green while
the subsystem is dead. The check walks every function reachable from a
`threading.Thread(target=...)` in the same module (self-method call
closure within the owning class) and flags bare/`Exception`/
`BaseException` handlers that neither re-raise, log, increment a
counter, call a `_fail*` handler, nor bind the exception into state
another thread reads.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from generativeaiexamples_tpu_torch.lint.core import Check, Finding, Project, \
    SourceFile
from generativeaiexamples_tpu_torch.lint.checks import _util as u

LOGGER_NAMES = {"_LOG", "_log", "LOG", "log", "logger", "LOGGER", "logging"}
LOGGING_METHODS = {"exception", "error", "warning", "warn", "info", "debug",
                   "critical", "log"}
# Loop/worker method-name conventions: dispatcher loops reached through
# engine plumbing (start() indirection, executor submission) rather than
# a literal Thread(target=...) in the same module.
WORKER_NAME_HINTS = ("_loop", "_worker", "loop", "worker", "run")


class ThreadDaemonCheck(Check):
    id = "GL301"
    name = "thread-daemon"
    severity = "warning"
    describe = "threading.Thread(...) without daemon=True"

    def run(self, project: Project) -> Iterable[Finding]:
        for sf in project.files:
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                if u.last_part(u.dotted(node.func)) != "Thread":
                    continue
                daemon = next((kw for kw in node.keywords
                               if kw.arg == "daemon"), None)
                if daemon is None:
                    yield self.finding(
                        sf, node.lineno,
                        "threading.Thread without daemon=True: a "
                        "non-daemon background thread blocks process "
                        "exit and outlives its owner")
                elif isinstance(daemon.value, ast.Constant) \
                        and daemon.value.value is not True:
                    yield self.finding(
                        sf, node.lineno,
                        "threading.Thread with daemon explicitly falsy: "
                        "this thread will block process exit")


class ThreadSwallowCheck(Check):
    id = "GL302"
    name = "thread-swallow"
    severity = "warning"
    describe = ("broad except on a thread-target path that neither "
                "logs, counts, re-raises, nor stores the error")

    def run(self, project: Project) -> Iterable[Finding]:
        for sf in project.files:
            if sf.tree is None:
                continue
            yield from self._check_file(sf)

    def _check_file(self, sf: SourceFile) -> Iterable[Finding]:
        for scope_fn, owner_cls in self._thread_scopes(sf.tree):
            for handler, kind in self._broad_handlers(scope_fn):
                if self._handler_is_honest(handler):
                    continue
                where = f"{owner_cls.name}.{scope_fn.name}" if owner_cls \
                    else scope_fn.name
                yield self.finding(
                    sf, handler.lineno,
                    f"broad `except {kind}` in thread path {where} "
                    f"swallows the error: nothing logs, counts, "
                    f"re-raises, or stores it — the thread dies or "
                    f"loops on silently")

    # -- scope discovery ---------------------------------------------------

    def _thread_scopes(self, tree: ast.Module
                       ) -> List[Tuple[ast.AST, Optional[ast.ClassDef]]]:
        """Functions that run on a background thread: Thread targets in
        this module, plus the self-method call closure from each target
        within its class, plus loop/worker-named methods of classes
        that spawn threads at all."""
        module_fns = {n.name: n for n in tree.body
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
        scopes: List[Tuple[ast.AST, Optional[ast.ClassDef]]] = []
        seen: Set[int] = set()

        def add(fn, cls):
            if id(fn) not in seen:
                seen.add(id(fn))
                scopes.append((fn, cls))

        for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
            methods = {m.name: m for m in cls.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            calls = {name: self._self_calls(m)
                     for name, m in methods.items()}
            targets = self._thread_targets(cls)
            spawns_threads = bool(targets)
            entry_names = {t for t in targets if isinstance(t, str)}
            if spawns_threads:
                entry_names |= {n for n in methods
                                if n.endswith(WORKER_NAME_HINTS)}
            # closure over self-method calls
            work = list(entry_names)
            reached: Set[str] = set()
            while work:
                n = work.pop()
                if n in reached or n not in methods:
                    continue
                reached.add(n)
                work.extend(calls.get(n, set()))
            for n in reached:
                add(methods[n], cls)
            # nested defs passed as targets (def run(): ... inside a
            # method) are thread bodies themselves
            for t in targets:
                if not isinstance(t, str):
                    add(t, cls)
                    for callee in self._self_calls(t):
                        if callee in methods and callee not in reached:
                            reached.add(callee)
                            add(methods[callee], cls)
        # module-level Thread(target=fn) on module-level functions
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and u.last_part(u.dotted(node.func)) == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target" and isinstance(kw.value, ast.Name) \
                            and kw.value.id in module_fns:
                        add(module_fns[kw.value.id], None)
        return scopes

    def _thread_targets(self, cls: ast.ClassDef) -> List:
        """Thread targets spawned inside `cls`: method names for
        `target=self._x`, FunctionDef nodes for local `def run()`."""
        out: List = []
        # map: method -> {local fn name: node} for nested-def resolution
        for method in ast.walk(cls):
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            local_defs = {n.name: n for n in ast.walk(method)
                          if isinstance(n, ast.FunctionDef)}
            for node in ast.walk(method):
                if not (isinstance(node, ast.Call) and
                        u.last_part(u.dotted(node.func)) == "Thread"):
                    continue
                for kw in node.keywords:
                    if kw.arg != "target":
                        continue
                    attr = u.self_attr_target(kw.value)
                    if attr:
                        out.append(attr)
                    elif isinstance(kw.value, ast.Name) \
                            and kw.value.id in local_defs:
                        out.append(local_defs[kw.value.id])
        return out

    def _self_calls(self, fn) -> Set[str]:
        """Names of self.X(...) methods called anywhere in `fn`
        (nested defs included — they execute on the same thread)."""
        out: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                attr = u.self_attr_target(node.func)
                if attr:
                    out.add(attr)
        return out

    # -- handler classification --------------------------------------------

    def _broad_handlers(self, fn) -> List[Tuple[ast.ExceptHandler, str]]:
        out = []
        for node in ast.walk(fn):
            if isinstance(node, ast.ExceptHandler):
                kind = u.handler_catches_broadly(node)
                if kind:
                    out.append((node, kind))
        return out

    def _handler_is_honest(self, handler: ast.ExceptHandler) -> bool:
        """True when the handler propagates the failure somewhere a
        human or a counter will see it."""
        exc_name = handler.name
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.AugAssign):
                return True  # counter increment
            if isinstance(node, ast.Call):
                name = u.dotted(node.func)
                last = u.last_part(name)
                root = (name or "").split(".")[0]
                if last in LOGGING_METHODS and (
                        root in LOGGER_NAMES or root == "self"
                        or (name or "").startswith("logging.")):
                    return True
                if last.startswith(("note_", "record_", "count_", "inc")):
                    return True
                if last.startswith("_fail") or "fail" in last:
                    return True  # engine-style fail-the-batch handlers
            if isinstance(node, ast.Assign) and exc_name:
                # `box["err"] = e` / `results, error = None, e` — the
                # error is bound into state another thread consumes.
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Name) and sub.id == exc_name:
                        return True
        return False
