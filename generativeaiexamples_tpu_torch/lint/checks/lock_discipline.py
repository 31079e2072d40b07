"""GL201 lock-discipline: attributes written both with and without
their owner's lock.

For every class that owns a `threading.Lock` / `RLock` / `Condition`
attribute, each `self._x = ...` / `self._x += ...` write site is
classified as lock-held (lexically inside a `with self.<lock>:` block)
or bare. An attribute written BOTH ways is the classic check-then-act
race shape: one thread mutates under the lock while another clobbers
it bare, and no test will catch the interleaving.

This is a heuristic (no interprocedural lock tracking), so two escape
hatches exist for the common legitimate shapes:

- `__init__` writes are ignored (construction is single-threaded).
- A method whose docstring declares the convention — "lock held",
  "caller holds the lock", "cond held" — is treated as lock-held
  throughout: the class documents that its callers own the lock.

Everything else is a finding: either add the missing `with`, move the
write under the documented convention, or baseline it with a reason.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from generativeaiexamples_tpu_torch.lint.core import Check, Finding, Project, \
    SourceFile
from generativeaiexamples_tpu_torch.lint.checks import _util as u

LOCK_TYPES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
LOCK_HELD_RE = re.compile(
    r"(?i)\b(?:lock|cond(?:ition)?)\s+(?:is\s+)?held"
    r"|\bcaller\s+holds\b|\bholds?\s+the\s+lock\b|\block-held\b")
CONSTRUCTOR_METHODS = {"__init__", "__new__", "__post_init__"}


class LockDisciplineCheck(Check):
    id = "GL201"
    name = "lock-discipline"
    severity = "warning"
    describe = ("attribute written both inside and outside its owning "
                "class's `with self.<lock>:` blocks")

    def run(self, project: Project) -> Iterable[Finding]:
        for sf in project.files:
            if sf.tree is None:
                continue
            classes = {n.name: n for n in sf.tree.body
                       if isinstance(n, ast.ClassDef)}
            for cls in classes.values():
                yield from self._check_class(sf, cls, classes)

    def _check_class(self, sf: SourceFile, cls: ast.ClassDef,
                     classes: Dict[str, ast.ClassDef]) -> Iterable[Finding]:
        locks = self._lock_attrs(cls, classes)
        if not locks:
            return
        # (attr) -> list of (locked?, lineno, method-name)
        writes: Dict[str, List[Tuple[bool, int, str]]] = {}
        for method in self._methods(cls):
            if method.name in CONSTRUCTOR_METHODS:
                continue
            held_everywhere = bool(
                LOCK_HELD_RE.search(u.docstring_of(method)))
            self._collect_writes(method, locks, held_everywhere,
                                 writes, method.name)
        for attr, sites in sorted(writes.items()):
            if attr in locks:
                continue
            locked = [s for s in sites if s[0]]
            bare = [s for s in sites if not s[0]]
            if locked and bare:
                lock_names = ", ".join(f"self.{n}" for n in sorted(locks))
                for _, lineno, meth in bare:
                    yield self.finding(
                        sf, lineno,
                        f"{cls.name}.{attr} is written under "
                        f"{lock_names} in {len(locked)} place(s) but bare "
                        f"here (in {meth}); hold the lock, document the "
                        f"method as 'lock held', or baseline with a reason")

    # -- collection --------------------------------------------------------

    def _methods(self, cls: ast.ClassDef):
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    def _lock_attrs(self, cls: ast.ClassDef,
                    classes: Dict[str, ast.ClassDef],
                    _seen: Optional[Set[str]] = None) -> Set[str]:
        """self attributes assigned threading.Lock()/RLock()/Condition()
        anywhere in the class, plus same-module base classes'."""
        seen = _seen if _seen is not None else set()
        if cls.name in seen:
            return set()
        seen.add(cls.name)
        locks: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                name = u.dotted(node.value.func)
                if u.last_part(name) in LOCK_TYPES:
                    for t in node.targets:
                        attr = u.self_attr_target(t)
                        if attr:
                            locks.add(attr)
        for base in cls.bases:
            base_name = u.last_part(u.dotted(base))
            if base_name in classes:
                locks |= self._lock_attrs(classes[base_name], classes, seen)
        return locks

    def _collect_writes(self, fn, locks: Set[str], held: bool,
                        writes: Dict[str, List[Tuple[bool, int, str]]],
                        method_name: str) -> None:
        """Record every `self.X = ...` write in `fn` with its lock
        context. Nested defs (thread bodies, callbacks) are walked too
        — they run later, OUTSIDE any lexically-enclosing `with`, so
        their lock context restarts at bare (unless they document the
        convention themselves)."""

        def walk(node: ast.AST, locked: bool) -> None:
            if isinstance(node, ast.With):
                item_locks = any(
                    u.self_attr_target(it.context_expr) in locks
                    for it in node.items)
                inner = locked or item_locks
                for child in node.body:
                    walk(child, inner)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                nested_held = bool(LOCK_HELD_RE.search(u.docstring_of(node)))
                for child in node.body:
                    walk(child, nested_held)
                return
            if isinstance(node, ast.Lambda) or isinstance(node, ast.ClassDef):
                return
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    for el in ast.walk(t):
                        attr = u.self_attr_target(el)
                        if attr:
                            writes.setdefault(attr, []).append(
                                (locked, node.lineno, method_name))
            for child in ast.iter_child_nodes(node):
                walk(child, locked)

        for stmt in fn.body:
            walk(stmt, held)
