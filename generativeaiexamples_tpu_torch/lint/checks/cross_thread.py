"""GL202 cross-thread race detection: attribute state shared between a
thread entry and the public surface with no common lock on any path.

GL201 is lexical: it flags an attribute written both inside and outside
`with self.<lock>:` blocks, and TRUSTS a "Lock held" docstring. This
check is the interprocedural completion over lint/callgraph.py:

- **Thread entries** — `threading.Thread(target=self._x)` /
  `executor.submit(self._x, ...)` targets of the class, plus every
  class function reachable from them through in-class calls.
- **Entry locks, computed not trusted** — a method invoked ONLY from
  call sites that hold lock L is treated as holding L throughout
  (greatest-fixed-point over in-class call sites; `__init__` call
  sites are ignored — construction is single-threaded). This makes
  the "Lock held" convention *verifiable*: the docstring no longer
  moves the analysis, the call sites do.
- **The race shape** — an attribute WRITTEN from thread-entry-reachable
  code and read or written from public-method-reachable code, where
  the two sites' guaranteed lock sets are disjoint, is flagged —
  provided at least one side holds some lock (a fully lock-free
  attribute is the documented single-writer pattern, e.g.
  EngineMetrics, and stays GL201/GL202-quiet by design).
- **Docstring verification** — a method whose docstring declares
  "Lock held" but which has an in-class call site holding NO owned
  lock is flagged at the def line: the convention is violated where
  it was being trusted.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterable, List, Optional, Set

from generativeaiexamples_tpu_torch.lint.core import Check, Finding, Project, \
    SourceFile
from generativeaiexamples_tpu_torch.lint import callgraph
from generativeaiexamples_tpu_torch.lint.checks import _util as u
from generativeaiexamples_tpu_torch.lint.checks.lock_discipline import (
    CONSTRUCTOR_METHODS, LOCK_HELD_RE, LOCK_TYPES)


class _Access:
    __slots__ = ("attr", "lineno", "write", "locks", "fn_key")

    def __init__(self, attr: str, lineno: int, write: bool,
                 locks: FrozenSet[str], fn_key: str):
        self.attr = attr
        self.lineno = lineno
        self.write = write
        self.locks = locks
        self.fn_key = fn_key


class _CallSite:
    __slots__ = ("callee", "locks", "caller", "lineno")

    def __init__(self, callee: str, locks: FrozenSet[str], caller: str,
                 lineno: int):
        self.callee = callee
        self.locks = locks
        self.caller = caller
        self.lineno = lineno


class CrossThreadRaceCheck(Check):
    id = "GL202"
    name = "cross-thread-race"
    severity = "warning"
    describe = ("attribute written from a thread entry and accessed "
                "from a public method with no common lock on any call "
                "path; 'Lock held' docstrings verified against real "
                "call sites")

    def run(self, project: Project) -> Iterable[Finding]:
        graph = callgraph.build(project)
        for info in graph.classes.values():
            locks = self._lock_attrs(graph, info)
            if not locks:
                continue
            yield from self._check_class(graph, info, locks)

    # -- lock ownership (same detection as GL201, resolved bases) ----------

    def _lock_attrs(self, graph, info,
                    _seen: Optional[Set] = None) -> FrozenSet[str]:
        seen = _seen if _seen is not None else set()
        if info is None or info.key in seen:
            return frozenset()
        seen.add(info.key)
        locks: Set[str] = set()
        for node in ast.walk(info.node):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                if u.last_part(u.dotted(node.value.func)) in LOCK_TYPES:
                    for t in node.targets:
                        attr = u.self_attr_target(t)
                        if attr:
                            locks.add(attr)
        for base_key in info.bases:
            locks |= self._lock_attrs(graph, graph.classes.get(base_key),
                                      seen)
        return frozenset(locks)

    # -- per-class analysis -------------------------------------------------

    def _class_functions(self, graph, info) -> Dict[str, "callgraph.FuncNode"]:
        """The class's methods AND their nested defs (thread bodies,
        callbacks), keyed by call-graph key."""
        out = {}
        method_keys = set(info.methods.values())
        for key, node in graph.nodes.items():
            if key in method_keys:
                out[key] = node
            elif node.parent_key is not None and node.sf.rel == info.sf.rel:
                # nested def under one of this class's methods
                top = node
                while top.parent_key is not None and \
                        top.parent_key in graph.nodes:
                    top = graph.nodes[top.parent_key]
                if top.key in method_keys:
                    out[key] = node
        return out

    def _check_class(self, graph, info,
                     locks: FrozenSet[str]) -> Iterable[Finding]:
        funcs = self._class_functions(graph, info)
        if not funcs:
            return
        sf = info.sf
        accesses: List[_Access] = []
        sites: List[_CallSite] = []
        for key, fnode in funcs.items():
            self._collect(sf, fnode, key, funcs, locks, accesses, sites)

        entry = self._entry_locks(info, funcs, sites, locks, graph)

        # docstring verification: "Lock held" with a lock-free call site
        for key, fnode in funcs.items():
            if not LOCK_HELD_RE.search(u.docstring_of(fnode.node)):
                continue
            bare = [s for s in sites if s.callee == key
                    and not ((s.locks | entry.get(s.caller, frozenset()))
                             & locks)
                    and funcs[s.caller].name not in CONSTRUCTOR_METHODS]
            if bare:
                caller = funcs[bare[0].caller]
                yield self.finding(
                    sf, fnode.node.lineno,
                    f"{info.name}.{fnode.name} documents 'Lock held' but "
                    f"{caller.qual} (line {bare[0].lineno}) calls it "
                    f"holding none of: "
                    f"{', '.join('self.' + n for n in sorted(locks))}")

        # the cross-thread attribute race shape
        thread_entries = {k for k in funcs
                          if any(k in dsts
                                 for dsts in graph.spawns.values())}
        if not thread_entries:
            return
        in_class_calls: Dict[str, Set[str]] = {}
        for s in sites:
            in_class_calls.setdefault(s.caller, set()).add(s.callee)
        thread_side = self._closure(thread_entries, in_class_calls)
        public = {k for k, n in funcs.items()
                  if n.parent_key is None and not n.name.startswith("_")
                  and n.cls_name == info.name}
        public_side = self._closure(public, in_class_calls)

        seen_anchor = set()
        by_attr: Dict[str, List[_Access]] = {}
        for a in accesses:
            if a.attr not in locks and \
                    funcs[a.fn_key].name not in CONSTRUCTOR_METHODS:
                by_attr.setdefault(a.attr, []).append(a)
        for attr, accs in sorted(by_attr.items()):
            twrites = [a for a in accs if a.write
                       and a.fn_key in thread_side]
            paccs = [a for a in accs if a.fn_key in public_side
                     and a.fn_key not in thread_entries]
            for tw in twrites:
                lt = tw.locks | (entry.get(tw.fn_key) or frozenset())
                for pa in paccs:
                    if pa is tw:
                        continue
                    lp = pa.locks | (entry.get(pa.fn_key) or frozenset())
                    if (lt & lp & locks) or not ((lt | lp) & locks):
                        continue
                    anchor = tw if len(lt & locks) <= len(lp & locks) else pa
                    if (attr, anchor.lineno) in seen_anchor:
                        continue
                    seen_anchor.add((attr, anchor.lineno))
                    kind = "written" if pa.write else "read"
                    yield self.finding(
                        sf, anchor.lineno,
                        f"{info.name}.{attr} is written on the "
                        f"{funcs[tw.fn_key].qual} thread path (line "
                        f"{tw.lineno}) and {kind} on the public "
                        f"{funcs[pa.fn_key].qual} path (line {pa.lineno}) "
                        f"with no common lock on either side; take the "
                        f"same self.<lock> on both sides or baseline "
                        f"with a reason")

    @staticmethod
    def _closure(roots: Set[str], edges: Dict[str, Set[str]]) -> Set[str]:
        out = set(roots)
        work = list(roots)
        while work:
            k = work.pop()
            for d in edges.get(k, ()):
                if d not in out:
                    out.add(d)
                    work.append(d)
        return out

    # -- collection ---------------------------------------------------------

    def _collect(self, sf: SourceFile, fnode, key: str, funcs, locks,
                 accesses: List[_Access], sites: List[_CallSite]) -> None:
        """Record attribute accesses and in-class call sites of `fnode`
        with their lexical lock context (nested defs are separate
        functions — handled by their own _collect pass)."""
        fn = fnode.node
        by_name = {n.name: k for k, n in funcs.items()
                   if n.parent_key == key}
        method_by_name = {n.name: k for k, n in funcs.items()
                          if n.parent_key is None}

        def walk(node: ast.AST, held: FrozenSet[str]) -> None:
            if isinstance(node, ast.With):
                item_locks = {u.self_attr_target(it.context_expr)
                              for it in node.items} & set(locks)
                inner = held | frozenset(item_locks)
                for it in node.items:
                    walk(it.context_expr, held)
                for child in node.body:
                    walk(child, inner)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)) and node is not fn:
                return  # nested defs analyzed as their own functions
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                # A WRITE is a rebind of the attribute itself (`self.x =`
                # / `self.x += ...`, tuple unpack included). Deeper
                # targets (`self.x[i] = ...`, `self.x.y = ...`) mutate
                # the object but leave the binding alone — they count as
                # reads of self.x, like any other dereference.
                for t in targets:
                    els = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                        else [t]
                    for el in els:
                        attr = u.self_attr_target(el)
                        if attr:
                            accesses.append(_Access(attr, node.lineno,
                                                    True, held, key))
                        else:
                            walk(el, held)
                if node.value is not None:
                    walk(node.value, held)
                return
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.ctx, ast.Load):
                attr = u.self_attr_target(node)
                if attr:
                    accesses.append(_Access(attr, node.lineno, False,
                                            held, key))
            if isinstance(node, ast.Call):
                callee = None
                attr = u.self_attr_target(u.unwrap_partial(node.func))
                if attr is not None and attr in method_by_name:
                    callee = method_by_name[attr]
                elif isinstance(node.func, ast.Name) and \
                        node.func.id in by_name:
                    callee = by_name[node.func.id]
                if callee is not None:
                    sites.append(_CallSite(callee, held, key, node.lineno))
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        for stmt in fn.body:
            walk(stmt, frozenset())

    # -- entry-lock fixed point ---------------------------------------------

    def _entry_locks(self, info, funcs, sites: List[_CallSite],
                     locks: FrozenSet[str], graph
                     ) -> Dict[str, FrozenSet[str]]:
        """Greatest fixed point of: entry(f) = ∩ over in-class call
        sites of (site locks ∪ entry(caller)). Public methods, thread
        entries and functions with no in-class call sites start (and
        stay) at ∅; `__init__` call sites are ignored."""
        spawn_targets = set()
        for dsts in graph.spawns.values():
            spawn_targets |= dsts
        callers: Dict[str, List[_CallSite]] = {}
        for s in sites:
            if funcs[s.caller].name in CONSTRUCTOR_METHODS:
                continue
            callers.setdefault(s.callee, []).append(s)

        entry: Dict[str, FrozenSet[str]] = {}
        for key, fnode in funcs.items():
            open_entry = (
                fnode.parent_key is None
                and not fnode.name.startswith("_")) \
                or key in spawn_targets \
                or key not in callers
            entry[key] = frozenset() if open_entry else locks
        changed = True
        while changed:
            changed = False
            for key in funcs:
                if not entry[key]:
                    continue
                new = entry[key]
                for s in callers.get(key, ()):
                    new = new & (s.locks | entry[s.caller])
                if new != entry[key]:
                    entry[key] = new
                    changed = True
        return entry
