"""GL601 metrics-contract: every counter incremented on a metrics
object must be surfaced by that object's snapshot()/stats().

The repo's observability contract — restated in every PR since PR 1 —
is "counters ALWAYS present: 0, never absent". Its failure mode is
silent: someone adds `self.metrics.new_thing += 1` on the scheduler
thread and forgets the `snapshot()` key, no test fails, and the gauge
simply never exists. This check mechanizes the write->surface half of
the contract over lint/callgraph.py's class-attribute dataflow:

For every class that defines a ``snapshot()`` or ``stats()`` method
returning a dict, every attribute incremented via ``+=`` —

- inside the class itself (``MicroBatchStats.note_dispatch`` style), or
- externally through a resolved instance attribute
  (``self.metrics.tokens_out += 1`` in engine.py resolves to
  ``EngineMetrics`` because ``self.metrics = EngineMetrics()``)

— must be *surfaced* by the snapshot method: read while building the
return dict (``"tokens_generated": self.tokens_out`` counts), listed as
a literal dict key of the same name, or covered by a resolvable
module-level key tuple (the ``ROUTER_COUNTER_KEYS`` /
``getattr(self, k) for k in KEYS`` idiom). ``super().stats()``
delegation inherits the base class's surfaced set.

An incremented attribute that snapshot ignores but OTHER class logic
reads (a round-robin cursor, a watermark) is functional state, not a
lost counter, and is exempt — the flagged shape is write-only-and-
never-surfaced, which is always a bug.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from generativeaiexamples_tpu_torch.lint.core import Check, Finding, Project
from generativeaiexamples_tpu_torch.lint import callgraph
from generativeaiexamples_tpu_torch.lint.checks import _util as u
from generativeaiexamples_tpu_torch.lint.checks.lock_discipline import (
    CONSTRUCTOR_METHODS)

SNAPSHOT_NAMES = ("snapshot", "stats")


class _ClassContract:
    __slots__ = ("info", "snap_name", "surfaced", "snap_reads",
                 "other_reads", "incs")

    def __init__(self, info):
        self.info = info
        self.snap_name: str = ""
        self.surfaced: Set[str] = set()     # emitted dict keys
        self.snap_reads: Set[str] = set()   # self.X loaded in snapshot
        self.other_reads: Set[str] = set()  # self.X loaded elsewhere
        # attr -> [(SourceFile, lineno, where)] increment sites
        self.incs: Dict[str, List[Tuple]] = {}


class MetricsContractCheck(Check):
    id = "GL601"
    name = "metrics-contract"
    severity = "warning"
    describe = ("counter incremented on a snapshot()/stats() object "
                "but never surfaced in (or read by) the snapshot — "
                "the always-present counter contract, mechanized")

    def run(self, project: Project) -> Iterable[Finding]:
        graph = callgraph.build(project)
        contracts: Dict[Tuple[str, str], _ClassContract] = {}
        for cls_key, info in graph.classes.items():
            snap = next((n for n in SNAPSHOT_NAMES if n in info.methods),
                        None)
            if snap is None:
                continue
            c = _ClassContract(info)
            c.snap_name = snap
            self._analyze_snapshot(graph, info, snap, c, set())
            self._collect_internal(graph, info, snap, c)
            contracts[cls_key] = c

        self._collect_external(graph, contracts)

        for cls_key in sorted(contracts):
            c = contracts[cls_key]
            for attr in sorted(c.incs):
                if attr in c.surfaced or attr in c.snap_reads \
                        or attr in c.other_reads:
                    continue
                sf, lineno, where = c.incs[attr][0]
                yield self.finding(
                    sf, lineno,
                    f"{c.info.name}.{attr} is incremented ({where}) but "
                    f"{c.info.name}.{c.snap_name}() never surfaces it — "
                    f"the counter can never reach /metrics; add the key "
                    f"(present even when 0) or drop the counter")

    # -- snapshot analysis --------------------------------------------------

    def _analyze_snapshot(self, graph, info, snap: str, c: _ClassContract,
                          seen: Set) -> None:
        """Fill surfaced keys + attrs read, following super() delegation
        into resolved base classes."""
        if info is None or info.key in seen:
            return
        seen.add(info.key)
        key = graph.method_key(info, snap)
        if key is None:
            return
        fnode = graph.nodes[key]
        fn, rel = fnode.node, fnode.sf.rel

        def surface_iterable(node) -> None:
            if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
                c.surfaced.update(s for s in u.str_constants(node))
            elif isinstance(node, ast.Name):
                resolved = graph.str_sequence(rel, node.id)
                if resolved:
                    c.surfaced.update(resolved)

        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                for k in node.keys:
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str):
                        c.surfaced.add(k.value)
            elif isinstance(node, (ast.DictComp, ast.comprehension)):
                if isinstance(node, ast.DictComp):
                    for gen in node.generators:
                        surface_iterable(gen.iter)
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Store) and \
                    isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, str):
                c.surfaced.add(node.slice.value)
            elif isinstance(node, ast.Call):
                name = u.dotted(node.func)
                last = u.last_part(name)
                if last == "fromkeys" and node.args:
                    surface_iterable(node.args[0])
                elif last == "getattr" or (isinstance(node.func, ast.Name)
                                           and node.func.id == "getattr"):
                    pass  # getattr(self, k): covered by the key source
                # super().stats() / super().snapshot() delegation
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in SNAPSHOT_NAMES \
                        and isinstance(node.func.value, ast.Call) \
                        and u.last_part(
                            u.dotted(node.func.value.func)) == "super":
                    for base_key in info.bases:
                        self._analyze_snapshot(
                            graph, graph.classes.get(base_key),
                            node.func.attr, c, seen)
            elif isinstance(node, ast.Attribute) and \
                    isinstance(node.ctx, ast.Load):
                attr = u.self_attr_target(node)
                if attr:
                    c.snap_reads.add(attr)

    # -- increment / read collection ---------------------------------------

    def _collect_internal(self, graph, info, snap: str,
                          c: _ClassContract) -> None:
        for mname, mkey in info.methods.items():
            fnode = graph.nodes[mkey]
            for node in ast.walk(fnode.node):
                if isinstance(node, ast.AugAssign):
                    attr = u.self_attr_target(node.target)
                    if attr and mname not in CONSTRUCTOR_METHODS:
                        c.incs.setdefault(attr, []).append(
                            (fnode.sf, node.lineno,
                             f"in {info.name}.{mname}"))
                elif isinstance(node, ast.Attribute) and \
                        isinstance(node.ctx, ast.Load) \
                        and mname != snap:
                    attr = u.self_attr_target(node)
                    if attr:
                        c.other_reads.add(attr)

    def _collect_external(self, graph, contracts) -> None:
        """`self.<a>.X += 1` / `self.<a>.X` loads where `self.<a>`
        resolves (attribute dataflow) to a contract-bearing class."""
        def owner_of(node) -> Optional[_ClassContract]:
            # node: Attribute(value=Attribute(value=Name self, attr=a), X)
            if not isinstance(node, ast.Attribute):
                return None
            inner = u.self_attr_target(node.value)
            if inner is None:
                return None
            return inner, node.attr

        for fkey, fnode in graph.nodes.items():
            if fnode.cls_name is None:
                holder = None
            else:
                holder = graph.classes.get((fnode.sf.rel, fnode.cls_name))
            if holder is None:
                continue
            for node in ast.walk(fnode.node):
                ref = None
                if isinstance(node, ast.AugAssign):
                    ref = owner_of(node.target)
                    is_inc = True
                elif isinstance(node, ast.Attribute) and \
                        isinstance(node.ctx, ast.Load):
                    ref = owner_of(node)
                    is_inc = False
                if ref is None:
                    continue
                inner, attr = ref
                target_cls = holder.attr_cls.get(inner)
                if target_cls is None or target_cls not in contracts:
                    continue
                c = contracts[target_cls]
                if is_inc:
                    c.incs.setdefault(attr, []).append(
                        (fnode.sf, node.lineno,
                         f"from {holder.name}.{fnode.name} via "
                         f"self.{inner}"))
                else:
                    c.other_reads.add(attr)
