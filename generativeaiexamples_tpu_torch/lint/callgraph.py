"""Project call graph + class-attribute dataflow for graftlint.

Per-function AST walks (PR 4's checks) cannot answer the questions the
serving stack's invariants actually pose: *is this helper on the engine
step loop's dispatch path?* (GL402), *is this attribute ever touched
lock-free on a path a thread entry and a public method share?* (GL202),
*does anything increment a counter the metrics snapshot never
surfaces?* (GL601). This module builds the shared interprocedural layer
those checks (and the CLI's ``--explain-hot-path`` / ``--changed``)
query:

- **Function index** — every module-level function, class method and
  nested ``def`` in the project, keyed ``<rel-path>::<qualname>``.
- **Call edges** — resolved same-thread calls: ``self.method()``
  dispatch (same-module and imported base classes merged),
  bare-name calls (local defs, module functions, intra-package
  imports), ``module.func()`` through import aliases,
  ``self.<attr>.method()`` through inferred attribute classes, and
  function references passed as plain call arguments (synchronous
  callbacks like ``_atomic_replace(path, write_fn)``).
- **Spawn edges** — ``threading.Thread(target=...)`` and
  ``executor.submit(fn, ...)`` entries, kept SEPARATE from call edges:
  the spawned function runs on another thread, so hot-path
  reachability must not cross a spawn, while race detection must.
- **Attribute classes** — ``self.x = ClassName(...)`` assignments and
  ``__init__`` parameter annotations, so ``self.metrics.tokens_out``
  resolves to ``EngineMetrics`` without executing anything.
- **Dispatch-site inventory** — per-call-site line numbers
  (``call_sites``), dispatch entries (the functions that launch device
  work, named by module and function in ``DISPATCH_ENTRIES`` or marked
  ``# graftlint: dispatch`` on their ``def`` line; the port has no jit,
  so this table stands where the JAX package's ``@jax.jit`` decorators
  do), ``partial`` rebinds of them, and the control-op seam's deferred
  targets (``run_control_op(lambda: ...)``), so the GL70x multihost
  checks and ``--explain-dispatch-site`` can enumerate every device
  dispatch the scheduler loop can reach (see ``dispatch_inventory``).

Everything is resolved conservatively: an unresolvable call simply
contributes no edge (checks stay quiet rather than guessing), and
``functools.partial(self._x, ...)`` unwraps to ``self._x`` via the
shared ``_util`` helpers.
"""

from __future__ import annotations

import ast
import os
import re
from collections import deque
from typing import Dict, Iterable, List, Optional, Set, Tuple

from generativeaiexamples_tpu_torch.lint.core import Project, SourceFile
from generativeaiexamples_tpu_torch.lint.checks import _util as u

# The port's dispatch entries by module basename: the functions the
# scheduler hands device work to, the counterparts of the JAX package's
# jit entries (its inventory's 47 are these plus the same-module
# wrappers the closure below adds). Everything an entry calls runs in
# the dispatch layer. A new entry is added here or marked
# `# graftlint: dispatch` on (or right above) its def line.
DISPATCH_ENTRIES: Dict[str, Set[str]] = {
    "engine_model.py": {
        # steps
        "prefill_step", "prefill_batch_step", "prefill_chunk_step",
        "prefill_chunk_sample_step", "decode_step", "decode_multi_step",
        "decode_spec_multi_step", "decode_plain_spec_state_multi_step",
        "fused_decode_prefill_step", "fused_spec_prefill_step",
        # the pool's gather / scatter twins
        "cache_to_pool", "pool_to_cache", "pool_to_pages", "pages_to_pool",
        # token and history buffers, on-device sampling
        "set_last_token", "set_last_tokens", "set_history_rows",
        "sample_token", "sample_token_into"},
    "paged_attention_int8.py": {"paged_attention_int8"},
    "paged_attention_tree.py": {"paged_tree_attention"},
    # ANN: k-means, assignment, candidate and probed scans, exact top-k
    "ivf.py": {"_kmeans_step", "assign_partitions", "centroid_candidates",
               "_score_probed"},
    "tiered.py": {"_tiered_search"},
    "topk.py": {"mips_topk"},
    # DSP
    "dsp.py": {"fir_filter", "fm_demod", "_resample_apply", "float_to_pcm",
               "pcm_to_float"},
}
DISPATCH_MARK = re.compile(r"#\s*graftlint:\s*dispatch\b")


class FuncNode:
    """One function definition in the project."""

    __slots__ = ("key", "sf", "node", "name", "qual", "cls_name", "module",
                 "parent_key")

    def __init__(self, key: str, sf: SourceFile, node, name: str, qual: str,
                 cls_name: Optional[str], parent_key: Optional[str]):
        self.key = key
        self.sf = sf
        self.node = node
        self.name = name              # bare name, e.g. "_loop"
        self.qual = qual              # e.g. "LLMEngine._loop"
        self.cls_name = cls_name      # enclosing class, if a method
        self.module = os.path.basename(sf.path)   # e.g. "engine.py"
        self.parent_key = parent_key  # enclosing function, for nested defs

    def __repr__(self) -> str:  # debugging aid only
        return f"<FuncNode {self.key}>"


class ClassInfo:
    """One class definition: methods, bases, inferred attribute types."""

    __slots__ = ("name", "sf", "node", "methods", "base_names", "bases",
                 "attr_cls")

    def __init__(self, name: str, sf: SourceFile, node: ast.ClassDef):
        self.name = name
        self.sf = sf
        self.node = node
        self.methods: Dict[str, str] = {}     # method name -> func key
        self.base_names: List[str] = []       # unresolved base identifiers
        self.bases: List[Tuple[str, str]] = []  # resolved base class keys
        # attribute -> (file rel, class name) of the assigned instance
        self.attr_cls: Dict[str, Tuple[str, str]] = {}

    @property
    def key(self) -> Tuple[str, str]:
        return (self.sf.rel, self.name)


class CallGraph:
    """The resolved graph. ``calls`` edges stay on the calling thread;
    ``spawns`` edges cross onto a new thread (Thread target / executor
    submission)."""

    def __init__(self, project: Project):
        self.project = project
        self.nodes: Dict[str, FuncNode] = {}
        self.classes: Dict[Tuple[str, str], ClassInfo] = {}
        self.calls: Dict[str, Set[str]] = {}
        self.spawns: Dict[str, Set[str]] = {}
        self.file_index: Dict[str, "_FileIndex"] = {}
        self._rcalls: Optional[Dict[str, Set[str]]] = None
        # caller key -> [(lineno, callee key)] for every RESOLVED direct
        # call expression (callback references passed as arguments are
        # call EDGES but not call SITES — they fire elsewhere).
        self.call_sites: Dict[str, List[Tuple[int, str]]] = {}
        # functions handed to the engine's control-op seam
        # (run_control_op(...)): they run later ON the scheduler
        # thread, so multihost dispatch analysis roots there too.
        self.control_op_targets: Set[str] = set()
        # node keys of the dispatch entries (DISPATCH_ENTRIES + markers)
        self.dispatch_defs: Set[str] = set()

    def method_key(self, info: Optional[ClassInfo], name: str,
                   _seen: Optional[Set[Tuple[str, str]]] = None
                   ) -> Optional[str]:
        """Method lookup walking resolved base classes (MRO-ish:
        own class first, then bases in order)."""
        if info is None:
            return None
        seen = _seen if _seen is not None else set()
        if info.key in seen:
            return None
        seen.add(info.key)
        if name in info.methods:
            return info.methods[name]
        for base_key in info.bases:
            found = self.method_key(self.classes.get(base_key), name, seen)
            if found is not None:
                return found
        return None

    def str_sequence(self, rel: str, name: str) -> Optional[List[str]]:
        """Resolve `name` in file `rel` to a module-level tuple/list of
        string constants (imports followed one hop) — how key lists
        like ROUTER_COUNTER_KEYS are shared between snapshot emitters."""
        idx = self.file_index.get(rel)
        if idx is None:
            return None
        node = idx.constants.get(name)
        if node is None and name in idx.from_imports:
            mod, orig = idx.from_imports[name]
            target = _find_module_rel(self.project, self.file_index, mod)
            if target is not None:
                node = self.file_index[target].constants.get(orig)
        if isinstance(node, (ast.Tuple, ast.List)):
            out = [el.value for el in node.elts
                   if isinstance(el, ast.Constant)
                   and isinstance(el.value, str)]
            if len(out) == len(node.elts):
                return out
        return None

    # -- queries -----------------------------------------------------------

    def callees(self, key: str) -> Set[str]:
        return self.calls.get(key, set())

    def reverse_calls(self) -> Dict[str, Set[str]]:
        """callee key -> caller keys (call + spawn edges: for dependency
        purposes a spawner depends on its target's file too)."""
        if self._rcalls is None:
            rc: Dict[str, Set[str]] = {}
            for src, dsts in list(self.calls.items()) + \
                    list(self.spawns.items()):
                for d in dsts:
                    rc.setdefault(d, set()).add(src)
            self._rcalls = rc
        return self._rcalls

    def reachable(self, roots: Iterable[str], *,
                  follow_spawns: bool = False,
                  stop_at: Iterable[str] = ()) -> Dict[str, Optional[str]]:
        """BFS over call edges (optionally spawn edges too) from
        ``roots``; returns {reached key: parent key} — parent None for
        the roots themselves, so chains can be reconstructed. Nodes in
        ``stop_at`` are recorded when reached but NOT expanded: GL701
        uses this to ask "which dispatch sites can the scheduler reach
        without crossing a DispatchLog.publish seam?"."""
        stops = set(stop_at)
        parent: Dict[str, Optional[str]] = {}
        q: deque = deque()
        for r in roots:
            if r in self.nodes and r not in parent:
                parent[r] = None
                if r not in stops:
                    q.append(r)
        while q:
            k = q.popleft()
            nxt = set(self.calls.get(k, ()))
            if follow_spawns:
                nxt |= self.spawns.get(k, set())
            for d in sorted(nxt):
                if d not in parent:
                    parent[d] = k
                    if d not in stops:
                        q.append(d)
        return parent

    @staticmethod
    def chain(parent: Dict[str, Optional[str]], key: str) -> List[str]:
        """Root -> ... -> key path from a ``reachable`` parent map."""
        out = [key]
        while parent.get(out[-1]) is not None:
            out.append(parent[out[-1]])  # type: ignore[arg-type]
        return list(reversed(out))

    def functions_named(self, name: str) -> List[FuncNode]:
        """Nodes matching a user-supplied spec: bare name,
        ``Class.name``, or ``module.py:name`` (any combination)."""
        mod = None
        if ":" in name:
            mod, name = name.split(":", 1)
            mod = os.path.basename(mod)
        out = [n for n in self.nodes.values()
               if (n.name == name or n.qual == name
                   or n.qual.endswith("." + name))
               and (mod is None or n.module == mod)]
        return sorted(out, key=lambda n: n.key)

    def dependent_files(self, changed_rels: Set[str]) -> Set[str]:
        """Files (rel paths) holding a function with an edge INTO a
        function defined in ``changed_rels`` — the reverse-call-graph
        dependents a diff-scoped lint run must re-check."""
        out: Set[str] = set()
        rc = self.reverse_calls()
        for key, node in self.nodes.items():
            if node.sf.rel in changed_rels:
                for caller in rc.get(key, ()):
                    out.add(self.nodes[caller].sf.rel)
        return out - changed_rels

    # -- marker/root helpers ------------------------------------------------

    def keys_for(self, module_map: Dict[str, Set[str]]) -> Set[str]:
        """Node keys for a {module basename: {function name}} spec (the
        HOT_ROOTS shape)."""
        out = set()
        for key, node in self.nodes.items():
            if node.name in module_map.get(node.module, ()):
                out.add(key)
        return out


# -- construction ------------------------------------------------------------


def _module_suffixes(dotted: str) -> List[str]:
    """Path suffixes a dotted module name may live at, most specific
    first: 'a.b.c' -> ['a/b/c.py', 'b/c.py', 'c.py']."""
    parts = dotted.split(".")
    return ["/".join(parts[i:]) + ".py" for i in range(len(parts))]


def _find_module_rel(project: Project, files: Dict[str, "_FileIndex"],
                     dotted: str) -> Optional[str]:
    """Dotted module path -> rel path of the project file holding it."""
    for suffix in _module_suffixes(dotted):
        sf = project.find(suffix)
        if sf is not None and sf.rel in files:
            return sf.rel
    return None


class _FileIndex:
    """Per-file symbol tables feeding resolution."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.functions: Dict[str, str] = {}      # module-level name -> key
        self.classes: Dict[str, ClassInfo] = {}  # local class name -> info
        # imported name -> (module dotted path, original name) for
        # `from pkg.mod import X [as Y]`
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        # alias -> module dotted path for `import pkg.mod [as m]`
        self.module_imports: Dict[str, str] = {}
        # module-level `NAME = <expr>` assignments (constants)
        self.constants: Dict[str, ast.AST] = {}


class _Builder:
    def __init__(self, project: Project):
        self.project = project
        self.graph = CallGraph(project)
        self.files: Dict[str, _FileIndex] = {}

    # -- pass 1: index definitions ----------------------------------------

    def index(self) -> None:
        for sf in self.project.files:
            if sf.tree is None:
                continue
            idx = _FileIndex(sf)
            self.files[sf.rel] = idx
            self._index_imports(sf, idx)
            self._index_defs(sf, idx)
            for node in sf.tree.body:
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            idx.constants[t.id] = node.value
        self.graph.file_index = self.files

    def resolve_bases(self) -> None:
        for info in self.graph.classes.values():
            idx = self.files[info.sf.rel]
            for base in info.base_names:
                try:
                    expr = ast.parse(base, mode="eval").body
                except SyntaxError:
                    continue
                key = self._resolve_class_ref(expr, idx)
                if key is not None:
                    info.bases.append(key)

    def _index_imports(self, sf: SourceFile, idx: _FileIndex) -> None:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    idx.from_imports[alias.asname or alias.name] = \
                        (node.module, alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    idx.module_imports[alias.asname
                                       or alias.name.split(".")[0]] = \
                        alias.name

    def _index_defs(self, sf: SourceFile, idx: _FileIndex) -> None:
        def add_func(node, qual: str, cls_name: Optional[str],
                     parent_key: Optional[str]) -> str:
            key = f"{sf.rel}::{qual}"
            self.graph.nodes[key] = FuncNode(
                key, sf, node, node.name, qual, cls_name, parent_key)
            return key

        def walk_body(body, prefix: str, cls: Optional[ClassInfo],
                      parent_key: Optional[str]) -> None:
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{node.name}"
                    key = add_func(node, qual, cls.name if cls else None,
                                   parent_key)
                    if cls is not None and parent_key is None:
                        cls.methods[node.name] = key
                    elif cls is None and parent_key is None:
                        idx.functions[node.name] = key
                    walk_body(node.body, qual + ".<locals>.", cls, key)
                elif isinstance(node, ast.ClassDef) and parent_key is None \
                        and cls is None:
                    info = ClassInfo(node.name, sf, node)
                    for b in node.bases:
                        name = u.dotted(b)
                        if name:
                            info.base_names.append(name)
                    idx.classes[node.name] = info
                    self.graph.classes[info.key] = info
                    walk_body(node.body, node.name + ".", info, None)
                else:
                    # defs hidden in if/try at module or class level
                    for child in ast.iter_child_nodes(node):
                        if isinstance(child, (ast.FunctionDef,
                                              ast.AsyncFunctionDef,
                                              ast.ClassDef)):
                            walk_body([child], prefix, cls, parent_key)

        walk_body(sf.tree.body, "", None, None)

    # -- pass 2: attribute classes -----------------------------------------

    def infer_attr_classes(self) -> None:
        for info in self.graph.classes.values():
            idx = self.files[info.sf.rel]
            ann: Dict[str, Tuple[str, str]] = {}
            for m in info.node.body:
                if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                # parameter annotations (the `fleet: "EngineFleet"` shape)
                params: Dict[str, Tuple[str, str]] = {}
                for a in (m.args.posonlyargs + m.args.args
                          + m.args.kwonlyargs):
                    t = self._annotation_class(a.annotation, idx)
                    if t is not None:
                        params[a.arg] = t
                for node in ast.walk(m):
                    if not isinstance(node, ast.Assign) or \
                            len(node.targets) != 1:
                        continue
                    attr = u.self_attr_target(node.targets[0])
                    if attr is None:
                        continue
                    resolved = None
                    if isinstance(node.value, ast.Call):
                        resolved = self._resolve_class_ref(
                            node.value.func, idx)
                    elif isinstance(node.value, ast.Name):
                        resolved = params.get(node.value.id)
                    if resolved is not None:
                        ann[attr] = resolved
            info.attr_cls = ann

    def _annotation_class(self, annotation,
                          idx: _FileIndex) -> Optional[Tuple[str, str]]:
        if annotation is None:
            return None
        if isinstance(annotation, ast.Constant) and \
                isinstance(annotation.value, str):
            return self._resolve_class_name(annotation.value.strip("'\" "),
                                            idx)
        name = u.dotted(annotation)
        if name:
            return self._resolve_class_ref(annotation, idx)
        return None

    def _resolve_class_name(self, name: str,
                            idx: _FileIndex) -> Optional[Tuple[str, str]]:
        if name in idx.classes:
            return idx.classes[name].key
        imp = idx.from_imports.get(name)
        if imp is not None:
            target = self._file_for_module(imp[0])
            if target is not None and imp[1] in self.files[target].classes:
                return self.files[target].classes[imp[1]].key
        return None

    def _resolve_class_ref(self, node,
                           idx: _FileIndex) -> Optional[Tuple[str, str]]:
        """`ClassName` / `mod.ClassName` expression -> class key."""
        if isinstance(node, ast.Name):
            return self._resolve_class_name(node.id, idx)
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name):
            mod = idx.module_imports.get(node.value.id)
            if mod is not None:
                target = self._file_for_module(mod)
                if target is not None and \
                        node.attr in self.files[target].classes:
                    return self.files[target].classes[node.attr].key
        return None

    def _file_for_module(self, dotted: str) -> Optional[str]:
        return _find_module_rel(self.project, self.files, dotted)

    # -- pass 3: edges ------------------------------------------------------

    def build_edges(self) -> None:
        for key, fn in self.graph.nodes.items():
            self._edges_for(key, fn)

    def _class_of(self, fn: FuncNode) -> Optional[ClassInfo]:
        if fn.cls_name is None:
            return None
        return self.graph.classes.get((fn.sf.rel, fn.cls_name))

    def _method_key(self, info: Optional[ClassInfo],
                    name: str) -> Optional[str]:
        return self.graph.method_key(info, name)

    def _edges_for(self, key: str, fn: FuncNode) -> None:
        idx = self.files[fn.sf.rel]
        cls = self._class_of(fn)
        local_defs = {n.name: f"{fn.sf.rel}::{fn.qual}.<locals>.{n.name}"
                      for n in fn.node.body
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
        local_defs = {n: k for n, k in local_defs.items()
                      if k in self.graph.nodes}
        # single-pass local variable classes: `x = ClassName(...)`
        local_cls: Dict[str, Tuple[str, str]] = {}
        for node in u.walk_stop_at_functions(fn.node, include_root=False):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                t = self._resolve_class_ref(node.value.func, idx)
                if t is not None:
                    local_cls[node.targets[0].id] = t

        def resolve_ref(expr) -> Optional[str]:
            """A function REFERENCE expression -> node key (used for
            call targets and for callback/thread-target arguments)."""
            expr = u.unwrap_partial(expr)
            attr = u.self_attr_target(expr)
            if attr is not None:
                return self._method_key(cls, attr)
            if isinstance(expr, ast.Name):
                if expr.id in local_defs:
                    return local_defs[expr.id]
                if expr.id in idx.functions:
                    return idx.functions[expr.id]
                imp = idx.from_imports.get(expr.id)
                if imp is not None:
                    target = self._file_for_module(imp[0])
                    if target is not None:
                        t_idx = self.files[target]
                        if imp[1] in t_idx.functions:
                            return t_idx.functions[imp[1]]
                        if imp[1] in t_idx.classes:
                            return self._method_key(
                                t_idx.classes[imp[1]], "__init__")
                if expr.id in idx.classes:
                    return self._method_key(idx.classes[expr.id], "__init__")
                return None
            if isinstance(expr, ast.Attribute):
                base = expr.value
                # module alias: mod.func(...)
                if isinstance(base, ast.Name):
                    mod = idx.module_imports.get(base.id)
                    if mod is None and base.id in idx.from_imports:
                        # `from pkg import mod` — module object import
                        imp = idx.from_imports[base.id]
                        mod = f"{imp[0]}.{imp[1]}"
                    if mod is not None:
                        target = self._file_for_module(mod)
                        if target is not None:
                            t_idx = self.files[target]
                            if expr.attr in t_idx.functions:
                                return t_idx.functions[expr.attr]
                            if expr.attr in t_idx.classes:
                                return self._method_key(
                                    t_idx.classes[expr.attr], "__init__")
                    if base.id in local_cls:
                        return self._method_key(
                            self.graph.classes.get(local_cls[base.id]),
                            expr.attr)
                # attribute dataflow: self.<attr>.method(...)
                inner = u.self_attr_target(base)
                if inner is not None and cls is not None:
                    owner = cls.attr_cls.get(inner)
                    if owner is not None:
                        return self._method_key(
                            self.graph.classes.get(owner), expr.attr)
            return None

        def add_call(dst: Optional[str]) -> None:
            if dst is not None and dst != key:
                self.graph.calls.setdefault(key, set()).add(dst)

        def add_spawn(dst: Optional[str]) -> None:
            if dst is not None and dst != key:
                self.graph.spawns.setdefault(key, set()).add(dst)

        def partial_constant_ref(expr) -> Optional[str]:
            """`NAME(...)` where NAME is a module-level constant bound
            to `functools.partial(f, ...)` over a local def (the real
            key of `f`)."""
            if not isinstance(expr, ast.Name):
                return None
            const = idx.constants.get(expr.id)
            if not isinstance(const, ast.Call):
                return None
            inner = u.unwrap_partial(const)
            if inner is not const:
                return resolve_ref(inner)
            return None

        def add_control_op_targets(call: ast.Call) -> None:
            """run_control_op(fn) defers `fn` onto the scheduler
            thread; resolve what it will call so multihost dispatch
            analysis can root there. Lambda bodies fall back to a
            project-unique bare-name match: the idiom is
            `eng.run_control_op(lambda: eng.export_prefix_pages(...))`
            through a LOCAL alias the attribute dataflow cannot see."""
            a0 = call.args[0]
            if isinstance(a0, ast.Lambda):
                for c in ast.walk(a0.body):
                    if not isinstance(c, ast.Call):
                        continue
                    ref = resolve_ref(c.func)
                    if ref is None:
                        named = self.graph.functions_named(
                            u.last_part(u.dotted(c.func)))
                        ref = named[0].key if len(named) == 1 else None
                    if ref is not None:
                        self.graph.control_op_targets.add(ref)
                return
            ref = resolve_ref(a0)
            if ref is not None:
                self.graph.control_op_targets.add(ref)

        for node in u.walk_stop_at_functions(fn.node, include_root=False):
            if not isinstance(node, ast.Call):
                continue
            callee_name = u.dotted(node.func)
            last = u.last_part(callee_name)
            if last == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        add_spawn(resolve_ref(kw.value))
                continue
            if last == "submit" and node.args and \
                    not isinstance(node.func, ast.Name):
                # executor.submit(fn, ...): a spawn ONLY when the first
                # argument is a resolvable function reference (engine
                # .submit(req) takes a request object and stays a call).
                target = resolve_ref(node.args[0])
                if target is not None:
                    add_spawn(target)
                    continue
            if last == "run_control_op" and node.args:
                add_control_op_targets(node)
            dst = resolve_ref(node.func)
            if dst is None:
                dst = partial_constant_ref(node.func)
            if dst is not None and dst != key:
                self.graph.call_sites.setdefault(key, []).append(
                    (node.lineno, dst))
            add_call(dst if dst in self.graph.nodes else None)
            # synchronous callbacks: function references passed as args
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, (ast.Name, ast.Attribute)) or (
                        isinstance(arg, ast.Call)
                        and u.last_part(u.dotted(arg.func)) == "partial"):
                    ref = resolve_ref(arg)
                    # plain Name args are usually data, not callbacks —
                    # only count them when they name a known function
                    if ref is not None and ref in self.graph.nodes:
                        node_ref = self.graph.nodes[ref]
                        if isinstance(node_ref.node,
                                      (ast.FunctionDef,
                                       ast.AsyncFunctionDef)) \
                                and node_ref.name != "__init__":
                            add_call(ref)


def build(project: Project) -> CallGraph:
    """Build (and memoize on the Project) the call graph."""
    cached = getattr(project, "_graftlint_callgraph", None)
    if cached is not None:
        return cached
    b = _Builder(project)
    b.index()
    b.resolve_bases()
    b.infer_attr_classes()
    b.build_edges()
    b.graph.dispatch_defs = b.graph.keys_for(DISPATCH_ENTRIES)
    for key, node in b.graph.nodes.items():
        if node.parent_key is None and any(
                DISPATCH_MARK.search(node.sf.line(ln))
                for ln in (node.node.lineno, node.node.lineno - 1)):
            b.graph.dispatch_defs.add(key)
    project._graftlint_callgraph = b.graph  # type: ignore[attr-defined]
    return b.graph


# -- dispatch-site inventory --------------------------------------------------


def entry_name(key: str) -> str:
    """Display name of a dispatch entry key: the bare function name."""
    qual = key.split("::", 1)[-1]
    return qual.rsplit(".", 1)[-1]


class DispatchInventory:
    """Every device-dispatch call site the given roots can reach.

    - ``entries``: the dispatch-entry closure — the declared entries
      plus same-module thin wrappers over them (``plan_step`` ->
      ``_plan_step`` -> the step functions):
      the module boundary is where the scheduler hands off, so the
      cross-module call IS the dispatch site. The closure never grows
      into a root or into a function that publishes dispatch records
      (those are scheduler-side, not dispatch-layer).
    - ``sites``: {scheduler-side function key: [(lineno, entry key)]}.
    - ``publish_lines``: {function key: [linenos of
      ``DispatchLog.publish`` calls]}.
    - ``reach``: parent map of everything reachable from ``roots``
      over call edges (for chains).
    """

    def __init__(self, graph: CallGraph, roots: Set[str]):
        self.graph = graph
        self.roots = set(roots)
        self.publish_lines = _publish_lines(graph)
        self.entries = self._entry_closure()
        # Everything an entry calls runs inside the dispatch layer
        # (attention dispatch helpers, the model's forward): a call
        # from there to another entry is part of the first entry's
        # launch, not a scheduler-side one.
        self.traced = self.entries | set(
            graph.reachable(sorted(self.entries)))
        self.sites: Dict[str, List[Tuple[int, str]]] = {}
        for key, sites in graph.call_sites.items():
            if key in self.traced:
                continue
            hits = [(ln, dst) for ln, dst in sites if dst in self.entries]
            if hits:
                self.sites[key] = sorted(hits)
        self.reach = graph.reachable(sorted(self.roots))

    def _entry_closure(self) -> Set[str]:
        entries = set(self.graph.dispatch_defs)
        stop = self.roots | set(self.publish_lines)
        grew = True
        while grew:
            grew = False
            for key, sites in self.graph.call_sites.items():
                if key in entries or key in stop:
                    continue
                rel = key.split("::", 1)[0]
                for _ln, dst in sites:
                    if dst in entries and dst.split("::", 1)[0] == rel:
                        entries.add(key)
                        grew = True
                        break
        return entries

    def reachable_sites(self) -> List[Tuple[str, int, str]]:
        """(function key, lineno, entry key) for every dispatch site in
        a function the roots reach, sorted for stable output."""
        out = []
        for key, sites in self.sites.items():
            if key in self.reach:
                out.extend((key, ln, dst) for ln, dst in sites)
        return sorted(out)


def _publish_lines(graph: CallGraph) -> Dict[str, List[int]]:
    """Linenos of DispatchLog.publish calls per function: receiver
    either carries a log-ish name (`self._mh_log.publish(...)`) or has
    an inferred attribute class literally named DispatchLog. A call to
    a thin wrapper of the seam, a function whose only calls are such
    publishes (the port's `LLMEngine._publish(kind, rec)`), publishes at
    its own line too."""
    out: Dict[str, List[int]] = {}
    for key, node in graph.nodes.items():
        cls = graph.classes.get((node.sf.rel, node.cls_name)) \
            if node.cls_name else None
        for call in u.walk_stop_at_functions(node.node, include_root=False):
            if not isinstance(call, ast.Call) or \
                    not isinstance(call.func, ast.Attribute) or \
                    call.func.attr != "publish":
                continue
            recv = call.func.value
            recv_name = (u.dotted(recv) or "").lower()
            is_log = "log" in recv_name
            if not is_log and cls is not None:
                attr = u.self_attr_target(recv)
                owner = cls.attr_cls.get(attr) if attr else None
                is_log = owner is not None and owner[1] == "DispatchLog"
            if is_log:
                out.setdefault(key, []).append(call.lineno)
    thin = {k for k in out
            if all(entry_name(dst) == "publish"
                   for _ln, dst in graph.call_sites.get(k, ()))}
    for key, sites in graph.call_sites.items():
        for ln, dst in sites:
            if dst in thin and key != dst:
                out.setdefault(key, []).append(ln)
    for lines in out.values():
        lines.sort()
    return out


def dispatch_inventory(project: Project,
                       roots: Set[str]) -> DispatchInventory:
    """Build (and memoize per root set) the dispatch-site inventory."""
    cache = getattr(project, "_graftlint_dispatch_inv", None)
    if cache is None:
        cache = {}
        project._graftlint_dispatch_inv = cache  # type: ignore
    key = frozenset(roots)
    if key not in cache:
        cache[key] = DispatchInventory(build(project), set(roots))
    return cache[key]
