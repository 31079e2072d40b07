"""GL701–GL704 multihost collective-safety: the launch-order replay
contract, machine-checked, over the port's rank processes.

serving/multihost.py's protocol rests on one invariant: cross-process
collectives pair purely by launch order. Rank 0 runs the scheduler and
publishes every device dispatch to the DispatchLog BEFORE launching;
followers replay the records in sequence. Anything that breaks the
pairing deadlocks the ranks or silently forks device state:

- **GL701 publish-before-launch** — every dispatch-entry call site
  (`plan_step`, `prefill_batch_step`, the pool gather/scatter twins, …)
  reachable from the scheduler loop (`engine._loop` plus the
  control-op seam's deferred closures) must cross the
  `DispatchLog.publish` seam on every path before the launch line.
  Each finding embeds its scheduler-root→dispatch chain;
  `--explain-dispatch-site <func>` reprints it.
- **GL702 fetch-seam enforcement** — host materialization of a tensor
  (`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `.to("cpu")`,
  `np.asarray`, `float()` / `int()`) on a multihost-reachable path must
  route through `fetch_replicated` / `fetch_addressable` /
  `fetch_addressable_slice`: a rank's tensor is its own shard, and the
  seam names which value a rank reads, whole or its slice. The scope is
  the call-graph closure from the scheduler roots, stopping at the seams
  (what they call is the seam) — no per-seam markers to maintain.
- **GL703 replay-divergence sources** — functions whose return values
  flow into dispatch decisions (plan selection, admission pop, rider
  choice) must not read wall-clock time, `random`, metrics snapshots,
  or iterate unordered sets outside an order-insensitive reducer
  (`sorted`/`min`/`max`/…). The leader's decisions are fine to be
  stateful — they are published — but nondeterminism here makes runs
  unreproducible and breaks record-level replay testing.
- **GL704 collective-deadlock hazards** — a Python-level conditional
  on per-rank state (`torch.distributed.get_rank()`, `self._mh_leader`,
  `self.rank`) whose
  body launches a dispatch: ranks take different branches, launch
  different collective sequences, and the slice deadlocks.
  Leader-guarded *publishes* are the protocol and stay quiet; only a
  guarded *launch* fires. (Per-rank queue-depth divergence is the
  decision-closure problem and is covered by GL703.)

The dispatch-site inventory itself (dispatch entries, wrapper closure,
control-op targets, per-site line numbers) lives in lint/callgraph.py:
`dispatch_inventory`.
"""

from __future__ import annotations

import ast
import re
from collections import deque
from typing import Dict, Iterable, List, Optional, Set, Tuple

from generativeaiexamples_tpu_torch.lint.core import Check, Finding, Project
from generativeaiexamples_tpu_torch.lint import callgraph
from generativeaiexamples_tpu_torch.lint.checks import _util as u
from generativeaiexamples_tpu_torch.lint.checks._util import NUMPY_MODULES
from generativeaiexamples_tpu_torch.lint.checks.host_sync import tensor_scope

# The scheduler loop: the one thread that launches device dispatches on
# the multihost leader. run_control_op closures drain at the top of
# each beat on this same thread, so the per-project control-op targets
# are added as roots alongside.
SCHED_ROOTS: Dict[str, Set[str]] = {"engine.py": {"_loop"}}

# The sanctioned host<->device crossings (serving/multihost.py).
FETCH_SEAMS = {"fetch_replicated", "fetch_addressable",
               "fetch_addressable_slice"}

WALL_CLOCK_FNS = {"time", "perf_counter", "monotonic", "time_ns",
                  "monotonic_ns", "process_time"}
DATETIME_FNS = {"now", "utcnow", "today"}
# Reducers whose result does not depend on iteration order, so feeding
# them a set is replay-safe (`max(w for w in self._warm_ks ...)`).
SAFE_REDUCERS = {"sorted", "min", "max", "sum", "len", "any", "all",
                 "set", "frozenset"}
# container.method(x) shapes that propagate taint from receiver to args
MUTATORS = {"append", "appendleft", "add", "insert", "extend",
            "extendleft", "setdefault", "put"}
RANK_STATE_RE = re.compile(
    r"(^|_)(mh_leader|is_leader|process_index|process_id|local_rank"
    r"|rank)$")
# Calls that read this process's rank.
RANK_CALLS = {"process_index", "get_rank", "get_local_rank"}


def scheduler_roots(graph: "callgraph.CallGraph") -> Set[str]:
    """Scheduler-thread roots: the declared loop entries plus every
    function the control-op seam defers onto that thread."""
    return graph.keys_for(SCHED_ROOTS) | set(graph.control_op_targets)


def inventory_for(project: Project) -> "callgraph.DispatchInventory":
    graph = callgraph.build(project)
    return callgraph.dispatch_inventory(project, scheduler_roots(graph))


def _chain_str(graph, parent: Dict[str, Optional[str]], key: str) -> str:
    chain = callgraph.CallGraph.chain(parent, key)
    return " -> ".join(f"{graph.nodes[k].module}:{graph.nodes[k].qual}"
                       for k in chain if k in graph.nodes)


class MultihostPublishCheck(Check):
    id = "GL701"
    name = "multihost-publish-before-launch"
    severity = "error"
    describe = ("device dispatch reachable from the scheduler loop "
                "(engine._loop + control-op seam) with a path that "
                "skips DispatchLog.publish before launch")

    def run(self, project: Project) -> Iterable[Finding]:
        graph = callgraph.build(project)
        inv = inventory_for(project)
        if not inv.roots:
            return
        publishers = sorted(inv.publish_lines)
        unpub = graph.reachable(sorted(inv.roots), stop_at=publishers)
        for key, ln, dst in inv.reachable_sites():
            if key not in unpub:
                continue  # every scheduler path crosses a publish seam
            if any(p < ln for p in inv.publish_lines.get(key, ())):
                continue  # published earlier in this very function
            node = graph.nodes[key]
            via = _chain_str(graph, unpub, key)
            yield self.finding(
                node.sf, ln,
                f"dispatch of entry `{callgraph.entry_name(dst)}` "
                f"can launch without a DispatchLog.publish "
                f"[scheduler path {via}; `--explain-dispatch-site "
                f"{node.name}` reprints it] — followers replay records "
                f"in launch order, so an unpublished dispatch "
                f"desynchronizes every rank's collective stream")


class MultihostFetchSeamCheck(Check):
    id = "GL702"
    name = "multihost-fetch-seam"
    severity = "error"
    describe = ("host materialization of a tensor (.item()/.cpu()/"
                ".numpy()/np.asarray/float()) on a multihost-reachable "
                "path outside the fetch_replicated/fetch_addressable "
                "seams")

    def run(self, project: Project) -> Iterable[Finding]:
        graph = callgraph.build(project)
        inv = inventory_for(project)
        if not inv.roots:
            return
        seams = [k for k, n in graph.nodes.items() if n.name in FETCH_SEAMS]
        reach = graph.reachable(sorted(inv.roots), stop_at=seams)
        for key in sorted(reach):
            node = graph.nodes.get(key)
            if node is None or key in inv.traced:
                continue  # the dispatch layer: the replayed launch itself
            if node.name in FETCH_SEAMS:
                continue  # the sanctioned seams themselves
            hits = list(_scan_materialization(graph, node))
            if not hits:
                continue
            via = _chain_str(graph, reach, key)
            for ln, msg in hits:
                yield self.finding(
                    node.sf, ln,
                    f"{msg} on a multihost-reachable path [{via}]; "
                    f"route through multihost.fetch_replicated/"
                    f"fetch_addressable so the seam names whether this "
                    f"rank reads the whole value or only its shard")


# The host-sync shapes that bring a value to the host (JAX's GL702 set,
# in torch's words): a synchronize moves no value, and JAX's rule leaves
# bool() out too.
MATERIALIZING = {"item", "tolist", "cpu", "numpy", "to", "asarray",
                 "array", "float", "int"}


def _scan_materialization(graph, node) -> Iterable[Tuple[int, str]]:
    scope = tensor_scope(graph, node)
    for ln, shape, what in u.scan_host_syncs(node.node, scope):
        if shape in MATERIALIZING:
            yield ln, f"{what} materializes on the host"


class MultihostDivergenceCheck(Check):
    id = "GL703"
    name = "multihost-replay-divergence"
    severity = "warning"
    describe = ("wall-clock/random/metrics-snapshot read or unordered-"
                "set iteration inside the dispatch-decision closure "
                "(values that feed which/what the scheduler launches)")

    def run(self, project: Project) -> Iterable[Finding]:
        graph = callgraph.build(project)
        inv = inventory_for(project)
        if not inv.roots:
            return
        closure = _decision_closure(graph, inv)
        for key in sorted(closure):
            node = graph.nodes.get(key)
            if node is None or key in inv.traced:
                continue
            for ln, what in _scan_divergence(graph, node):
                yield self.finding(
                    node.sf, ln,
                    f"{what} inside the dispatch-decision closure "
                    f"(value feeds dispatches issued by "
                    f"`{closure[key]}`) — follower replay pairs "
                    f"collectives purely by launch order, so leader-"
                    f"only nondeterminism makes the dispatch stream "
                    f"unreproducible")


def _decision_closure(graph, inv) -> Dict[str, str]:
    """{function key: origin qualname}: every function whose return
    value can flow into the arguments of a dispatch(-reaching) call on
    a scheduler path, plus everything those functions call."""
    # functions that can reach a dispatch site at all
    rev = graph.reverse_calls()
    anc: Set[str] = set(inv.sites)
    q: deque = deque(sorted(anc))
    while q:
        k = q.popleft()
        for caller in sorted(rev.get(k, ())):
            if caller not in anc:
                anc.add(caller)
                q.append(caller)
    seeds: Dict[str, str] = {}
    for key in sorted(inv.reach):
        node = graph.nodes.get(key)
        if node is None or key in inv.traced:
            continue
        sites = graph.call_sites.get(key, [])
        feed_lines = {ln for ln, dst in sites
                      if dst in anc or dst in inv.entries}
        if not feed_lines:
            continue
        for skey in _decision_seeds(node, feed_lines, sites):
            seeds.setdefault(skey, node.qual)
    closure: Dict[str, str] = {}
    q = deque()
    for skey in sorted(seeds):
        closure[skey] = seeds[skey]
        q.append(skey)
    while q:
        k = q.popleft()
        for d in sorted(graph.calls.get(k, ())):
            if d not in closure:
                closure[d] = closure[k]
                q.append(d)
    return closure


def _root_name(expr) -> Optional[str]:
    """Taint key for the container a mutation lands in:
    `groups.setdefault(b, []).append(x)` -> 'groups'."""
    while True:
        if isinstance(expr, ast.Name):
            return expr.id
        attr = u.self_attr_target(expr)
        if attr is not None:
            return "self." + attr
        if isinstance(expr, (ast.Attribute, ast.Subscript)):
            expr = expr.value
        elif isinstance(expr, ast.Call):
            expr = expr.func
        else:
            return None


def _decision_seeds(fn_node, feed_lines: Set[int],
                    call_sites: List[Tuple[int, str]]) -> Set[str]:
    """Backward taint inside one function: which resolved callees'
    return values flow into the args of a dispatch-feeding call?"""
    by_line: Dict[int, List[str]] = {}
    for ln, dst in call_sites:
        by_line.setdefault(ln, []).append(dst)
    tainted: Set[str] = set()
    seeds: Set[str] = set()

    def taint_expr(value) -> None:
        for nn in ast.walk(value):
            if isinstance(nn, ast.Name):
                tainted.add(nn.id)
            attr = u.self_attr_target(nn)
            if attr is not None:
                tainted.add("self." + attr)
            if isinstance(nn, ast.Call):
                for dst in by_line.get(nn.lineno, ()):
                    seeds.add(dst)

    def target_names(t) -> List[Optional[str]]:
        if isinstance(t, (ast.Tuple, ast.List)):
            return [n for e in t.elts for n in target_names(e)]
        return [_root_name(t)]

    stmts = list(u.walk_stop_at_functions(fn_node.node,
                                          include_root=False))
    for st in stmts:
        if isinstance(st, ast.Call) and st.lineno in feed_lines:
            for arg in list(st.args) + [kw.value for kw in st.keywords]:
                taint_expr(arg)
    for _ in range(10):  # fixpoint; function-local so converges fast
        before = (len(tainted), len(seeds))
        for st in stmts:
            if isinstance(st, ast.Assign):
                names = [n for t in st.targets for n in target_names(t)]
                if any(n in tainted for n in names if n):
                    taint_expr(st.value)
            elif isinstance(st, ast.AugAssign):
                if _root_name(st.target) in tainted:
                    taint_expr(st.value)
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                if _root_name(st.target) in tainted:
                    taint_expr(st.value)
            elif isinstance(st, ast.For):
                if any(n in tainted for n in target_names(st.target)
                       if n):
                    taint_expr(st.iter)
            elif isinstance(st, ast.Call) \
                    and isinstance(st.func, ast.Attribute) \
                    and st.func.attr in MUTATORS:
                if _root_name(st.func.value) in tainted:
                    for arg in list(st.args) + \
                            [kw.value for kw in st.keywords]:
                        taint_expr(arg)
        if (len(tainted), len(seeds)) == before:
            break
    return seeds


def _scan_divergence(graph, node) -> Iterable[Tuple[int, str]]:
    idx = graph.file_index.get(node.sf.rel)
    from_imports = idx.from_imports if idx else {}
    setish = _setish_names(graph, node)

    def is_setish(expr) -> bool:
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return True
        if isinstance(expr, ast.Call) and \
                u.last_part(u.dotted(expr.func)) in ("set", "frozenset"):
            return True
        if isinstance(expr, ast.BinOp) and \
                isinstance(expr.op, (ast.Sub, ast.BitOr, ast.BitAnd,
                                     ast.BitXor)):
            return is_setish(expr.left) or is_setish(expr.right)
        name = _root_name(expr) if isinstance(
            expr, (ast.Name, ast.Attribute)) else None
        return name in setish

    safe_comps: Set[int] = set()
    body = list(u.walk_stop_at_functions(node.node, include_root=False))
    for c in body:
        if isinstance(c, ast.Call) and \
                u.last_part(u.dotted(c.func)) in SAFE_REDUCERS:
            for arg in c.args:
                if isinstance(arg, (ast.GeneratorExp, ast.ListComp,
                                    ast.SetComp, ast.DictComp)):
                    safe_comps.add(id(arg))

    for c in body:
        if isinstance(c, ast.Call):
            name = u.dotted(c.func) or ""
            parts = name.split(".")
            last = parts[-1]
            if (len(parts) == 2 and parts[0] == "time"
                    and last in WALL_CLOCK_FNS) or \
                    (len(parts) == 1 and last in WALL_CLOCK_FNS
                     and from_imports.get(last, ("",))[0] == "time"):
                yield c.lineno, f"wall-clock read (`{name}`)"
            elif last in DATETIME_FNS and len(parts) > 1 \
                    and "datetime" in parts[:-1]:
                yield c.lineno, f"wall-clock read (`{name}`)"
            elif parts[0] == "random" and len(parts) > 1:
                yield c.lineno, f"host `random` draw (`{name}`)"
            elif len(parts) > 2 and parts[0] in NUMPY_MODULES \
                    and parts[1] == "random":
                yield c.lineno, f"host numpy random draw (`{name}`)"
            elif last == "snapshot" and isinstance(c.func, ast.Attribute):
                yield c.lineno, "metrics snapshot read (racy counters)"
        elif isinstance(c, ast.For) and is_setish(c.iter):
            yield c.lineno, "iteration over an unordered set"
        elif isinstance(c, (ast.GeneratorExp, ast.ListComp,
                            ast.SetComp, ast.DictComp)) \
                and id(c) not in safe_comps \
                and any(is_setish(g.iter) for g in c.generators):
            yield c.lineno, "comprehension over an unordered set " \
                "outside an order-insensitive reducer"


def _setish_names(graph, node) -> Set[str]:
    """Local names / self attrs bound to sets in this function (locals,
    one fixpoint pass) or anywhere in its class (attrs)."""
    out: Set[str] = set()

    def shallow(expr) -> bool:
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return True
        if isinstance(expr, ast.Call) and \
                u.last_part(u.dotted(expr.func)) in ("set", "frozenset"):
            return True
        if isinstance(expr, ast.BinOp) and \
                isinstance(expr.op, (ast.Sub, ast.BitOr, ast.BitAnd,
                                     ast.BitXor)):
            return shallow(expr.left) or shallow(expr.right)
        if isinstance(expr, (ast.Name, ast.Attribute)):
            return _root_name(expr) in out
        return False

    cls = graph.classes.get((node.sf.rel, node.cls_name)) \
        if node.cls_name else None
    if cls is not None:
        for st in ast.walk(cls.node):
            if isinstance(st, ast.Assign) and len(st.targets) == 1:
                attr = u.self_attr_target(st.targets[0])
                if attr is not None and shallow(st.value):
                    out.add("self." + attr)
    for _ in range(4):
        n0 = len(out)
        for st in u.walk_stop_at_functions(node.node, include_root=False):
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name) \
                    and shallow(st.value):
                out.add(st.targets[0].id)
        if len(out) == n0:
            break
    return out


class MultihostRankBranchCheck(Check):
    id = "GL704"
    name = "multihost-rank-branch-dispatch"
    severity = "error"
    describe = ("dispatch launch guarded by a per-rank conditional "
                "(get_rank / _mh_leader): ranks would launch "
                "different collective sequences and deadlock")

    def run(self, project: Project) -> Iterable[Finding]:
        graph = callgraph.build(project)
        inv = inventory_for(project)
        if not inv.roots:
            return
        for key in sorted(inv.reach):
            node = graph.nodes.get(key)
            sites = inv.sites.get(key)
            if node is None or not sites:
                continue
            for st in u.walk_stop_at_functions(node.node,
                                               include_root=False):
                if not isinstance(st, ast.If) or \
                        not _reads_rank_state(st.test):
                    continue
                end = getattr(st, "end_lineno", st.lineno)
                guarded = [(ln, dst) for ln, dst in sites
                           if st.lineno < ln <= end]
                for ln, dst in guarded:
                    yield self.finding(
                        node.sf, ln,
                        f"dispatch of `{callgraph.entry_name(dst)}` "
                        f"guarded by per-rank state "
                        f"(if at line {st.lineno}): ranks take "
                        f"different branches and launch different "
                        f"collective sequences — publish a record and "
                        f"branch on the replayed record instead")


def _reads_rank_state(test) -> bool:
    for nn in ast.walk(test):
        if isinstance(nn, ast.Call) and \
                u.last_part(u.dotted(nn.func)) in RANK_CALLS:
            return True
        if isinstance(nn, ast.Attribute) and \
                RANK_STATE_RE.search(nn.attr):
            return True
        if isinstance(nn, ast.Name) and RANK_STATE_RE.search(nn.id):
            return True
    return False
