"""GL401/GL402 host-sync-in-hot-path: blocking device->host syncs on
the serving dispatch paths (torch's vocabulary).

The serving engine's throughput hinges on the scheduler thread never
blocking on the device: launches are async, and the ONLY sanctioned
blocking fetch is the oldest in-flight block's host copy
(`HostCopy.numpy` in serving/engine.py: a pinned copy and a CUDA event
queued behind the block, waited on while the scheduler admits and
emits; the JAX engine's oldest-block fetch). A stray `.item()`,
`.cpu()` or `torch.cuda.synchronize()` on that path serializes the
pipeline and silently halves tokens/sec — no test fails, the benchmark
just gets slower.

Hot scope comes in two layers:

- **GL401 declared hot paths** — the ROOT functions of each serving
  dispatch loop (`HOT_ROOTS` below) plus any function whose `def` line
  carries a `# graftlint: hot-path` marker. This is the hand-curated
  layer: small, stable, and the seed of the inference.
- **GL402 inferred hot paths** — everything REACHABLE from those roots
  through the project call graph (lint/callgraph.py: `self.method()`
  dispatch, intra-package calls, attribute dataflow). A helper pulled
  onto the dispatch path is hot the moment the call edge exists, and
  each finding carries the root→func call chain so it is
  self-justifying (`--explain-hot-path <func>` prints the same chain).

Flagged inside a hot function (either layer), with the tensor inference
of `_util.TensorScope` (unknown values are not tensors):

- `.item()` / `.tolist()` of a tensor, `.cpu()`, `.numpy()`,
  `.to("cpu")`;
- `float()` / `int()` / `bool()` of a tensor, `np.asarray(tensor)` /
  `np.array(tensor)`;
- `torch.cuda.synchronize()`, `Event.synchronize()`,
  `Stream.synchronize()`.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Set, Tuple

from generativeaiexamples_tpu_torch.lint.core import Check, Finding, Project
from generativeaiexamples_tpu_torch.lint import callgraph
from generativeaiexamples_tpu_torch.lint.checks import _util as u

HOT_PATH_MARK = re.compile(r"#\s*graftlint:\s*hot-path")
# Declared hot-path ROOTS per module basename: the entry function of
# each serving dispatch loop. Everything call-graph-reachable from
# these is hot (GL402); new subsystems add ONE root (or a `# graftlint:
# hot-path` marker on their entry) instead of enumerating every helper.
HOT_ROOTS: Dict[str, Set[str]] = {
    "engine.py": {"_loop"},      # scheduler beat: admission, plans, emits
    "batcher.py": {"_run"},      # micro-batch dispatch (loop is marked)
    "router.py": {"place"},      # fleet placement, server request threads
    "fleet.py": {"submit"},      # fleet dispatch + stream hooks
    "qos.py": {"pick"},          # weighted-fair pop under the waiting lock
    "tiered.py": {"search"},     # tiered-ANN dispatch + host refine/merge
    # Autoscaler decision path: tick() runs every poll AND its wake
    # path rides the submit hot path (EngineFleet.submit calls
    # wake_for_submit on an empty fleet), so a host sync creeping in
    # would stall live placements.
    "autoscaler.py": {"tick", "wake_for_submit"},
}
# The sanctioned blocking fetch (module basename -> qualnames): its body
# is the one wait the scheduler is allowed, and is not scanned.
SANCTIONED_FETCHES: Dict[str, Set[str]] = {"engine.py": {"HostCopy.numpy"}}


def hot_root_keys(graph: "callgraph.CallGraph") -> Set[str]:
    """Call-graph keys of every declared hot path (roots + markers)."""
    keys = graph.keys_for(HOT_ROOTS)
    for key, node in graph.nodes.items():
        for lineno in (node.node.lineno, node.node.lineno - 1):
            if HOT_PATH_MARK.search(node.sf.line(lineno)):
                keys.add(key)
                break
    return keys


def inferred_hot(graph: "callgraph.CallGraph") -> Dict[str, Optional[str]]:
    """{hot function key: call-graph parent key} — every function
    reachable from the declared roots over CALL edges (spawn edges
    start a different thread and do not propagate hotness)."""
    return graph.reachable(sorted(hot_root_keys(graph)))


def sanctioned(node: "callgraph.FuncNode") -> bool:
    return node.qual in SANCTIONED_FETCHES.get(node.module, ())


def tensor_scope(graph: "callgraph.CallGraph",
                 node: "callgraph.FuncNode") -> u.TensorScope:
    """`node`'s tensor inference: its file's torch aliases, its class's
    tensor attributes, and the lines where it calls a dispatch entry
    (memoized on the graph by node key, file and class, as
    callgraph.build memoizes on the project)."""
    cache = getattr(graph, "_graftlint_tensor_scopes", None)
    if cache is None:
        cache = graph._graftlint_tensor_scopes = {}  # type: ignore
    if node.key not in cache:
        aliases = cache.get(node.sf.rel)
        if aliases is None:
            aliases = cache[node.sf.rel] = u.torch_aliases(node.sf.tree)
        ckey = (node.sf.rel, node.cls_name)
        attrs = cache.get(ckey)
        if attrs is None:
            info = graph.classes.get(ckey) if node.cls_name else None
            attrs = cache[ckey] = (u.class_tensor_attrs(info.node, aliases)
                                   if info is not None else set())
        entry_lines = {ln for ln, dst in graph.call_sites.get(node.key, ())
                       if dst in graph.dispatch_defs}
        cache[node.key] = u.TensorScope(node.node, aliases, attrs,
                                        entry_lines)
    return cache[node.key]


def scan_syncs(graph: "callgraph.CallGraph",
               node: "callgraph.FuncNode") -> Iterable[Tuple[int, str]]:
    """Yield (lineno, message) for every host-sync shape in `node`."""
    if sanctioned(node):
        return
    for lineno, _shape, what in u.scan_host_syncs(
            node.node, tensor_scope(graph, node)):
        yield lineno, (
            f"{what} on the hot path waits for the device and stalls the "
            f"dispatch pipeline; copy into pinned memory behind a CUDA "
            f"event and read it once the event has fired "
            f"(serving/engine.py HostCopy), or move it off this thread")


class HostSyncCheck(Check):
    id = "GL401"
    name = "host-sync-hot-path"
    severity = "warning"
    describe = (".item() / .cpu() / .numpy() / .tolist() / synchronize "
                "/ float() of a tensor inside a declared hot path "
                "(HOT_ROOTS entry or `# graftlint: hot-path` marker)")

    def run(self, project: Project) -> Iterable[Finding]:
        graph = callgraph.build(project)
        for key in sorted(hot_root_keys(graph)):
            node = graph.nodes[key]
            for lineno, msg in scan_syncs(graph, node):
                yield self.finding(node.sf, lineno, msg)


class HostSyncInferredCheck(Check):
    id = "GL402"
    name = "host-sync-inferred"
    severity = "warning"
    describe = ("host sync in a function call-graph-reachable from a "
                "hot-path root (engine._loop, batcher._run, "
                "router.place, fleet.submit, qos.pick, tiered.search)")

    def run(self, project: Project) -> Iterable[Finding]:
        graph = callgraph.build(project)
        parent = inferred_hot(graph)
        roots = hot_root_keys(graph)
        for key in sorted(parent):
            if key in roots:
                continue  # declared layer: GL401 already scans it
            node = graph.nodes[key]
            syncs = list(scan_syncs(graph, node))
            if not syncs:
                continue
            chain = graph.chain(parent, key)
            via = " -> ".join(
                f"{graph.nodes[k].module}:{graph.nodes[k].qual}"
                for k in chain)
            for lineno, msg in syncs:
                yield self.finding(
                    node.sf, lineno,
                    f"{msg} [hot via {via}; `--explain-hot-path "
                    f"{node.name}` reprints this chain]")
