"""GL101 capture purity: host syncs and Python control flow on tensor
values inside a captured or compiled region.

A CUDA graph records the kernels a region launches, once; a replay
reruns them with no Python. Inside `with torch.cuda.graph(g):`, a
function given to `torch.cuda.make_graphed_callables`, or a
`torch.compile`d function:

- `.item()`, `.cpu()`, `.numpy()`, `.tolist()`, `float()` / `int()` /
  `bool()` of a tensor, `np.asarray(tensor)` and any `.synchronize()`
  block on the device (an error during CUDA graph capture, a graph
  break under torch.compile);
- a Python `if` / `while` on a tensor's value syncs to read it, and the
  branch taken at capture is the only one the graph ever replays.

Shape, dtype and device reads (`x.shape[0]`, `x.dtype`, `len(x)`, `x is
None`) are static and not flagged. In a captured or compiled FUNCTION
every parameter is taken as a tensor, as the JAX check takes every
non-static argument of a jitted function as traced; in a `with
torch.cuda.graph(...)` block, the tensors of the enclosing function
(`_util.TensorScope`: annotated parameters, torch results). `.item()`
and `.tolist()` count there whatever their receiver.

The port captures nothing yet (ROADMAP A.22 will capture the decode
blocks), so on its tree the check is quiet; it guards that work.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional, Set

from generativeaiexamples_tpu_torch.lint.core import Check, Finding, \
    Project, SourceFile
from generativeaiexamples_tpu_torch.lint.checks import _util as u

# Calls whose results are concrete even on tensors (they inspect the
# metadata, not the data).
STATIC_CALLS = {"len", "isinstance", "hasattr", "getattr", "type", "id",
                "callable", "range", "enumerate", "zip", "is_tensor",
                "is_floating_point", "is_complex", "size", "dim", "numel"}
# Callables whose function argument is captured or compiled.
CAPTURE_WRAPPERS = {"make_graphed_callables", "compile"}


def _is_compile(expr) -> bool:
    """`torch.compile` / `compile` imported from torch (a bare `compile`
    is Python's builtin only when it takes source, which no decorator
    does)."""
    name = u.dotted(expr)
    return name in ("torch.compile", "compile")


def _is_graph_ctx(expr) -> bool:
    """`torch.cuda.graph(g)` / `cuda.graph(g)` / `graph(g)`."""
    return isinstance(expr, ast.Call) and \
        u.last_part(u.dotted(expr.func)) == "graph"


class TracePurityCheck(Check):
    id = "GL101"
    name = "trace-purity"
    severity = "error"
    describe = ("host sync (.item()/.cpu()/float()/synchronize) or "
                "Python control flow on a tensor inside a CUDA graph "
                "capture, make_graphed_callables or torch.compile")

    def run(self, project: Project) -> Iterable[Finding]:
        for sf in project.files:
            if sf.tree is None:
                continue
            yield from self._check_file(sf)

    # -- per-file ----------------------------------------------------------

    def _check_file(self, sf: SourceFile) -> Iterable[Finding]:
        aliases = u.torch_aliases(sf.tree) | {"torch"}
        wrapped = self._wrapped_names(sf.tree)
        seen: Set[int] = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name in wrapped or any(
                        _is_compile(d) or (isinstance(d, ast.Call)
                                           and _is_compile(d.func))
                        for d in node.decorator_list):
                    yield from self._scan(sf, node, node.body, aliases,
                                          set(u.param_names(node)), seen)
                for st in u.walk_stop_at_functions(node, include_root=False):
                    if isinstance(st, (ast.With, ast.AsyncWith)) and any(
                            _is_graph_ctx(item.context_expr)
                            for item in st.items):
                        yield from self._scan(sf, node, st.body, aliases,
                                              set(), seen)
            elif isinstance(node, ast.Call) and \
                    u.last_part(u.dotted(node.func)) in CAPTURE_WRAPPERS \
                    and node.args and isinstance(node.args[0], ast.Lambda):
                lam = node.args[0]
                yield from self._scan(sf, lam, [lam.body], aliases,
                                      set(u.param_names(lam)), seen)

    def _wrapped_names(self, tree: ast.Module) -> Set[str]:
        """Names of this module's functions passed to
        `make_graphed_callables(fn, ...)` or `torch.compile(fn)`
        (`make_graphed_callables((f, g), ...)` too)."""
        out: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node.args and \
                    u.last_part(u.dotted(node.func)) in CAPTURE_WRAPPERS:
                if u.last_part(u.dotted(node.func)) == "compile" and \
                        not _is_compile(node.func):
                    continue
                a0 = node.args[0]
                for el in (a0.elts if isinstance(a0, (ast.Tuple, ast.List))
                           else [a0]):
                    if isinstance(el, ast.Name):
                        out.add(el.id)
        return out

    # -- body scan ---------------------------------------------------------

    def _scan(self, sf: SourceFile, fn, body, aliases: Set[str],
              params: Set[str], seen: Set[int]) -> Iterable[Finding]:
        scope = u.TensorScope(fn, aliases)
        scope.names |= params
        syncs = {}
        for lineno, _shape, what in u.scan_host_syncs(
                fn, scope, any_receiver=True):
            syncs.setdefault(lineno, what)
        for stmt in body:
            for node in ast.walk(stmt):
                if id(node) in seen:
                    continue
                f = self._check_node(sf, node, scope, syncs)
                if f is not None:
                    seen.add(id(node))
                    yield f

    def _check_node(self, sf: SourceFile, node: ast.AST,
                    scope: u.TensorScope, syncs) -> Optional[Finding]:
        if isinstance(node, ast.Call) and node.lineno in syncs:
            what = syncs.pop(node.lineno)
            return self.finding(
                sf, node.lineno,
                f"{what} inside a captured region waits for the "
                f"device: CUDA graph capture fails on it (torch.compile "
                f"breaks the graph); move it outside the capture")
        if isinstance(node, (ast.If, ast.While)):
            if _test_depends_on_tensor(node.test, scope):
                kind = "if" if isinstance(node, ast.If) else "while"
                return self.finding(
                    sf, node.lineno,
                    f"Python `{kind}` on a tensor's value inside a "
                    f"captured region syncs to read it, and the graph "
                    f"replays only the branch taken at capture; use "
                    f"torch.where, or branch outside the capture")
        return None


def _test_depends_on_tensor(test: ast.AST, scope: u.TensorScope) -> bool:
    """Does a condition read a tensor's VALUE? `x is None`,
    `isinstance(x, ...)`, `len(x)`, and `x.shape`-style metadata are
    static and excluded."""
    if isinstance(test, ast.Compare) and \
            all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
        return False
    if isinstance(test, ast.Call):
        if u.last_part(u.dotted(test.func)) in STATIC_CALLS:
            return False
        if isinstance(test.func, ast.Attribute) and \
                test.func.attr in u.NON_TENSOR_METHODS:
            return _test_depends_on_tensor(test.func.value, scope)
        return scope.is_tensor(test) or \
            any(_test_depends_on_tensor(a, scope) for a in test.args)
    if isinstance(test, ast.Name):
        return test.id in scope.names
    if isinstance(test, ast.Attribute):
        if test.attr in u.STATIC_ATTRS:
            return False
        return scope.is_tensor(test) or \
            _test_depends_on_tensor(test.value, scope)
    if isinstance(test, ast.Subscript):
        return _test_depends_on_tensor(test.value, scope)
    if isinstance(test, ast.UnaryOp):
        return _test_depends_on_tensor(test.operand, scope)
    if isinstance(test, ast.BoolOp):
        return any(_test_depends_on_tensor(v, scope) for v in test.values)
    if isinstance(test, ast.BinOp):
        return _test_depends_on_tensor(test.left, scope) or \
            _test_depends_on_tensor(test.right, scope)
    if isinstance(test, ast.Compare):
        return _test_depends_on_tensor(test.left, scope) or \
            any(_test_depends_on_tensor(c, scope) for c in test.comparators)
    return False
