"""Shared AST helpers for graftlint checks, and the tensor inference
the torch checks share (`TensorScope`)."""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple


def dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for Attribute chains / Names; None for
    anything else."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def last_part(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def str_constants(node: ast.AST) -> List[str]:
    """String literals inside a constant / tuple / list expression."""
    out = []
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        out.append(node.value)
    elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.append(el.value)
    return out


def unwrap_partial(node: ast.AST) -> ast.AST:
    """`functools.partial(f, ...)` -> `f` (recursively); anything else
    unchanged. Lets thread targets / callbacks written as partials
    resolve to the underlying function reference."""
    while isinstance(node, ast.Call) and \
            last_part(dotted(node.func)) == "partial" and node.args:
        node = node.args[0]
    return node


def param_names(fn) -> List[str]:
    """Positional + kw-only parameter names (self/cls dropped)."""
    a = fn.args
    names = [p.arg for p in
             list(getattr(a, "posonlyargs", [])) + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")]


def self_attr_target(node: ast.AST) -> Optional[str]:
    """'_x' when node is `self._x`, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def iter_functions(tree: ast.AST):
    """Every (Async)FunctionDef in the module, including nested."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def walk_stop_at_functions(node: ast.AST, *, include_root: bool = True):
    """Walk `node` without descending into nested function/class
    definitions (their bodies run in a different context)."""
    stack = [node] if include_root else list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                continue
            stack.append(c)


def docstring_of(fn) -> str:
    try:
        return ast.get_docstring(fn) or ""
    except TypeError:
        return ""


def handler_catches_broadly(handler: ast.ExceptHandler) -> Optional[str]:
    """'bare' / 'Exception' / 'BaseException' when the handler is
    broad, else None."""
    t = handler.type
    if t is None:
        return "bare"
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for el in types:
        name = last_part(dotted(el))
        if name in ("Exception", "BaseException"):
            return name
    return None


# -- tensor inference -------------------------------------------------------
#
# The torch checks ask "is this expression a tensor?" without executing
# anything. The answer is conservative (unknown is "no"): a tensor is
# what a `torch.*` call, a tensor method or a dispatch entry returns, a
# parameter annotated `torch.Tensor`, a local or `self.` attribute bound
# to one of those, and arithmetic, indexing or comparison over them.

# `torch.<name>` members that are not tensor factories.
TORCH_NON_TENSOR = {
    "device", "dtype", "Generator", "Size", "Stream", "Event", "no_grad",
    "inference_mode", "enable_grad", "set_grad_enabled", "finfo", "iinfo",
    "is_tensor", "is_floating_point", "is_complex", "numel", "manual_seed",
    "get_default_dtype", "set_default_dtype", "get_num_threads",
    "set_num_threads", "result_type", "promote_types", "can_cast",
    "typename", "use_deterministic_algorithms", "compile", "cuda",
    "distributed", "backends", "autograd", "utils", "nn", "jit", "fx",
    "profiler", "testing", "library", "ops", "_C", "hub", "multiprocessing",
    "get_rng_state", "set_rng_state", "from_file", "save", "load",
    "is_grad_enabled", "is_inference_mode_enabled"}
# Tensor methods whose result is not a tensor.
NON_TENSOR_METHODS = {
    "item", "tolist", "numpy", "size", "dim", "ndimension", "numel",
    "nelement", "element_size", "data_ptr", "stride", "storage_offset",
    "is_contiguous", "is_floating_point", "is_complex", "get_device",
    "untyped_storage", "type", "equal", "allclose", "is_pinned",
    "record_stream", "__len__", "backward", "register_hook", "synchronize",
    "query", "record", "wait", "elapsed_time", "is_set_to"}
# Tensor attributes that are tensors; every other attribute read of a
# tensor (shape, dtype, device, ...) is static metadata.
TENSOR_ATTRS = {"T", "mT", "H", "mH", "data", "grad", "real", "imag"}
# Attribute reads that are static on a tensor (shape metadata).
STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
                "requires_grad", "is_leaf", "itemsize", "nbytes", "size"}
TENSOR_ANNOTATIONS = {"Tensor", "torch.Tensor"}


def torch_aliases(tree: ast.AST) -> Set[str]:
    """Names a module binds to torch or one of its submodules (`import
    torch`, `import torch.nn.functional as F`, `from torch import nn`)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    out.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and \
                (node.module == "torch" or node.module.startswith("torch.")):
            for a in node.names:
                if a.name not in TORCH_NON_TENSOR and a.name != "Tensor":
                    out.add(a.asname or a.name)
    return out


class TensorScope:
    """The tensor-valued names of one function: its locals and
    parameters (`names`) and its class's `self.` attributes (`attrs`,
    as "self.x"). `entry_lines` holds the lines of calls that resolve to
    a dispatch entry, whose results are tensors."""

    def __init__(self, fn, aliases: Set[str],
                 attrs: Optional[Set[str]] = None,
                 entry_lines: Optional[Set[int]] = None):
        self.aliases = aliases
        self.attrs = set(attrs or ())
        self.entry_lines = set(entry_lines or ())
        self.names: Set[str] = set()
        args = getattr(fn, "args", None)
        if args is not None:
            for a in list(getattr(args, "posonlyargs", [])) + args.args + \
                    args.kwonlyargs:
                ann = a.annotation
                if ann is not None and (dotted(ann) in TENSOR_ANNOTATIONS or (
                        isinstance(ann, ast.Constant)
                        and ann.value in TENSOR_ANNOTATIONS)):
                    self.names.add(a.arg)
        body = list(walk_stop_at_functions(fn, include_root=False))
        for _ in range(6):  # fixpoint; function-local, converges fast
            before = len(self.names)
            for st in body:
                if isinstance(st, ast.Assign):
                    for t in st.targets:
                        self._bind(t, st.value)
                elif isinstance(st, ast.AnnAssign) and st.value is not None:
                    self._bind(st.target, st.value)
            if len(self.names) == before:
                break

    def _bind(self, target, value) -> None:
        if isinstance(target, ast.Name):
            if self.is_tensor(value):
                self.names.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            # `a, b = torch.topk(...)` / `pool, toks = entry(...)`
            if isinstance(value, ast.Call) and self.is_tensor(value):
                for el in target.elts:
                    if isinstance(el, ast.Name):
                        self.names.add(el.id)
            elif isinstance(value, (ast.Tuple, ast.List)) and \
                    len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self._bind(t, v)

    def self_targets(self, fn) -> Set[str]:
        """"self.x" for every `self.x = <tensor>` in `fn`."""
        out = set()
        for st in walk_stop_at_functions(fn, include_root=False):
            if isinstance(st, ast.Assign):
                for t in st.targets:
                    attr = self_attr_target(t)
                    if attr is not None and self.is_tensor(st.value):
                        out.add("self." + attr)
        return out

    def is_torch_call(self, func) -> bool:
        name = dotted(func)
        if not name:
            return False
        parts = name.split(".")
        if parts[0] not in self.aliases:
            return False
        return not any(p in TORCH_NON_TENSOR for p in parts[1:]) and \
            parts[-1] not in NON_TENSOR_METHODS

    def is_tensor(self, expr) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        attr = self_attr_target(expr)
        if attr is not None:
            return "self." + attr in self.attrs
        if isinstance(expr, ast.Attribute):
            return expr.attr in TENSOR_ATTRS and self.is_tensor(expr.value)
        if isinstance(expr, ast.Subscript):
            return self.is_tensor(expr.value)
        if isinstance(expr, ast.Call):
            if expr.lineno in self.entry_lines:
                return True
            if self.is_torch_call(expr.func):
                return True
            f = expr.func
            return isinstance(f, ast.Attribute) and \
                f.attr not in NON_TENSOR_METHODS and self.is_tensor(f.value)
        if isinstance(expr, ast.BinOp):
            return self.is_tensor(expr.left) or self.is_tensor(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.is_tensor(expr.operand)
        if isinstance(expr, ast.Compare):
            return self.is_tensor(expr.left) or \
                any(self.is_tensor(c) for c in expr.comparators)
        if isinstance(expr, ast.IfExp):
            return self.is_tensor(expr.body) or self.is_tensor(expr.orelse)
        return False


def class_tensor_attrs(cls_node: ast.ClassDef, aliases: Set[str]) -> Set[str]:
    """"self.x" for every attribute some method of the class binds to a
    tensor (two passes, so an attribute built from another counts)."""
    attrs: Set[str] = set()
    methods = [m for m in cls_node.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for _ in range(2):
        for m in methods:
            attrs |= TensorScope(m, aliases, attrs).self_targets(m)
    return attrs


# -- host syncs (the torch checks' shared vocabulary) ------------------------


def _is_cpu_device(expr) -> bool:
    if isinstance(expr, ast.Constant):
        return expr.value == "cpu"
    if isinstance(expr, ast.Call) and last_part(dotted(expr.func)) == \
            "device" and expr.args:
        return _is_cpu_device(expr.args[0])
    return False


NUMPY_MODULES = ("np", "numpy", "onp")


def scan_host_syncs(fn, scope: TensorScope, any_receiver: bool = False,
                    ) -> Iterable[Tuple[int, str, str]]:
    """(lineno, shape, label) for every host-sync shape in `fn`:
    `.item()` / `.tolist()` of a tensor, `.cpu()`, `.numpy()`,
    `.to("cpu")`, `float()` / `int()` / `bool()` of a tensor,
    `np.asarray` / `np.array` of a tensor, and any `.synchronize()`
    (`torch.cuda.synchronize`, an Event's or a Stream's). The label
    names the call ("`.cpu()` of a tensor"). With `any_receiver`,
    `.item()` / `.tolist()` count whatever their receiver (inside a
    captured region every value they could read is a tensor's)."""
    for node in walk_stop_at_functions(fn, include_root=False):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        f = node.func
        # `x.view(...).numpy()`: the receiver may be a call, with no name
        last = f.attr if isinstance(f, ast.Attribute) else last_part(name)
        if last == "synchronize":
            yield node.lineno, "synchronize", \
                f"`{name or '.synchronize'}()`"
        elif isinstance(f, ast.Attribute) and last in ("cpu", "numpy") \
                and not node.args:
            yield node.lineno, last, f"`.{last}()` of a tensor"
        elif isinstance(f, ast.Attribute) and last in ("item", "tolist") \
                and not node.args and (any_receiver
                                       or scope.is_tensor(f.value)):
            yield node.lineno, last, f"`.{last}()` of a tensor"
        elif isinstance(f, ast.Attribute) and last == "to" and (
                (node.args and _is_cpu_device(node.args[0])) or any(
                    kw.arg == "device" and _is_cpu_device(kw.value)
                    for kw in node.keywords)):
            yield node.lineno, "to", '`.to("cpu")` of a tensor'
        elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool") \
                and node.args and scope.is_tensor(node.args[0]):
            yield node.lineno, f.id, f"`{f.id}()` of a tensor"
        elif last in ("asarray", "array") and name \
                and name.split(".")[0] in NUMPY_MODULES \
                and node.args and scope.is_tensor(node.args[0]):
            yield node.lineno, last, f"`{name}()` of a tensor"
