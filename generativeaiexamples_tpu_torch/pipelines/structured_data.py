"""CSV analytics pipeline (reference: examples/structured_data_rag/
chains.py + csv_utils.py, PandasAI-backed).

The port's copy of generativeaiexamples_tpu/pipelines/structured_data.py.

Parity behaviors:
- ingest: CSVs register into a file list; new files must be column-
  compatible with what's registered (chains.py:107-133).
- rag_chain: an LLM writes a pandas expression against the dataframe
  (the PandasAI Agent.chat role, chains.py:159-230), the result is
  validated (is_result_valid parity, csv_utils.py:102), and a second
  LLM phrases the final answer (the "response chain").
- prompt parameterization per-dataset (csv_prompt_config.yaml parity)
  via config prompts + df description (extract_df_desc, csv_utils.py:26).

Deliberate divergence: PandasAI executes LLM-written Python; here the
LLM may only produce a single pandas EXPRESSION, validated against an
AST allow-list (no statements, no imports, no I/O — file-writing
methods like to_json/to_hdf are rejected structurally, not by regex).
"""

from __future__ import annotations

import ast
import logging
import os
import re
from typing import Dict, Generator, List

from generativeaiexamples_tpu_torch.pipelines.base import BaseExample, register_example

_LOG = logging.getLogger(__name__)

_CODE_PROMPT = """\
You are a data analyst. Given this pandas dataframe `df`:

{df_desc}

Write a SINGLE pandas expression (no assignments, no imports, no print)
that computes the answer to the question. Reply with only the expression
inside a code block.

Question: {question}"""

_ANSWER_PROMPT = """\
Question: {question}
Computation result: {result}

Phrase a concise natural-language answer to the question using the
result."""

# AST allow-list. Only these expression node types may appear; anything
# else (imports, assignments, await, f-string format specs with !, ...)
# is rejected before eval.
_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare,
    ast.Call, ast.Attribute, ast.Subscript, ast.Name, ast.Constant,
    ast.Tuple, ast.List, ast.Dict, ast.Set, ast.Slice, ast.keyword,
    ast.Lambda, ast.arguments, ast.arg, ast.IfExp, ast.ListComp,
    ast.SetComp, ast.DictComp, ast.GeneratorExp, ast.comprehension,
    ast.Starred,
    # operator tokens
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.MatMult, ast.BitAnd, ast.BitOr, ast.BitXor, ast.LShift,
    ast.RShift, ast.Invert, ast.Not, ast.UAdd, ast.USub, ast.And,
    ast.Or, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.In, ast.NotIn, ast.Is, ast.IsNot, ast.Load,
)

# Attribute names that are never allowed: dunder/private access, any
# reader/writer (to_* accept file paths — to_json/to_hdf/to_feather/
# to_stata/to_html/to_latex all write when given one), eval hooks, and
# numpy's file I/O.
_SAFE_TO_METHODS = frozenset(
    {"to_dict", "to_list", "tolist", "to_numpy", "to_frame", "to_records",
     "to_flat_index", "to_series", "to_datetime", "to_numeric",
     "to_timedelta", "to_period", "to_timestamp"})
_DENY_ATTRS = frozenset(
    {"eval", "query", "pipe", "save", "savetxt", "savez",
     "savez_compressed", "dump", "dumps", "tofile", "fromfile", "load",
     "loads", "memmap", "DataSource", "genfromtxt", "loadtxt", "io",
     "open_memmap", "load_library", "compile"})
# np/pd submodules that reach file I/O, ctypes loading, or subprocesses
# (np.lib.format.open_memmap, np.ctypeslib.load_library, np.f2py.compile).
_DENY_SUBMODULES = frozenset(
    {"lib", "ctypeslib", "f2py", "testing", "distutils", "compat",
     "core", "ma", "char", "rec", "emath", "polynomial", "api",
     "arrays", "errors", "util"})
_ROOT_NAMES = frozenset({"df", "pd", "np"})


def _attr_denied(a: str) -> bool:
    return (a.startswith("_") or a.startswith("read_")
            or (a.startswith("to_") and a not in _SAFE_TO_METHODS)
            or a in _DENY_ATTRS)


def _validate_expr_ast(expr: str) -> None:
    """Raise ValueError unless `expr` is a single side-effect-free
    pandas/numpy expression under the allow-list above."""
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as e:
        raise ValueError(f"not a valid expression: {e}") from None
    bound: set = set()  # lambda params + comprehension targets
    for node in ast.walk(tree):
        if isinstance(node, ast.arg):
            bound.add(node.arg)
        elif isinstance(node, ast.comprehension):
            for t in ast.walk(node.target):
                if isinstance(t, ast.Name):
                    bound.add(t.id)
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            if isinstance(node, (ast.Store,)):  # comprehension targets
                continue
            raise ValueError(
                f"disallowed syntax: {type(node).__name__}")
        if isinstance(node, ast.Attribute):
            a = node.attr
            if _attr_denied(a):
                raise ValueError(f"disallowed attribute: {a!r}")
            # np.lib.…, pd.io.… — block the dangerous submodule roots
            # outright; method access on df/Series never needs them.
            if (isinstance(node.value, ast.Name)
                    and node.value.id in ("np", "pd")
                    and a in _DENY_SUBMODULES):
                raise ValueError(f"disallowed submodule: {node.value.id}.{a}")
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id not in _ROOT_NAMES and node.id not in bound:
                raise ValueError(f"disallowed name: {node.id!r}")
        if isinstance(node, ast.keyword) and node.arg and (
                node.arg in ("buf", "path", "path_or_buf",
                             "filepath_or_buffer", "engine")):
            raise ValueError(f"disallowed keyword argument: {node.arg!r}")
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            # pandas dispatches method NAMES passed as strings (e.g.
            # df.apply('to_csv')); vet string literals like attributes.
            if _attr_denied(node.value):
                raise ValueError(
                    f"disallowed method name in string: {node.value!r}")


def extract_df_desc(df) -> str:
    """Schema + head sample (csv_utils.py:26 parity)."""
    lines = [f"rows: {len(df)}", "columns:"]
    for c in df.columns:
        lines.append(f"  - {c} ({df[c].dtype})")
    lines.append("head:")
    lines.append(df.head(3).to_string())
    return "\n".join(lines)


def run_pandas_expression(expr: str, df):
    """Evaluate one pandas expression, AST-validated first."""
    import numpy as np
    import pandas as pd

    expr = expr.strip().strip("`").strip()
    if ";" in expr or "\n" in expr.strip():
        raise ValueError("only a single expression is allowed")
    _validate_expr_ast(expr)
    return eval(expr, {"__builtins__": {}},  # noqa: S307 — AST-validated above
                {"df": df, "pd": pd, "np": np})


def _extract_code(reply: str) -> str:
    m = re.search(r"```(?:python)?\s*(.+?)```", reply, re.S)
    if m:
        return m.group(1).strip()
    return reply.strip().splitlines()[-1].strip()


@register_example("structured_data")
class CSVChatbot(BaseExample):
    MAX_RETRIES = 3  # PandasAI-style retry on bad code

    def _registry(self) -> List[str]:
        return self.res.extras.setdefault("csv_files", [])

    def _frame(self):
        import pandas as pd

        files = self._registry()
        if not files:
            return None
        return pd.concat([pd.read_csv(f) for f in files], ignore_index=True)

    def ingest_docs(self, filepath: str, filename: str) -> None:
        import pandas as pd

        if not filename.lower().endswith(".csv"):
            raise ValueError("structured_data pipeline ingests CSV files only")
        df_new = pd.read_csv(filepath)
        cur = self._frame()
        if cur is not None and list(cur.columns) != list(df_new.columns):
            # column-compat check parity (chains.py:113-131)
            raise ValueError(
                f"column mismatch: {filename} has {list(df_new.columns)}, "
                f"registry has {list(cur.columns)}")
        self._registry().append(filepath)
        _LOG.info("registered CSV %s (%d rows)", filename, len(df_new))

    def llm_chain(self, query: str, chat_history, **llm_settings
                  ) -> Generator[str, None, None]:
        system = self.res.config.prompts.chat_template
        messages = ([{"role": "system", "content": system}]
                    + list(chat_history) + [{"role": "user", "content": query}])
        yield from self.res.llm.stream_chat(messages, **llm_settings)

    def rag_chain(self, query: str, chat_history, **llm_settings
                  ) -> Generator[str, None, None]:
        df = self._frame()
        if df is None:
            yield "No CSV data ingested yet; upload a CSV first."
            return
        desc = extract_df_desc(df)
        result = None
        last_err = ""
        for attempt in range(self.MAX_RETRIES):
            prompt = _CODE_PROMPT.format(df_desc=desc, question=query)
            if last_err:
                prompt += (f"\n\nYour previous expression failed with: "
                           f"{last_err}. Fix it.")
            reply = self.res.llm.chat(
                [{"role": "user", "content": prompt}], max_tokens=256)
            expr = _extract_code(reply)
            try:
                result = run_pandas_expression(expr, df)
                break
            except Exception as e:  # retry with the error in the prompt
                last_err = f"{type(e).__name__}: {e}"
                _LOG.info("pandas expr attempt %d failed: %s", attempt, last_err)
        if result is None:
            yield f"Could not compute an answer from the data ({last_err})."
            return
        result_str = str(result)
        if len(result_str) > 2000:
            result_str = result_str[:2000] + "..."
        yield from self.res.llm.stream_chat([{
            "role": "user",
            "content": _ANSWER_PROMPT.format(question=query, result=result_str),
        }], **llm_settings)

    def get_documents(self) -> List[str]:
        return [os.path.basename(f) for f in self._registry()]

    def delete_documents(self, filenames: List[str]) -> bool:
        names = set(filenames)
        reg = self._registry()
        before = len(reg)
        self.res.extras["csv_files"] = [
            f for f in reg if os.path.basename(f) not in names]
        return len(self.res.extras["csv_files"]) < before
