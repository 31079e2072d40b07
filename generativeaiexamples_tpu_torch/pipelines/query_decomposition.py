"""Recursive query-decomposition agent (reference:
examples/query_decomposition_rag/chains.py).

The port's copy of generativeaiexamples_tpu/pipelines/query_decomposition.py.

Behavioral parity: an agent loop that decomposes a complex question into
sub-questions, answering each with a Search tool (RAG over the ingested
docs, chains.py:343-354) or a Math tool (LLM extracts the arithmetic,
chains.py:357-384), keeping a Ledger of intermediate Q/A pairs
(chains.py:70), bounded depth (max 3 recursions, stop conditions in
CustomOutputParser chains.py:150-185), then a final-answer prompt over
the ledger (run_agent chains.py:291-308).

Deliberate divergence: the reference `eval()`s LLM-generated python for
math; here arithmetic goes through a restricted AST evaluator — no code
execution.
"""

from __future__ import annotations

import ast
import json
import logging
import operator
import re
from typing import Dict, Generator, List, Tuple

from generativeaiexamples_tpu_torch.pipelines.base import register_example
from generativeaiexamples_tpu_torch.pipelines.developer_rag import QAChatbot

_LOG = logging.getLogger(__name__)

MAX_STEPS = 6  # tool calls total
MAX_DEPTH = 3  # reference: max 3 recursions

_DECIDE_PROMPT = """\
You are a question-decomposition agent. You answer complex questions by
breaking them into sub-questions and using tools.

Tools:
- search: look up facts in the knowledge base. Input: a simple factual
  sub-question.
- math: do arithmetic on numbers you already found. Input: an arithmetic
  expression using numbers (e.g. "(120 - 85) / 85 * 100").
- final: you have enough information to answer.

Findings so far:
{ledger}

Question: {question}

Reply with ONE json object only, no prose:
{{"action": "search", "input": "<sub-question>"}}
or {{"action": "search", "input": ["<sub-question>", "<sub-question>"]}}
  (when several independent facts are needed at once)
or {{"action": "math", "input": "<arithmetic expression>"}}
or {{"action": "final", "answer": "<answer>"}}"""

_FINAL_PROMPT = """\
Answer the original question using the findings.

Findings:
{ledger}

Question: {question}

Give a concise final answer."""

_ALLOWED_OPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod, ast.Pow: operator.pow,
    ast.USub: operator.neg, ast.UAdd: operator.pos,
}


def safe_eval_arithmetic(expr: str) -> float:
    """Arithmetic-only AST evaluation (numbers + - * / // % ** parens).
    Replaces the reference's raw eval() of LLM output."""
    expr = expr.strip().replace("^", "**").replace(",", "")

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.BinOp) and type(node.op) in _ALLOWED_OPS:
            return _ALLOWED_OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _ALLOWED_OPS:
            return _ALLOWED_OPS[type(node.op)](ev(node.operand))
        raise ValueError(f"disallowed expression element: {ast.dump(node)}")

    return ev(ast.parse(expr, mode="eval"))


class Ledger:
    """Intermediate findings (reference chains.py:70)."""

    def __init__(self):
        self.entries: List[Tuple[str, str]] = []

    def add(self, question: str, answer: str) -> None:
        self.entries.append((question, answer))

    def render(self) -> str:
        if not self.entries:
            return "(none yet)"
        return "\n".join(f"- Q: {q}\n  A: {a}" for q, a in self.entries)


def _parse_action(text: str) -> Dict:
    """Extract the first JSON object from the LLM reply (parser parity:
    CustomOutputParser chains.py:150-185, with malformed-output stop)."""
    m = re.search(r"\{.*\}", text, re.S)
    if not m:
        return {"action": "final", "answer": text.strip()}
    try:
        obj = json.loads(m.group(0))
    except json.JSONDecodeError:
        return {"action": "final", "answer": text.strip()}
    if not isinstance(obj, dict) or "action" not in obj:
        return {"action": "final", "answer": text.strip()}
    return obj


@register_example("query_decomposition")
class QueryDecompositionAgent(QAChatbot):
    def _search_many(self, sub_qs: List[str]) -> List[str]:
        """Score ALL sub-questions against the store in ONE device
        dispatch (retrieve_batch -> store.search_batch), then answer
        each from its own context."""
        batches = self.res.retriever.retrieve_batch(sub_qs,
                                                    with_threshold=False)
        answers = []
        for sub_q, results in zip(sub_qs, batches):
            results = self.res.retriever.limit_tokens(results, budget=400)
            if not results:
                answers.append("No relevant information found.")
                continue
            context = "\n".join(r.text for r in results)
            answers.append(self.res.llm.chat([
                {"role": "system",
                 "content": "Answer briefly and only from the context.\n\n"
                            f"Context:\n{context}"},
                {"role": "user", "content": sub_q},
            ], max_tokens=128))
        return answers

    def _search(self, sub_q: str) -> str:
        return self._search_many([sub_q])[0]

    def _math(self, expr: str) -> str:
        try:
            return str(safe_eval_arithmetic(expr))
        except (ValueError, SyntaxError, ZeroDivisionError, KeyError) as e:
            return f"math error: {e}"

    def rag_chain(self, query: str, chat_history, **llm_settings
                  ) -> Generator[str, None, None]:
        ledger = Ledger()
        depth = 0
        searches_left = MAX_STEPS  # total sub-question budget: a list
        # input must not multiply LLM calls past the scalar-input bound
        for _ in range(MAX_STEPS):
            reply = self.res.llm.chat([{
                "role": "user",
                "content": _DECIDE_PROMPT.format(
                    ledger=ledger.render(), question=query),
            }], max_tokens=256)
            act = _parse_action(reply)
            action = str(act.get("action", "final")).lower()
            if action == "search":
                if searches_left <= 0:
                    break
                depth += 1
                raw = act.get("input", query)
                # A list of sub-questions is scored in one batched
                # store dispatch; a plain string is the 1-element case.
                # Each entry spends the shared search budget — the list
                # is model-supplied and must not amplify retrievals/LLM
                # calls past what scalar inputs could reach.
                sub_qs = ([str(s) for s in raw
                           if str(s).strip()][:searches_left]
                          if isinstance(raw, list) else [str(raw)])
                sub_qs = sub_qs or [query]
                searches_left -= len(sub_qs)
                for sub_q, ans in zip(sub_qs, self._search_many(sub_qs)):
                    ledger.add(sub_q, ans)
            elif action == "math":
                expr = str(act.get("input", ""))
                ledger.add(f"compute {expr}", self._math(expr))
            else:
                break
            if depth >= MAX_DEPTH:
                break
        yield from self.res.llm.stream_chat([{
            "role": "user",
            "content": _FINAL_PROMPT.format(ledger=ledger.render(),
                                            question=query),
        }], **llm_settings)
