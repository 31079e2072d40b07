"""Text-RAG vs graph-RAG vs combined-RAG evaluation router.

The port's copy of generativeaiexamples_tpu/kg/evaluation.py.

Port of the reference's evaluation router
(backend/routers/evaluation.py:57-260): generate QA pairs from the
corpus, answer each question three ways (vector-only, graph-only,
combined), and score every answer — the reference uses the
nemotron-4-340b reward endpoint; here the scoring seam is the existing
LLM-judge from eval.metrics (any scorer with the same signature plugs
in). Progress streams as an iterator so servers can SSE it
(evaluation.py:190-260 streams the same way).
"""

from __future__ import annotations

import json
import logging
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

from generativeaiexamples_tpu_torch.kg.extraction import (
    extract_query_entities)
from generativeaiexamples_tpu_torch.kg.graph import EntityGraph

_LOG = logging.getLogger(__name__)

QA_PROMPT = (
    "From the paragraph below, write one complex question that needs "
    "multi-step reasoning over a large part of the text, and its "
    "detailed answer. Output ONLY JSON: "
    '{"question": "...", "answer": "..."}'
)

ANSWER_SYSTEM = (
    "You are a helpful AI assistant named Envie. You will reply to "
    "questions only based on the context that you are provided. If "
    "something is out of context, you will refrain from replying and "
    "politely decline to respond to the user."
)

NO_GRAPH_CONTEXT = (
    "No graph triples were available to extract from the knowledge "
    "graph. Always provide a disclaimer if you know the answer to the "
    "user's question, since it is not grounded in the knowledge you are "
    "provided from the graph."
)


def generate_qa_pairs(chunks: Sequence[str], llm,
                      max_pairs: int = 10) -> List[Dict[str, str]]:
    """Synthetic QA from corpus chunks (preprocessor.py:84-96)."""
    pairs: List[Dict[str, str]] = []
    for chunk in chunks[:max_pairs]:
        raw = llm.chat([{"role": "system", "content": QA_PROMPT},
                        {"role": "user", "content": chunk}],
                       temperature=0.2, max_tokens=512)
        m = re.search(r"\{.*\}", raw or "", re.DOTALL)
        if not m:
            continue
        try:
            data = json.loads(m.group(0))
        except json.JSONDecodeError:
            continue
        if data.get("question") and data.get("answer"):
            pairs.append({"question": str(data["question"]),
                          "answer": str(data["answer"])})
    return pairs


class RagModeComparison:
    """Answer one question via text / graph / combined retrieval
    (evaluation.py:100-147's three response paths)."""

    def __init__(self, llm, retriever, graph: EntityGraph, *, top_k: int = 5):
        self.llm = llm
        self.retriever = retriever
        self.graph = graph
        self.top_k = top_k

    def _answer(self, context: str, question: str) -> str:
        return self.llm.chat(
            [{"role": "system", "content": ANSWER_SYSTEM},
             {"role": "user",
              "content": f"Context: {context}\n\nUser query: {question}"}],
            max_tokens=512)

    def _text_context(self, question: str) -> str:
        hits = self.retriever.retrieve(question, top_k=self.top_k,
                                       with_threshold=False)
        return ("Here are the relevant passages from the knowledge "
                "base: \n\n" + "\n".join(h.text for h in hits)) if hits else ""

    def _graph_ctx(self, question: str) -> str:
        entities = extract_query_entities(self.llm, question)
        triplets: List[str] = []
        for e in entities:
            triplets.extend(self.graph.get_entity_knowledge(e, depth=2))
        return ("Here are the relationships from the knowledge graph: "
                + "\n".join(dict.fromkeys(triplets))) if triplets else ""

    def text_rag(self, question: str, text_ctx: Optional[str] = None) -> str:
        ctx = self._text_context(question) if text_ctx is None else text_ctx
        return self._answer(ctx or NO_GRAPH_CONTEXT, question)

    def graph_rag(self, question: str,
                  graph_ctx: Optional[str] = None) -> str:
        ctx = self._graph_ctx(question) if graph_ctx is None else graph_ctx
        return self._answer(ctx or NO_GRAPH_CONTEXT, question)

    def combined_rag(self, question: str, text_ctx: Optional[str] = None,
                     graph_ctx: Optional[str] = None) -> str:
        tc = self._text_context(question) if text_ctx is None else text_ctx
        gc = self._graph_ctx(question) if graph_ctx is None else graph_ctx
        parts = [p for p in (tc, gc) if p]
        return self._answer("\n\n".join(parts) or NO_GRAPH_CONTEXT, question)

    def process_question(self, question: str, gt_answer: str) -> Dict:
        """All three answers concurrently; retrieval and the entity-
        extraction LLM call run ONCE and are shared across the modes
        (evaluation.py:78-95 re-runs them per mode — 2x the traffic)."""
        text_ctx = self._text_context(question)
        graph_ctx = self._graph_ctx(question)
        with ThreadPoolExecutor(max_workers=3) as pool:
            ft = pool.submit(self.text_rag, question, text_ctx)
            fg = pool.submit(self.graph_rag, question, graph_ctx)
            fc = pool.submit(self.combined_rag, question, text_ctx,
                             graph_ctx)
            return {
                "question": question,
                "gt_answer": gt_answer,
                "textRAG_answer": ft.result(),
                "graphRAG_answer": fg.result(),
                "combined_answer": fc.result(),
            }


def run_evaluation(
    qa_pairs: Sequence[Dict[str, str]], comparison: RagModeComparison,
    scorer: Optional[Callable[[str, str, str], float]] = None,
) -> Iterator[Dict]:
    """Yields one result row per question; with a `scorer(question,
    gt_answer, answer) -> float` each RAG mode gets a score column
    (reward-model role, evaluation.py:62-76). Final yield is the
    summary row with per-mode means."""
    sums = {"textRAG": 0.0, "graphRAG": 0.0, "combined": 0.0}
    counts = {"textRAG": 0, "graphRAG": 0, "combined": 0}
    for i, pair in enumerate(qa_pairs):
        row = comparison.process_question(pair["question"], pair["answer"])
        if scorer is not None:
            for mode, key in (("textRAG", "textRAG_answer"),
                              ("graphRAG", "graphRAG_answer"),
                              ("combined", "combined_answer")):
                try:
                    row[f"{mode}_score"] = float(
                        scorer(row["question"], row["gt_answer"], row[key]))
                    sums[mode] += row[f"{mode}_score"]
                    counts[mode] += 1  # failed calls don't deflate means
                except Exception as e:
                    _LOG.warning("scorer failed for %s: %s", mode, e)
                    row[f"{mode}_score"] = None
        row["progress"] = (i + 1, len(qa_pairs))
        yield row
    if scorer is not None and any(counts.values()):
        yield {"summary": {m: (sums[m] / counts[m] if counts[m] else None)
                           for m in sums}}
