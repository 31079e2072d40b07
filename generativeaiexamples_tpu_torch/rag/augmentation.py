"""Answer-quality features: the fact-check guardrail and query
augmentation.

The port's copy of generativeaiexamples_tpu/rag/augmentation.py: the
fact-check guardrail that verifies a generated answer against its
retrieval context, multi-query expansion, HyDE-style hypothetical-answer
augmentation, history-aware query rewriting, and reciprocal-rank fusion
of the variants' hit lists. They need only the LLM connector and (for
fusion) the retriever.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Sequence

_LOG = logging.getLogger(__name__)

FACT_CHECK_SYSTEM = (
    "Fact-check a language model's response. You get context documents "
    "as [[CONTEXT]], the user's question as [[QUESTION]], and the "
    "model's response as [[RESPONSE]]. Verify every claim in the "
    "response strictly against the context — no outside knowledge. "
    "If the response is fully supported, start your reply with 'TRUE'; "
    "otherwise start with 'FALSE'. Then explain which claims are or are "
    "not supported, and optionally suggest follow-up questions the "
    "context could answer."
)

MULTI_QUERY_SYSTEM = (
    "Suggest {n} additional self-contained questions related to the "
    "user's question, each covering a different aspect of the topic, "
    "concise and without compound sentences. Output one question per "
    "line with no numbering."
)

HYDE_SYSTEM = (
    "Write a detailed, plausible answer to the user's question, the way "
    "authoritative documentation on the topic would phrase it. This "
    "hypothetical answer is used for retrieval only."
)

REWRITE_SYSTEM = (
    "Rewrite the user's latest question as a fully self-contained "
    "query, resolving every pronoun and reference using the "
    "conversation history. Output only the rewritten question."
)


def fact_check(llm, evidence: str, query: str, response: str,
               **llm_settings) -> Iterator[str]:
    """Stream the guardrail verdict (starts with TRUE/FALSE) —
    fact_check.py:29-37 contract."""
    user = (f"[[CONTEXT]]\n\n{evidence}\n\n[[QUESTION]]\n\n{query}\n\n"
            f"[[RESPONSE]]\n\n{response}")
    yield from llm.stream_chat(
        [{"role": "system", "content": FACT_CHECK_SYSTEM},
         {"role": "user", "content": user}], **llm_settings)


def fact_check_verdict(llm, evidence: str, query: str, response: str
                       ) -> bool:
    """True when the guardrail judges the response grounded."""
    text = "".join(fact_check(llm, evidence, query, response,
                              max_tokens=512)).strip()
    return text.upper().startswith("TRUE")


def augment_multiple_query(llm, query: str, n: int = 5) -> List[str]:
    """Related-question expansion (Multimodal_Assistant.py:112-130)."""
    out = llm.chat(
        [{"role": "system", "content": MULTI_QUERY_SYSTEM.format(n=n)},
         {"role": "user", "content": f"Question: {query}"}],
        max_tokens=512)
    return [ln.strip() for ln in out.splitlines() if ln.strip()][:n]


def augment_query_generated(llm, query: str) -> str:
    """HyDE: hypothetical answer used as the retrieval query
    (Multimodal_Assistant.py:133-150)."""
    return llm.chat([{"role": "system", "content": HYDE_SYSTEM},
                     {"role": "user", "content": f"Question: {query}"}],
                    max_tokens=512)


def query_rewriting(llm, query: str,
                    history: Sequence[Dict[str, str]]) -> str:
    """History-aware standalone-query rewrite. Empty history is a no-op
    (nothing to resolve — skip the LLM round-trip)."""
    if not history:
        return query
    convo = "\n".join(f"{m['role']}: {m['content']}" for m in history)
    out = llm.chat(
        [{"role": "system", "content": REWRITE_SYSTEM},
         {"role": "user",
          "content": f"History:\n{convo}\n\nLatest question: {query}"}],
        max_tokens=256).strip()
    return out or query


def fuse_ranked(hit_lists: Sequence[List], *, top_k: int = 4,
                rrf_k: int = 60) -> List:
    """Reciprocal-rank-fusion over pre-ranked hit lists (one per query
    variant). Dedupes by text; empty when every list is empty (so the
    'no relevant documents' short-circuit still fires)."""
    scores: Dict[str, float] = {}
    hits_by_text: Dict[str, object] = {}
    for hits in hit_lists:
        for rank, hit in enumerate(hits):
            scores[hit.text] = scores.get(hit.text, 0.0) \
                + 1.0 / (rrf_k + rank + 1)
            hits_by_text.setdefault(hit.text, hit)
    ranked = sorted(scores, key=scores.get, reverse=True)[:top_k]
    return [hits_by_text[t] for t in ranked]


def retrieve_fused(search_fn, queries: Sequence[str], *,
                   top_k: int = 4, rrf_k: int = 60) -> List:
    """RRF over several query variants via `search_fn(query) -> ranked
    hits`, the pipeline's CONFIGURED retrieval path — fusion must not
    silently bypass ranked_hybrid/thresholds by going straight to dense
    search. Prefer Retriever.retrieve_multi, which fuses the same way
    but batches every dense leg into one device dispatch."""
    return fuse_ranked([search_fn(q) for q in queries],
                       top_k=top_k, rrf_k=rrf_k)
