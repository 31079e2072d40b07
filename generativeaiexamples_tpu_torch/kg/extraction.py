"""The port's copy of generativeaiexamples_tpu/kg/extraction.py.

LLM triple extraction (reference utils/preprocessor.py:51-82 +
parallel driver lc_graph.py:34-79).

Entity categories and the closed relation-verb set are the reference's
extraction contract — kept verbatim so graphs interchange; the prompt
wording and the parser are fresh. The parser accepts both the
list-of-tuples format the reference demands and JSON lists, inside or
outside code fences, and skips malformed rows instead of failing the
document (preprocessor.py:32-49 behavior).
"""

from __future__ import annotations

import ast
import json
import logging
import re
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, List, Optional, Sequence, Tuple

from generativeaiexamples_tpu_torch.kg.graph import Triple

_LOG = logging.getLogger(__name__)

ENTITY_CATEGORIES = (
    "ORG", "ORG/GOV", "ORG/REG", "PERSON", "GPE", "INSTITUTION", "PRODUCT",
    "EVENT", "FIELD", "METRIC", "TOOL", "CONCEPT",
)

RELATION_VERBS = (
    "Has", "Announce", "Operate_In", "Introduce", "Produce", "Control",
    "Participates_In", "Impact", "Positive_Impact_On",
    "Negative_Impact_On", "Relate_To", "Is_Member_Of", "Invests_In",
    "Raise", "Decrease",
)

TRIPLE_PROMPT = (
    "Extract knowledge-graph triples from the text.\n"
    "Rules:\n"
    f"- Entity types: {', '.join(ENTITY_CATEGORIES)}. Entities must be "
    "concrete (no dates, numbers or generic phrases), at most four "
    "words, with acronyms and long forms unified to one name.\n"
    f"- The relation MUST be one of: {', '.join(RELATION_VERBS)}.\n"
    "- Output ONLY a python list of 5-tuples "
    "[(subject, subject_type, relation, object, object_type), ...]. "
    "No prose, no explanations. Drop a triple rather than emit an "
    "empty or unknown element."
)


def parse_triples(text: str) -> List[Triple]:
    """Best-effort parse of the model's triple list."""
    if not text:
        return []
    body = text.strip()
    fence = re.search(r"```(?:python|json)?\s*(.*?)```", body, re.DOTALL)
    if fence:
        body = fence.group(1).strip()
    m = re.search(r"\[.*\]", body, re.DOTALL)
    if m:
        body = m.group(0)
    rows = None
    for parser in (ast.literal_eval, json.loads):
        try:
            rows = parser(body)
            break
        except (ValueError, SyntaxError, json.JSONDecodeError, TypeError):
            continue
    if not isinstance(rows, (list, tuple)):
        return []
    out: List[Triple] = []
    for row in rows:
        try:
            s, st, r, o, ot = (str(x).strip() for x in row)
        except (TypeError, ValueError):
            continue  # malformed row: skip, don't fail the document
        if not s or not o or not r or s.upper() == "NAN" or o.upper() == "NAN":
            continue
        out.append(Triple(s, st, r, o, ot))
    return out


def extract_triples(llm, text: str) -> List[Triple]:
    """One chunk -> triples (preprocessor.py:51-82)."""
    raw = llm.chat([{"role": "system", "content": TRIPLE_PROMPT},
                    {"role": "user", "content": text}],
                   temperature=0.0, max_tokens=1024)
    return parse_triples(raw)


def process_documents(
    chunks: Sequence[str], llm, *, max_workers: int = 8,
    update_progress: Optional[Callable[[int, int], None]] = None,
) -> List[Triple]:
    """Parallel triple extraction over chunks (lc_graph.py:34-79 used a
    process pool per chunk; LLM calls are network/engine-bound, so a
    thread pool gives the same concurrency without fork hazards). A
    failed chunk contributes nothing instead of failing the batch."""
    triples: List[Triple] = []
    total = len(chunks)
    done = 0
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = [pool.submit(extract_triples, llm, c) for c in chunks]
        for fut in as_completed(futures):
            try:
                triples.extend(fut.result())
            except Exception as e:
                _LOG.warning("triple extraction failed for a chunk: %s", e)
            done += 1
            if update_progress:
                update_progress(done, total)
    _LOG.info("extracted %d triples from %d chunks", len(triples), total)
    return triples


ENTITY_QUERY_PROMPT = (
    "Return ONLY a JSON object {\"entities\": [...]} listing the "
    "entities mentioned in the user's query. Every element must appear "
    "verbatim in the query. No explanations."
)


def extract_query_entities(llm, query: str) -> List[str]:
    """Entities in a user query (routers/chat.py:52-54 contract)."""
    raw = llm.chat([{"role": "system", "content": ENTITY_QUERY_PROMPT},
                    {"role": "user", "content": query}],
                   temperature=0.0, max_tokens=128)
    m = re.search(r"\{.*\}", raw or "", re.DOTALL)
    if not m:
        return []
    try:
        data = json.loads(m.group(0))
    except json.JSONDecodeError:
        return []
    ents = data.get("entities", [])
    return [str(e) for e in ents if str(e).strip()] \
        if isinstance(ents, list) else []
