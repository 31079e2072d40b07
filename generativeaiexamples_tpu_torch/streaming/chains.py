"""Intent-routed streaming RAG chain (framework-neutral).

Counterpart of generativeaiexamples_tpu/streaming/chains.py:

1. classify the question's intent — SpecificTopic | RecentSummary |
   TimeWindow | Unknown (common.py:134-140),
2. for time-based intents, classify the time units (TimeResponse,
   common.py:124-132) and retrieve from the timestamp index,
3. when a time window yields more context than max_docs, recursively
   summarize up to MAX_SUMMARIZATION_ATTEMPTS rounds (chains.py:32,
   139-150) or truncate,
4. otherwise do similarity retrieval.

Status breadcrumbs ("*Found N entries...*") stream to the client
exactly like the reference so UIs can show the routing decisions.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
import time
from typing import Iterator, List, Optional

from generativeaiexamples_tpu_torch.streaming.accumulator import (
    StreamingStore, TextAccumulator)
from generativeaiexamples_tpu_torch.streaming.prompts import (
    INTENT_PROMPT, RAG_PROMPT, RECENCY_PROMPT, SUMMARIZATION_PROMPT)
from generativeaiexamples_tpu_torch.streaming.timestamps import TimedDoc

_LOG = logging.getLogger(__name__)

MAX_SUMMARIZATION_ATTEMPTS = 3

_UNIT_SECONDS = {
    "second": 1.0, "seconds": 1.0, "sec": 1.0, "secs": 1.0, "s": 1.0,
    "minute": 60.0, "minutes": 60.0, "min": 60.0, "mins": 60.0, "m": 60.0,
    "hour": 3600.0, "hours": 3600.0, "hr": 3600.0, "hrs": 3600.0, "h": 3600.0,
    "day": 86400.0, "days": 86400.0, "d": 86400.0,
    "week": 604800.0, "weeks": 604800.0,
}


@dataclasses.dataclass
class TimeResponse:
    """How far back the user asked about (common.py:124-132)."""

    timeNum: float = 0.0
    timeUnit: str = "seconds"

    def to_seconds(self) -> float:
        unit = _UNIT_SECONDS.get(self.timeUnit.strip().lower())
        if unit is None:
            raise ValueError(f"unknown time unit {self.timeUnit!r}")
        return float(self.timeNum) * unit


@dataclasses.dataclass
class UserIntent:
    """Question routing decision (common.py:134-140)."""

    intentType: str = "Unknown"

    VALID = ("SpecificTopic", "RecentSummary", "TimeWindow", "Unknown")

    def __post_init__(self):
        if self.intentType not in self.VALID:
            self.intentType = "Unknown"


def _extract_json(text: str) -> Optional[dict]:
    """Parse LLM output as JSON; fall back to the first {...} block
    (the reference's sanitize_json rescue, utils.py:41-59)."""
    try:
        out = json.loads(text)
        return out if isinstance(out, dict) else None
    except (json.JSONDecodeError, TypeError):
        pass
    m = re.search(r"\{.*?\}", text or "", re.DOTALL)
    if m:
        try:
            out = json.loads(m.group(0))
            return out if isinstance(out, dict) else None
        except json.JSONDecodeError:
            return None
    return None


def classify(llm, question: str, system_prompt: str, cls):
    """LLM -> JSON -> dataclass; None when unparseable (utils.py:41-59)."""
    raw = llm.chat([{"role": "system", "content": system_prompt},
                    {"role": "user", "content": question}],
                   temperature=0.0, max_tokens=128)
    data = _extract_json(raw)
    if data is None:
        _LOG.error("could not parse %s from %r", cls.__name__, raw)
        return None
    fields = {f.name for f in dataclasses.fields(cls)}
    try:
        return cls(**{k: v for k, v in data.items() if k in fields})
    except (TypeError, ValueError) as e:
        _LOG.error("invalid %s payload %r: %s", cls.__name__, data, e)
        return None


class StreamingRagChain:
    """One answer per instance, like the reference's per-request RagChain
    (server.py:69-70 constructs it per /generate call)."""

    def __init__(self, llm, text_accumulator: TextAccumulator,
                 retv_interface: StreamingStore, *, max_docs: int = 4,
                 allow_summary: bool = True, max_tokens: int = 512,
                 now: Optional[float] = None):
        self.llm = llm
        self.text_accumulator = text_accumulator
        self.timestamp_db = text_accumulator.timestamp_db
        self.retv_interface = retv_interface
        self.max_docs = max_docs
        self.allow_summary = allow_summary
        self.max_tokens = max_tokens
        self._now = now  # injectable clock for tests

    # -- generation over retrieved context ---------------------------------

    def _generate(self, question: str, texts: List[str]) -> Iterator[str]:
        yield from self.llm.stream_chat(
            [{"role": "system", "content": RAG_PROMPT},
             {"role": "user",
              "content": f"Transcript: '{chr(10).join(texts)}'\n"
                         f"User: '{question}'\nAI:"}],
            max_tokens=self.max_tokens)

    # -- routing (chains.py:67-110) ----------------------------------------

    def answer(self, question: str,
               use_knowledge_base: bool = True) -> Iterator[str]:
        if not use_knowledge_base:
            yield from self.llm.stream_chat(
                [{"role": "user", "content": question}],
                max_tokens=self.max_tokens)
            return

        intent = classify(self.llm, question, INTENT_PROMPT, UserIntent)
        if intent is None or intent.intentType == "Unknown":
            _LOG.warning("unknown user intent, falling back to basic RAG")
        elif intent.intentType in ("RecentSummary", "TimeWindow"):
            try:
                recency = classify(self.llm, question, RECENCY_PROMPT,
                                   TimeResponse)
                if intent.intentType == "RecentSummary":
                    yield from self.answer_by_recent(question, recency)
                else:
                    yield from self.answer_by_past(question, recency)
                return
            except Exception as e:
                _LOG.warning(
                    "exception %s answering with %s, falling back to "
                    "basic RAG", e, intent.intentType)
        yield from self.answer_by_relevance(question)

    def answer_by_relevance(self, question: str) -> Iterator[str]:
        hits = self.retv_interface.search(question, max_entries=self.max_docs)
        if not hits:
            yield "*Found no documents related to the query*"
            return
        yield f"*Returned {len(hits)} related entries*\n\n"
        yield from self._generate(question, [h.text for h in hits])

    def answer_by_recent(self, question: str,
                         recency: TimeResponse) -> Iterator[str]:
        seconds = recency.to_seconds()
        now = self._now if self._now is not None else time.time()
        docs = self.timestamp_db.recent(now - seconds)
        yield f"*Found {len(docs)} entries from the last {seconds:.0f}s*\n"
        docs = yield from self._fit_context(docs, keep="newest", now=now)
        if docs:
            yield "\n"
            yield from self._generate(question, [d.content for d in docs])

    def answer_by_past(self, question: str, recency: TimeResponse,
                       window: float = 90.0) -> Iterator[str]:
        seconds = recency.to_seconds()
        now = self._now if self._now is not None else time.time()
        tstamp = now - seconds
        docs = self.timestamp_db.past(tstamp, window=window)
        yield (f"*Found {len(docs)} entries from {seconds:.0f}s ago "
               f"(+/- {window:.0f}s)*\n")
        docs = yield from self._fit_context(docs, keep="closest",
                                            target=tstamp, now=now)
        if docs:
            yield "\n"
            yield from self._generate(question, [d.content for d in docs])

    # -- context budgeting (chains.py:134-185) -----------------------------

    def _fit_context(self, docs: List[TimedDoc], keep: str,
                     target: Optional[float] = None,
                     now: Optional[float] = None):
        if len(docs) <= self.max_docs:
            return docs
        if self.allow_summary:
            yield "*Using summarization to reduce context*\n"
            for attempt in range(MAX_SUMMARIZATION_ATTEMPTS):
                docs = self.summarize(docs)
                yield (f"*Reduced to {len(docs)} entries on attempt "
                       f"{attempt + 1}*\n")
                if len(docs) <= self.max_docs:
                    break
            return docs[-self.max_docs:]
        if keep == "closest" and target is not None:
            docs = sorted(docs, key=lambda d: abs(d.tstamp - target))
            docs = docs[:self.max_docs]
            dt = abs(docs[-1].tstamp - target)
            yield (f"*Reduced to last {len(docs)} entries, furthest is "
                   f"{dt:.0f}s away*\n")
            return docs
        docs = docs[-self.max_docs:]
        age = (now or time.time()) - docs[0].tstamp
        yield (f"*Reduced to last {len(docs)} entries, oldest is from "
               f"{age:.0f}s ago*\n")
        return docs

    def summarize(self, docs: List[TimedDoc]) -> List[TimedDoc]:
        """LLM-reduce max_docs-sized groups, then re-chunk
        (chains.py:187-200). Summaries inherit the newest source time so
        time ordering stays meaningful."""
        splitter = self.text_accumulator.splitter
        parts: List[str] = []
        for i in range(0, len(docs), self.max_docs):
            group = docs[i:i + self.max_docs]
            text = " ".join(d.content for d in group)
            parts.append(self.llm.chat(
                [{"role": "system", "content": SUMMARIZATION_PROMPT},
                 {"role": "user", "content": text}],
                max_tokens=self.max_tokens))
        tstamp = docs[-1].tstamp
        source = docs[-1].source_id
        return [TimedDoc(content=c, tstamp=tstamp, source_id=source)
                for c in splitter.split(" ".join(parts))]
