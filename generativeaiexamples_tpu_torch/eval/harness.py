"""Eval harness: synthetic QA generation, answers from a chain server,
metric reports.

Counterpart of generativeaiexamples_tpu/eval/harness.py:
 01 synthetic QA pairs from chunks   02 answers through the chain
 server's REST API (/documents, /search, /generate; `urllib` here,
 `requests` in the JAX copy)   03 RAGAS-style metrics   04 LLM judge.
Rows keep the JAX harness's JSON schema, so datasets and reports
interchange between the packages.
"""

from __future__ import annotations

import json
import logging
import os
import re
import urllib.request
from typing import Dict, List, Optional, Sequence

from generativeaiexamples_tpu_torch.utils import http

_LOG = logging.getLogger(__name__)

_QA_PROMPT = """\
Generate one question-answer pair about the following passage. The
question must be answerable from the passage alone.

Passage:
{chunk}

Reply with one JSON object: {{"question": "...", "answer": "..."}}"""


def generate_synthetic_qa(llm, chunks: Sequence[str],
                          n_pairs: Optional[int] = None) -> List[Dict]:
    """Chunks -> [{question, ground_truth_answer, ground_truth_context}]."""
    out = []
    for chunk in chunks[: n_pairs or len(chunks)]:
        reply = llm.chat([{"role": "user",
                           "content": _QA_PROMPT.format(chunk=chunk)}],
                         max_tokens=256, temperature=0.0)
        m = re.search(r"\{.*\}", reply, re.S)
        if not m:
            continue
        try:
            obj = json.loads(m.group(0))
            out.append({
                "question": str(obj["question"]),
                "ground_truth_answer": str(obj["answer"]),
                "ground_truth_context": chunk,
            })
        except (json.JSONDecodeError, KeyError):
            _LOG.info("unparseable QA pair; skipping")
    return out


class ChainServerClient:
    """Minimal REST client for the chain server (answer generation)."""

    def __init__(self, base_url: str = "http://localhost:8081",
                 timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, body: bytes, ctype: str):
        url = f"{self.base_url}{path}"
        status, out = http.request("POST", url, body=body, timeout=self.timeout,
                                   headers={"Content-Type": ctype})
        return http.checked(status, out, url)

    def upload(self, path: str) -> None:
        with open(path, "rb") as fh:
            body, ctype = http.multipart_body(files=[(
                "file", (os.path.basename(path), fh.read(), None))])
        self._post("/documents", body, ctype)

    def search(self, query: str, top_k: int = 4) -> List[Dict]:
        out = self._post("/search", http.json_body(
            {"query": query, "top_k": top_k}), "application/json")
        return json.loads(out).get("chunks", [])

    def generate(self, question: str, use_kb: bool = True,
                 **settings) -> str:
        body = {"messages": [{"role": "user", "content": question}],
                "use_knowledge_base": use_kb, **settings}
        req = urllib.request.Request(
            f"{self.base_url}/generate", data=http.json_body(body),
            method="POST", headers={"Content-Type": "application/json"})
        pieces = []
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            for line in resp:
                line = line.decode().rstrip("\r\n")
                if not line.startswith("data: "):
                    continue
                try:
                    frame = json.loads(line[6:])
                except json.JSONDecodeError:
                    continue
                choice = frame["choices"][0]
                if choice.get("finish_reason") == "[DONE]":
                    break
                pieces.append(choice["message"]["content"])
        return "".join(pieces)


def generate_answers(client: ChainServerClient, qa_rows: Sequence[Dict],
                     top_k: int = 4) -> List[Dict]:
    """02: query the server per question, capture answer + retrieved
    context."""
    out = []
    for row in qa_rows:
        chunks = client.search(row["question"], top_k=top_k)
        answer = client.generate(row["question"], use_kb=True)
        out.append({
            **row,
            "generated_answer": answer,
            "retrieved_context": [c["content"] for c in chunks],
        })
    return out


def run_eval(llm, embedder, dataset: Sequence[Dict],
             judge_llm=None) -> Dict:
    """03+04: metric suite + judge + model-free retrieval metrics;
    returns the combined report."""
    from generativeaiexamples_tpu_torch.eval.metrics import (
        RagasEvaluator, eval_llm_judge, eval_retrieval)

    ragas = RagasEvaluator(llm, embedder).evaluate(dataset)
    judge = eval_llm_judge(judge_llm or llm, dataset)
    retrieval = eval_retrieval(dataset)
    return {"ragas": ragas, "llm_judge": judge, "retrieval": retrieval,
            "n": len(dataset)}


def save_report(report: Dict, path: str) -> None:
    from generativeaiexamples_tpu_torch.utils.fsio import atomic_write_text

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # tmp + os.replace: a crash mid-dump must not truncate a report a
    # previous run already wrote.
    atomic_write_text(path, json.dumps(report, indent=2))
