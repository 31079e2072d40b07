"""Event-driven CVE exploitability analysis.

Counterpart of generativeaiexamples_tpu/agents/cve.py: CVE alerts
stream in, a checklist LLM expands each CVE into concrete verification
items, an agent with RAG tools over the code and docs stores plus an
SBOM lookup investigates every item (a bounded JSON-action loop, one
thread a checklist item), and a final verdict summarizes
exploitability. The LLM is any ChatLLM connector (the in-process
engine on the card, a remote API, a scripted fake).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

_LOG = logging.getLogger(__name__)

CHECKLIST_PROMPT = (
    "You are a security analyst. Given a CVE description, produce a "
    "short checklist of concrete steps to decide whether the "
    "vulnerability is exploitable in OUR software environment (e.g. "
    "check whether the affected component is in the dependency list, "
    "whether the vulnerable code path is used, whether mitigations "
    "exist). Output one step per line, no numbering, 3 to 6 steps."
)

AGENT_PROMPT = (
    "You investigate one checklist item about a CVE using tools. "
    "Available tools:\n"
    "- search_code: search our codebase for relevant code\n"
    "- search_docs: search our documentation\n"
    "- check_sbom: look up a package name in our software bill of "
    "materials\n"
    "Reply with ONE json object only, no prose:\n"
    '{"action": "search_code|search_docs|check_sbom", "input": "..."} '
    'to use a tool, or {"action": "finish", "finding": "..."} when you '
    "can conclude."
)

VERDICT_PROMPT = (
    "Given the CVE description and the findings for each checklist "
    "item, state whether the CVE is likely exploitable in our "
    "environment. Start with 'VULNERABLE' or 'NOT_VULNERABLE' or "
    "'NEEDS_REVIEW', then a one-paragraph justification."
)


def parse_checklist(text: str) -> List[str]:
    """Model output -> list of steps (checklist_node.py _parse_list
    role): strips numbering/bullets, drops empties."""
    items = []
    for line in (text or "").splitlines():
        line = re.sub(r"^\s*(?:[-*•]|\d+[.)])\s*", "", line).strip()
        if line:
            items.append(line)
    return items


@dataclasses.dataclass
class SBOM:
    """Software bill of materials: package -> version (the reference's
    EngineSBOMConfig data_file, a csv of components)."""

    packages: Dict[str, str] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_csv(cls, path: str) -> "SBOM":
        pkgs: Dict[str, str] = {}
        with open(path) as fh:
            for line in fh:
                parts = [p.strip() for p in line.split(",")]
                if len(parts) >= 2 and parts[0] and parts[0] != "name":
                    pkgs[parts[0].lower()] = parts[1]
        return cls(pkgs)

    def lookup(self, name: str) -> str:
        name = name.strip().lower()
        if name in self.packages:
            return f"{name} {self.packages[name]} IS in the SBOM"
        partial = [f"{k} {v}" for k, v in self.packages.items()
                   if name and name in k]
        if partial:
            return "partial SBOM matches: " + "; ".join(partial[:5])
        return f"{name} is NOT in the SBOM"


class CVEAgent:
    """Checklist generation + per-item tool-using investigation +
    verdict (cyber_dev_day pipeline.py:44-137 end-to-end flow)."""

    MAX_STEPS = 4  # tool calls per checklist item (agent loop bound)

    def __init__(self, llm, *, code_retriever=None, docs_retriever=None,
                 sbom: Optional[SBOM] = None, max_workers: int = 4):
        self.llm = llm
        self.code_retriever = code_retriever
        self.docs_retriever = docs_retriever
        self.sbom = sbom or SBOM()
        self.max_workers = max_workers

    # -- tools (tools.py role) ---------------------------------------------

    def _tool(self, action: str, arg: str) -> str:
        if action == "check_sbom":
            return self.sbom.lookup(arg)
        if action not in ("search_code", "search_docs"):
            # Feeding doc snippets under a bogus tool name would mislead
            # the agent for the rest of the loop.
            return (f"unknown tool {action!r}; valid tools: search_code, "
                    "search_docs, check_sbom")
        retriever = (self.code_retriever if action == "search_code"
                     else self.docs_retriever)
        if retriever is None:
            return f"tool {action} is not configured"
        hits = retriever.retrieve(arg, top_k=3, with_threshold=False)
        if not hits:
            return "no results"
        return "\n".join(h.text[:400] for h in hits)

    # -- stages ------------------------------------------------------------

    def generate_checklist(self, cve_info: str) -> List[str]:
        out = self.llm.chat(
            [{"role": "system", "content": CHECKLIST_PROMPT},
             {"role": "user", "content": cve_info}],
            temperature=0.0, max_tokens=512)
        return parse_checklist(out)

    def investigate(self, cve_info: str, item: str) -> Dict:
        """Bounded JSON-action loop for one checklist item."""
        transcript: List[str] = []
        for _ in range(self.MAX_STEPS):
            history = "\n".join(transcript) or "(no tool results yet)"
            raw = self.llm.chat(
                [{"role": "system", "content": AGENT_PROMPT},
                 {"role": "user",
                  "content": f"CVE: {cve_info}\nChecklist item: {item}\n"
                             f"Tool results so far:\n{history}"}],
                temperature=0.0, max_tokens=512)
            m = re.search(r"\{.*\}", raw or "", re.DOTALL)
            if not m:
                return {"item": item, "finding": raw.strip() or
                        "agent produced no parseable action",
                        "steps": transcript}
            try:
                action = json.loads(m.group(0))
            except json.JSONDecodeError:
                return {"item": item, "finding": raw.strip(),
                        "steps": transcript}
            if action.get("action") == "finish":
                return {"item": item,
                        "finding": str(action.get("finding", "")),
                        "steps": transcript}
            name = str(action.get("action", ""))
            arg = str(action.get("input", ""))
            result = self._tool(name, arg)
            transcript.append(f"{name}({arg}) -> {result}")
        return {"item": item,
                "finding": "inconclusive after max tool steps",
                "steps": transcript}

    def verdict(self, cve_info: str, findings: Sequence[Dict]) -> str:
        body = "\n".join(f"- {f['item']}: {f['finding']}" for f in findings)
        return self.llm.chat(
            [{"role": "system", "content": VERDICT_PROMPT},
             {"role": "user",
              "content": f"CVE: {cve_info}\n\nFindings:\n{body}"}],
            temperature=0.0, max_tokens=512)

    def analyze(self, cve_info: str) -> Dict:
        """Full flow for one CVE; checklist items investigate in
        parallel (the reference runs one agent per item)."""
        checklist = self.generate_checklist(cve_info)
        if not checklist:
            return {"cve_info": cve_info, "checklist": [],
                    "findings": [], "verdict": "NEEDS_REVIEW: checklist "
                    "generation produced no items"}
        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            findings = list(pool.map(
                lambda it: self.investigate(cve_info, it), checklist))
        return {"cve_info": cve_info, "checklist": checklist,
                "findings": findings,
                "verdict": self.verdict(cve_info, findings)}


def run_cve_pipeline(events: Sequence[str], agent: CVEAgent,
                     on_result: Optional[Callable[[Dict], None]] = None
                     ) -> List[Dict]:
    """Batch/stream runner (InMemorySourceStage -> LLMEngineStage ->
    InMemorySinkStage role). Feed it a list, or pump an ingest
    QueueSource's items through for the event-driven shape."""
    results = []
    for cve_info in events:
        try:
            res = agent.analyze(cve_info)
        except Exception as e:
            _LOG.exception("CVE analysis failed")
            res = {"cve_info": cve_info, "error": str(e),
                   "verdict": "NEEDS_REVIEW: analysis error"}
        results.append(res)
        if on_result:
            on_result(res)
    return results
