"""Port parity: agents/cve.py.

Both packages' agents run over the same scripted LLM (each package's
EchoLLM with one script), the same SBOM and retrievers over the same
texts (hash embedder, memory store): checklists, tool transcripts,
findings, verdicts and the calls the LLM saw must be equal.
"""

import json

import pytest

from generativeaiexamples_tpu.agents import cve as jcve
from generativeaiexamples_tpu.connectors.fakes import (
    EchoLLM as JEcho, HashEmbedder as JHash)
from generativeaiexamples_tpu.rag.retriever import Retriever as JRetriever
from generativeaiexamples_tpu.rag.vectorstore import (
    MemoryVectorStore as JStore)
from generativeaiexamples_tpu_torch.agents import cve as tcve
from generativeaiexamples_tpu_torch.connectors.fakes import (
    EchoLLM, HashEmbedder)
from generativeaiexamples_tpu_torch.rag.retriever import Retriever
from generativeaiexamples_tpu_torch.rag.vectorstore import MemoryVectorStore

CVE = ("A use-after-free in the linux kernel dvb-core subsystem allows "
       "local attackers to escalate privileges.")
CODE = ["int dvb_register_device(struct dvb_adapter *adap)",
        "static void unrelated_function(void)",
        "void dvb_unregister_device(struct dvb_device *dvbdev)"]
DOCS = ["The media stack is disabled in our kernel build.",
        "We ship kernel 6.0.9 with the dvb modules compiled out."]

SCRIPT = [
    ("security analyst",
     "1. Check the SBOM for dvb-core\n- Search code for dvbdev usage\n"
     "* Read the docs for the kernel build\n\n2) Look for mitigations"),
    ("Checklist item: Check the SBOM for dvb-core\nTool results so "
     "far:\n(no tool results yet)",
     json.dumps({"action": "check_sbom", "input": "dvb-core"})),
    ("check_sbom(dvb-core)",
     json.dumps({"action": "finish", "finding": "component present"})),
    ("Checklist item: Search code for dvbdev usage\nTool results so "
     "far:\n(no tool results yet)",
     json.dumps({"action": "search_code", "input": "dvb_register_device"})),
    ("search_code(dvb_register_device)",
     json.dumps({"action": "search_docs", "input": "kernel build"})),
    ("search_docs(kernel build)",
     json.dumps({"action": "finish", "finding": "call present, modules "
                                                "compiled out"})),
    ("Checklist item: Read the docs",
     json.dumps({"action": "rm_rf", "input": "/"})),
    ("Checklist item: Look for mitigations", "no json here {broken"),
    ("Findings:", "NEEDS_REVIEW - mixed evidence"),
]


def _agent(pkg, script=SCRIPT, **kw):
    echo, hash_, store, retr, mod = {
        "jax": (JEcho, JHash, JStore, JRetriever, jcve),
        "port": (EchoLLM, HashEmbedder, MemoryVectorStore, Retriever, tcve),
    }[pkg]

    def retriever(texts):
        emb = hash_(32)
        st = store(32)
        st.add(texts, emb.embed_documents(texts), [{}] * len(texts))
        return retr(st, emb, top_k=3, score_threshold=0.0)

    llm = echo(script=list(script))
    agent = mod.CVEAgent(llm, code_retriever=retriever(CODE),
                         docs_retriever=retriever(DOCS),
                         sbom=mod.SBOM({"dvb-core": "1.0",
                                        "linux-kernel": "6.0.9"}), **kw)
    return llm, agent


@pytest.mark.parametrize("workers", [1, 4])
def test_pipeline_outputs_equal_jax(workers):
    out = {}
    for pkg in ("jax", "port"):
        llm, agent = _agent(pkg, max_workers=workers)
        seen = []
        mod = jcve if pkg == "jax" else tcve
        results = mod.run_cve_pipeline([CVE, "a second advisory"], agent,
                                       on_result=seen.append)
        assert seen == results
        out[pkg] = (results, sorted(json.dumps(c) for c in llm.calls))
    assert out["port"] == out["jax"]
    r = out["port"][0][0]
    assert r["checklist"] == ["Check the SBOM for dvb-core",
                              "Search code for dvbdev usage",
                              "Read the docs for the kernel build",
                              "Look for mitigations"]
    assert r["verdict"].startswith("NEEDS_REVIEW")
    assert "unknown tool 'rm_rf'" in r["findings"][2]["steps"][0]
    assert r["findings"][3]["finding"] == "no json here {broken"


def test_tools_and_bounds_equal_jax():
    for item in ("anything at all", "Look for mitigations"):
        got = _agent("port")[1].investigate(CVE, item)
        want = _agent("jax")[1].investigate(CVE, item)
        assert got == want
    loop = [("Checklist item", json.dumps({"action": "check_sbom",
                                           "input": "kernel"}))]
    got = _agent("port", loop)[1].investigate(CVE, "loops")
    want = _agent("jax", loop)[1].investigate(CVE, "loops")
    assert got == want
    assert len(got["steps"]) == tcve.CVEAgent.MAX_STEPS == \
        jcve.CVEAgent.MAX_STEPS
    bare_t = tcve.CVEAgent(EchoLLM())
    bare_j = jcve.CVEAgent(JEcho())
    for action in ("search_code", "search_docs", "check_sbom", "nope"):
        assert bare_t._tool(action, "x") == bare_j._tool(action, "x")
    empty = [("security analyst", "   \n")]
    assert tcve.run_cve_pipeline(["c"], _agent("port", empty)[1]) == \
        jcve.run_cve_pipeline(["c"], _agent("jax", empty)[1])


def test_analysis_error_becomes_needs_review():
    class Boom:
        def chat(self, *a, **k):
            raise RuntimeError("llm down")

    got = tcve.run_cve_pipeline(["c"], tcve.CVEAgent(Boom()))
    want = jcve.run_cve_pipeline(["c"], jcve.CVEAgent(Boom()))
    assert got == want == [{"cve_info": "c", "error": "llm down",
                            "verdict": "NEEDS_REVIEW: analysis error"}]


def test_checklist_and_sbom_equal_jax(tmp_path):
    text = ("1. Check the SBOM\n- Search code\n* Verify\n\n2) Review\n"
            "  • bullet\n10. tenth")
    assert tcve.parse_checklist(text) == jcve.parse_checklist(text)
    assert tcve.parse_checklist(None) == jcve.parse_checklist(None) == []
    f = tmp_path / "sbom.csv"
    f.write_text("name,version\nOpenSSL,3.0.1\nlinux-kernel,6.0.9\n,x\n"
                 "solo\n")
    t, j = tcve.SBOM.from_csv(str(f)), jcve.SBOM.from_csv(str(f))
    assert t.packages == j.packages
    for q in ("openssl", " OPENSSL ", "kernel", "left-pad", ""):
        assert t.lookup(q) == j.lookup(q)
    for name in ("CHECKLIST_PROMPT", "AGENT_PROMPT", "VERDICT_PROMPT"):
        assert getattr(tcve, name) == getattr(jcve, name)
