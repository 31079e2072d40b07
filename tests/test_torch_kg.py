"""Port parity of the knowledge-graph RAG (kg/ and
pipelines/knowledge_graph.py): the entity graph op for op, graphs saved
by either package loading in the other, triple and entity parsing on the
inputs of tests/test_kg.py, parallel extraction, the knowledge_graph
pipeline end to end with persistence, and the evaluation router, all on
the same scripted EchoLLM and HashEmbedder in both packages.
"""

import json

import pytest

from generativeaiexamples_tpu.config.wizard import load_config as jload
from generativeaiexamples_tpu.connectors.fakes import (
    EchoLLM as JEcho, HashEmbedder as JHash)
from generativeaiexamples_tpu.kg import (
    evaluation as jev, extraction as jex, graph as jgr)
from generativeaiexamples_tpu.pipelines.base import (
    get_example_class as jget)
from generativeaiexamples_tpu.pipelines.resources import (
    Resources as JResources)
from generativeaiexamples_tpu.rag.retriever import Retriever as JRetriever
from generativeaiexamples_tpu.rag.vectorstore import (
    MemoryVectorStore as JMemory)
from generativeaiexamples_tpu_torch.config.schema import load_config
from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
from generativeaiexamples_tpu_torch.connectors.fakes import (
    EchoLLM, HashEmbedder)
from generativeaiexamples_tpu_torch.kg import (
    evaluation as tev, extraction as tex, graph as tgr)
from generativeaiexamples_tpu_torch.pipelines.base import (
    get_example_class as tget)
from generativeaiexamples_tpu_torch.pipelines.knowledge_graph import (
    NO_GRAPH_CONTEXT)
from generativeaiexamples_tpu_torch.pipelines.resources import Resources
from generativeaiexamples_tpu_torch.rag.retriever import Retriever
from generativeaiexamples_tpu_torch.rag.vectorstore import MemoryVectorStore

OPS = [
    ("add_triple", ("Apple", "ORG", "Introduce", "iPhone 14", "PRODUCT")),
    ("add_triple", ("Apple", "ORG", "Operate_In", "Tech Sector", "FIELD")),
    ("add_triple", ("iPhone 14", "PRODUCT", "Positive_Impact_On",
                    "Apple Stock", "METRIC")),
    ("add_triple", ("Google", "ORG", "Operate_In", "Tech Sector", "FIELD")),
    ("add_triple", ("  ", "ORG", "Has", "x", "")),  # blank subject: dropped
    ("add_triple", ("apple", "", "Has", "MIT", "INSTITUTION")),
    ("add_triples", [{"subject": "MIT", "relation": "Relate_To",
                      "object": "mit", "object_type": "ORG"},
                     ("Banana", "PRODUCT", "", "Fruit", "CONCEPT"),
                     ("Banana", "PRODUCT", "Is_Member_Of", "Fruit",
                      "CONCEPT")]),
    ("add_triples_triple", ("Fruit", "CONCEPT", "Has", "Vitamin C",
                            "CONCEPT")),
]
QUERIES = ["Apple", "apple", " APPLE ", "Google", "Tech Sector", "MIT",
           "Banana", "Vitamin C", "Nope", ""]


def _run_ops(gr):
    g = gr.EntityGraph()
    for op, arg in OPS:
        if op == "add_triple":
            g.add_triple(*arg)
        elif op == "add_triples":
            g.add_triples(arg)
        else:
            g.add_triples([gr.Triple(*arg)])
    return g


def _view(g):
    return {"len": len(g), "entities": g.entities(),
            "triples": [t.as_text() for t in g.triples],
            "fields": [tuple(vars(t).values()) for t in g.triples],
            "knowledge": {(q, d): g.get_entity_knowledge(q, depth=d)
                          for q in QUERIES for d in (0, 1, 2, 3)}}


def test_entity_graph_matches_jax_op_for_op():
    got, want = _view(_run_ops(tgr)), _view(_run_ops(jgr))
    assert got == want
    assert got["len"] == 8  # the blank subject and relation are dropped
    assert "Apple Introduce iPhone 14" in got["knowledge"][("Apple", 1)]
    assert any("Google" in t for t in got["knowledge"][("apple", 2)])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_json_graph_written_by_either_package_loads_in_the_other(
        tmp_path, writer):
    path = str(tmp_path / "kg.json")
    src, dst = (jgr, tgr) if writer == "jax" else (tgr, jgr)
    _run_ops(src).save(path)
    loaded = dst.EntityGraph.load(path)
    assert _view(loaded) == _view(_run_ops(dst))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["kg.json"]


def test_graphml_round_trip_matches_jax(tmp_path):
    pytest.importorskip("networkx")
    tp, jp = str(tmp_path / "t.graphml"), str(tmp_path / "j.graphml")
    _run_ops(tgr).to_graphml(tp)
    _run_ops(jgr).to_graphml(jp)
    for path in (tp, jp):
        got = tgr.EntityGraph.from_graphml(path)
        want = jgr.EntityGraph.from_graphml(path)
        assert _view(got) == _view(want)
        assert sorted(t.as_text() for t in got.triples) == sorted(
            t.as_text() for t in _run_ops(tgr).triples)


TRIPLE_TEXTS = [
    "```\n[('Apple Inc.', 'ORG', 'Introduce', 'iPhone 14', 'PRODUCT'), "
    "('Apple Inc.', 'ORG', 'Operate_In', 'Technology Sector', 'FIELD')]\n```",
    json.dumps([["CRISPR", "PRODUCT", "Impact", "Genetics", "FIELD"]]),
    "[('A', 'ORG', 'Has', 'B', 'ORG'), ('bad',), ('NAN', 'X', 'Has', 'C', "
    "'Y')]",
    "I could not find any triples.", "", "[]", "[1, 2, 3]",
    "```json\n[[\"a\", \"b\", \"c\", \"d\", \"e\"]]\n```",
    "Here: [('x', 'T', 'Has', 'nan', 'T'), (1, 2, 3, 4, 5)] done",
    "{'not': 'a list'}", "[('a', 'b', 'c', 'd', 'e', 'f')]",
]


@pytest.mark.parametrize("text", TRIPLE_TEXTS)
def test_parse_triples_matches_jax(text):
    got = [vars(t) for t in tex.parse_triples(text)]
    assert got == [vars(t) for t in jex.parse_triples(text)]


def test_prompts_and_contracts_match_jax():
    for name in ("TRIPLE_PROMPT", "ENTITY_QUERY_PROMPT", "ENTITY_CATEGORIES",
                 "RELATION_VERBS"):
        assert getattr(tex, name) == getattr(jex, name)
    for name in ("QA_PROMPT", "ANSWER_SYSTEM", "NO_GRAPH_CONTEXT"):
        assert getattr(tev, name) == getattr(jev, name)
    from generativeaiexamples_tpu.pipelines import knowledge_graph as jkg
    assert NO_GRAPH_CONTEXT == jkg.NO_GRAPH_CONTEXT


@pytest.mark.parametrize("reply", [
    '{"entities": ["Apple", "Google"]}', '{"entities": "Apple"}',
    'no json', '{"entities": ["", " ", 3]}', '{bad}', '{"other": 1}'])
def test_extract_query_entities_matches_jax(reply):
    tllm, jllm = EchoLLM([("entities", reply)]), JEcho([("entities", reply)])
    assert tex.extract_query_entities(tllm, "Apple vs Google?") == \
        jex.extract_query_entities(jllm, "Apple vs Google?")
    assert tllm.calls == jllm.calls


def test_parallel_extraction_matches_jax():
    script = [("Extract knowledge-graph triples",
               "[('TPU', 'PRODUCT', 'Has', 'MXU', 'TOOL')]")]
    chunks = ["chunk one", "chunk two", "chunk three"]
    progress = []
    tllm, jllm = EchoLLM(script), JEcho(script)
    got = tex.process_documents(chunks, tllm, max_workers=2,
                                update_progress=lambda d, n: progress.append(
                                    (d, n)))
    want = jex.process_documents(chunks, jllm, max_workers=2)
    assert [vars(t) for t in got] == [vars(t) for t in want]
    assert len(got) == 3 and progress[-1] == (3, 3)
    key = json.dumps
    assert sorted(map(key, tllm.calls)) == sorted(map(key, jllm.calls))


KG_SCRIPT = [
    ("Extract knowledge-graph triples",
     "[('Pallas', 'TOOL', 'Produce', 'TPU Kernels', 'PRODUCT'), "
     "('TPU Kernels', 'PRODUCT', 'Impact', 'Serving Throughput', "
     "'METRIC')]"),
    ("entities", '{"entities": ["Pallas"]}'),
]
KG_DOC = ("Pallas produces TPU kernels. Those kernels impact serving "
          "throughput substantially.")


def _kg_pair(env, script=KG_SCRIPT):
    jres = JResources(jload(path="", env=env), llm=JEcho(script=script),
                      embedder=JHash(32), reranker=None)
    tcfg = load_config(env=env)
    tres = Resources(tcfg, hub=EngineHub(tcfg, device="cpu"),
                     llm=EchoLLM(script=script), embedder=HashEmbedder(32),
                     reranker=None)
    return jres, tres


@pytest.mark.parametrize("fact_check", [False, True])
def test_knowledge_graph_pipeline_matches_jax_with_persistence(
        tmp_path, fact_check):
    outs = []
    for side, get in (("j", jget), ("t", tget)):
        env = {"APP_VECTORSTORE_PERSISTDIR": str(tmp_path / side)}
        if fact_check:
            env["APP_RETRIEVER_FACTCHECK"] = "true"
        jres, tres = _kg_pair(env)
        res = jres if side == "j" else tres
        ex = get("knowledge_graph")(res)
        doc = tmp_path / f"{side}.txt"
        doc.write_text(KG_DOC)
        ex.ingest_docs(str(doc), "kg.txt")
        answer = list(ex.rag_chain("what does Pallas produce?", []))
        # Nothing in the graph for this query: the disclaimer context.
        res.llm.script = [("entities", '{"entities": ["Nobody"]}')]
        res.store.delete_documents(["kg.txt"])
        empty = list(ex.rag_chain("who is nobody?", []))
        plain = list(ex.llm_chain("hi", [{"role": "user", "content": "x"}]))
        outs.append((res, [answer, empty, plain, ex.get_documents(),
                           ex.document_search("Pallas", 2)]))
    (jres, jout), (tres, tout) = outs
    assert tout == jout and tres.llm.calls == jres.llm.calls
    final_prompt = [c for c in tres.llm.calls
                    if c[-1]["content"].startswith("Context:")]
    assert "Pallas Produce TPU Kernels" in final_prompt[0][-1]["content"]
    assert "TPU Kernels Impact Serving Throughput" in \
        final_prompt[0][-1]["content"]
    assert NO_GRAPH_CONTEXT in final_prompt[1][-1]["content"]
    assert "Here are the relevant passages" in "".join(tout[0])
    assert len(tres.kg_graph) == len(jres.kg_graph) == 2
    # Each package's persisted graph loads in the other, and a fresh
    # Resources over the same persist_dir reloads it.
    for side, gr in (("j", tgr), ("t", jgr)):
        path = str(tmp_path / side / "knowledge_graph.json")
        assert len(gr.EntityGraph.load(path)) == 2
    env = {"APP_VECTORSTORE_PERSISTDIR": str(tmp_path / "j")}
    _, fresh = _kg_pair(env, script=[])
    assert tget("knowledge_graph")(fresh).graph.get_entity_knowledge(
        "Pallas") == ["Pallas Produce TPU Kernels",
                      "TPU Kernels Impact Serving Throughput"]


def test_concurrent_first_use_builds_one_graph():
    """The graph is built once under Resources' lock, whichever pipeline
    instance gets there first."""
    import threading

    _, tres = _kg_pair({})
    graphs, bar = [], threading.Barrier(8)

    def first_use():
        bar.wait()
        graphs.append(tget("knowledge_graph")(tres).graph)

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(graphs) == 8 and all(g is graphs[0] for g in graphs)


def _eval_side(store_cls, emb_cls, ret_cls, llm_cls, ev, gr):
    emb = emb_cls(32)
    store = store_cls(32)
    texts = ["The MXU is the systolic matmul unit of a TPU.",
             "HBM feeds the cores."]
    store.add(texts, emb.embed_documents(texts), [{}, {}])
    retriever = ret_cls(store, emb, top_k=2, score_threshold=0.0)
    graph = gr.EntityGraph()
    graph.add_triple("MXU", "TOOL", "Has", "Systolic Array", "CONCEPT")
    llm = llm_cls(script=[("entities", '{"entities": ["MXU"]}'),
                          ("write one complex question",
                           '{"question": "Q?", "answer": "A."}')])
    comp = ev.RagModeComparison(llm, retriever, graph)
    pairs = ev.generate_qa_pairs(["some chunk", "another"], llm)
    scores = iter([3.5, 1.0, RuntimeError("judge down"), 2.0, 2.0, 4.0,
                   1.0, 1.0, 1.0])

    def scorer(q, gt, a):
        s = next(scores)
        if isinstance(s, Exception):
            raise s
        return s

    rows = list(ev.run_evaluation(
        pairs + [{"question": "what is the MXU?", "answer": "matmul"}],
        comp, scorer=scorer))
    unscored = list(ev.run_evaluation(pairs[:1], comp))
    return rows, unscored, pairs


def test_evaluation_router_matches_jax():
    got = _eval_side(MemoryVectorStore, HashEmbedder, Retriever, EchoLLM,
                     tev, tgr)
    want = _eval_side(JMemory, JHash, JRetriever, JEcho, jev, jgr)
    assert got == want
    rows, unscored, pairs = got
    assert pairs == [{"question": "Q?", "answer": "A."}] * 2
    assert rows[-1]["summary"]["combined"] == 2.5
    assert rows[0]["combined_score"] is None  # the scorer raised
    assert "knowledge graph: MXU Has" in rows[-2]["combined_answer"]
    assert len(unscored) == 1 and "summary" not in unscored[-1]
