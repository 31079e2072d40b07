# %% [markdown]
# # 05 — Knowledge-graph RAG
#
# The reference's `experimental/knowledge_graph_rag` builds a graph of
# (subject, relation, object) triples with an LLM, then answers
# questions from graph context, vector context, or both. This tutorial
# walks the same flow with the port's `kg/` package — hermetic
# (scripted LLM, hash embedder), so it runs in CI; swap the env vars for
# real endpoints.

# %%
import argparse
import json
import os
import sys
import tempfile

# __file__ is undefined inside a Jupyter kernel; fall back to cwd.
_here = (os.path.dirname(os.path.abspath(__file__))
         if "__file__" in globals() else os.getcwd())
sys.path.insert(0, os.path.abspath(os.path.join(_here, "..", "..", "..")))

from generativeaiexamples_tpu_torch.device import resolve_device

# The card unless `--device cpu`; without CUDA that raises (no fallback).
# parse_known_args lets a notebook kernel's own argv pass through.
_ap = argparse.ArgumentParser()
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
DEVICE = resolve_device(_ap.parse_known_args()[0].device)

# %% [markdown]
# ## 1. Triple extraction
# An LLM turns prose into typed triples. The extractor asks for a JSON
# list and is robust to chatter around it (`kg/extraction.py`). Here a
# scripted fake plays the LLM so the tutorial is deterministic.

# %%
from generativeaiexamples_tpu_torch.connectors.fakes import EchoLLM
from generativeaiexamples_tpu_torch.kg.extraction import extract_triples

CORPUS = {
    "mesh.txt": "A TPU slice exposes its chips as a device mesh. "
                "The mesh axes map tensor parallelism onto ICI links.",
    "engine.txt": "The serving engine schedules decode blocks. "
                  "The engine writes KV pages into the page pool.",
}

# The extractor's wire format is a list of 5-element rows:
# [subject, subject_type, relation, object, object_type]
llm = EchoLLM(script=[
    ("device mesh", json.dumps([
        ["TPU slice", "hardware", "exposes", "device mesh", "abstraction"],
        ["mesh axes", "abstraction", "map", "tensor parallelism",
         "technique"],
    ])),
    ("serving engine", json.dumps([
        ["serving engine", "software", "schedules", "decode blocks",
         "workload"],
        ["serving engine", "software", "writes", "KV pages", "data"],
    ])),
])

triples = []
for name, text in CORPUS.items():
    triples.extend(extract_triples(llm, text))
print(f"extracted {len(triples)} triples")
assert len(triples) == 4

# %% [markdown]
# ## 2. The entity graph
# Triples land in an `EntityGraph` (NetworkX multigraph under the
# hood, GraphML interchange like the reference's Gephi export).
# `get_entity_knowledge` walks neighbours to `depth` hops — that walk
# is the "graph retrieval" primitive.

# %%
from generativeaiexamples_tpu_torch.kg.graph import EntityGraph

graph = EntityGraph()
graph.add_triples(triples)
print(f"graph: {len(graph)} edges, {len(graph.entities())} entities")
knowledge = graph.get_entity_knowledge("serving engine", depth=2)
print("2-hop knowledge of 'serving engine':")
for fact in knowledge:
    print("  ", fact)
assert any("KV pages" in f for f in knowledge)

with tempfile.TemporaryDirectory() as td:
    path = os.path.join(td, "kg.graphml")
    graph.to_graphml(path)                     # Gephi-compatible export
    assert len(EntityGraph.from_graphml(path)) == len(graph)

# %% [markdown]
# ## 3. The knowledge_graph pipeline
# `pipelines/knowledge_graph.py` packages the flow behind the standard
# `BaseExample` interface: `ingest_docs` extracts triples AND indexes
# chunks; `rag_chain` answers from graph + vector context combined.

# %%
from generativeaiexamples_tpu_torch.config.wizard import load_config
from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
from generativeaiexamples_tpu_torch.connectors.fakes import HashEmbedder
from generativeaiexamples_tpu_torch.pipelines.base import get_example_class
from generativeaiexamples_tpu_torch.pipelines.resources import Resources

kg_llm = EchoLLM(script=[
    # ingest-time extraction
    ("engine", json.dumps([
        ["serving engine", "software", "schedules", "decode blocks",
         "workload"]])),
    # query-time entity linking
    ("entities", json.dumps(["serving engine"])),
])
cfg = load_config(path="", env={})
res = Resources(cfg, hub=EngineHub(cfg, device=DEVICE), llm=kg_llm,
                embedder=HashEmbedder(64), reranker=None)
kg = get_example_class("knowledge_graph")(res)

with tempfile.TemporaryDirectory() as td:
    for name, text in CORPUS.items():
        p = os.path.join(td, name)
        with open(p, "w") as fh:
            fh.write(text)
        kg.ingest_docs(p, name)

print("indexed docs:", kg.get_documents())
answer = "".join(kg.rag_chain("What does the serving engine schedule?", []))
print("combined-RAG answer:", answer[:200])
assert answer

# %% [markdown]
# ## 4. Graph vs text vs combined (the eval router)
# The reference's evaluation router scores the three retrieval modes
# against each other (`backend/routers/evaluation.py`); `kg/evaluation`
# is that comparison as a library.

# %%
from generativeaiexamples_tpu_torch.kg.evaluation import RagModeComparison

cmp_llm = EchoLLM(script=[("entities", json.dumps(["serving engine"]))])
cmp = RagModeComparison(cmp_llm, res.retriever, kg.graph, top_k=2)
row = cmp.process_question("What does the serving engine schedule?",
                           "decode blocks")
print({k: str(v)[:80] for k, v in row.items()})
assert "combined_answer" in row

# %% [markdown]
# That is the full KG-RAG surface: extraction -> graph -> combined
# answering -> mode comparison. For real corpora, point the LLM
# connector at a capable endpoint (`APP_LLM_MODELENGINE=tpu`, the
# port's in-process engine on the card, with weights, or any
# OpenAI-compatible URL).
