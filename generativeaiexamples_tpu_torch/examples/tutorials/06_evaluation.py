# %% [markdown]
# # 06 — Evaluating a RAG pipeline
#
# The reference treats evaluation as its test suite (SURVEY.md §4):
# synthesize QA pairs from the corpus, answer them through the
# pipeline, score with RAGAS-style metrics plus an LLM judge
# (`tools/evaluation/` notebooks 01-04). This tutorial walks the same
# four stages with the port's `eval/` — hermetic (scripted LLM),
# CI-runnable. The one-command version is:
#
#     python -m generativeaiexamples_tpu_torch.eval --docs README.md --offline
#
# and `--server URL` runs it against a real chain server
# (`python -m generativeaiexamples_tpu_torch.api`).

# %%
import argparse
import json
import os
import sys

# __file__ is undefined inside a Jupyter kernel; fall back to cwd.
_here = (os.path.dirname(os.path.abspath(__file__))
         if "__file__" in globals() else os.getcwd())
ROOT = os.path.abspath(os.path.join(_here, "..", "..", ".."))
sys.path.insert(0, ROOT)

from generativeaiexamples_tpu_torch.device import resolve_device

# The card unless `--device cpu`; without CUDA that raises (no fallback).
# parse_known_args lets a notebook kernel's own argv pass through.
_ap = argparse.ArgumentParser()
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
DEVICE = resolve_device(_ap.parse_known_args()[0].device)

# %% [markdown]
# ## Stage 1 — synthetic QA generation
# An LLM reads each corpus chunk and writes a question/answer pair
# (the reference's `synthetic_data_generator/data_generator.py`).

# %%
from generativeaiexamples_tpu_torch.config.wizard import load_config
from generativeaiexamples_tpu_torch.connectors.fakes import EchoLLM, HashEmbedder
from generativeaiexamples_tpu_torch.eval import harness
from generativeaiexamples_tpu_torch.rag.documents import load_document
from generativeaiexamples_tpu_torch.rag.splitter import get_text_splitter

cfg = load_config(path="", env={})
splitter = get_text_splitter(cfg)
chunks = []
readme = os.path.join(ROOT, "README.md")
for d in load_document(readme, "README.md"):
    chunks.extend(splitter.split(d.text))
print(f"corpus: {len(chunks)} chunks")

qa_llm = EchoLLM(script=[(
    "question-answer pair",
    json.dumps({"question": "What serves the LLM in this framework?",
                "answer": "An in-process TPU serving engine."}))])
qa_rows = harness.generate_synthetic_qa(qa_llm, chunks, n_pairs=4)
print(f"stage 1: {len(qa_rows)} QA pairs; first:",
      qa_rows[0]["question"])
assert qa_rows and "ground_truth_answer" in qa_rows[0]

# %% [markdown]
# ## Stage 2 — answer generation through the pipeline
# Online mode posts each question to a chain server
# (`harness.ChainServerClient` + `generate_answers`); here we run the
# pipeline in-process, which is what `--offline` does.

# %%
from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
from generativeaiexamples_tpu_torch.pipelines.base import get_example_class
from generativeaiexamples_tpu_torch.pipelines.resources import Resources

answer_llm = EchoLLM(prefix="The engine answers: ")
res = Resources(cfg, hub=EngineHub(cfg, device=DEVICE), llm=answer_llm,
                embedder=HashEmbedder(64), reranker=None)
rag = get_example_class("developer_rag")(res)
rag.ingest_docs(readme, "README.md")

rows = []
for qa in qa_rows:
    ctx = [h["content"] for h in rag.document_search(qa["question"], 4)]
    answer = "".join(rag.rag_chain(qa["question"], [], max_tokens=128))
    rows.append({**qa, "generated_answer": answer,
                 "retrieved_context": ctx})
print("stage 2 row keys:", sorted(rows[0]))
assert all(r["generated_answer"] for r in rows)

# %% [markdown]
# ## Stage 3 — RAGAS-style metrics
# Six metrics (faithfulness, answer/context relevancy, context
# precision/recall, answer similarity) plus the harmonic-mean
# `ragas_score` over the core four — the reference's
# `evaluator.py:92-158` contract. Metric probes are yes/no LLM calls;
# the scripted judge answers yes.

# %%
from generativeaiexamples_tpu_torch.eval.metrics import RagasEvaluator

metric_llm = EchoLLM(script=[("Answer yes or no", "yes")])
ragas = RagasEvaluator(metric_llm, HashEmbedder(64)).evaluate(rows)
print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                  for k, v in ragas.items()}, indent=1))
assert ragas["ragas_score"] is not None

# %% [markdown]
# ## Stage 4 — LLM judge (Likert 1-5, few-shot)
# The judge grades each generated answer against the ground truth with
# a rating + explanation (`evaluator.py:160-232` parity).

# %%
from generativeaiexamples_tpu_torch.eval.metrics import eval_llm_judge

judge_llm = EchoLLM(script=[
    ("You are grading answers",
     '{"rating": 4, "explanation": "grounded in the retrieved context"}')])
judge = eval_llm_judge(judge_llm, rows)
print("judge mean:", judge["mean_rating"], "n:", len(judge["details"]))
assert judge["mean_rating"] == 4.0

# %% [markdown]
# ## The combined report
# `harness.run_eval` packages stages 3+4; `save_report` writes the same
# JSON shape the reference checks in under
# `tools/evaluation/results/qna.json`.

# %%
report = harness.run_eval(metric_llm, HashEmbedder(64), rows,
                          judge_llm=judge_llm)
print("ragas_score:", report["ragas"]["ragas_score"],
      "| judge:", report["llm_judge"]["mean_rating"])
assert report["n"] == len(rows)
