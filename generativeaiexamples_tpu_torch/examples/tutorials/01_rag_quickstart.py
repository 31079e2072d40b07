# %% [markdown]
# # 01 — RAG quickstart
#
# The reference ships this walkthrough as notebooks 01-03; here it is
# in jupytext percent format: run it top to bottom as a script
# (`python generativeaiexamples_tpu_torch/examples/tutorials/01_rag_quickstart.py`,
# add `--device cpu` without a GPU) or open it as a notebook.
# Everything below is hermetic — fake LLM + hash embedder, no weights,
# no network — swap the two env vars at the end for real endpoints.

# %%
import argparse
import os
import sys

# __file__ is undefined inside a Jupyter kernel; fall back to cwd.
_here = (os.path.dirname(os.path.abspath(__file__))
         if "__file__" in globals() else os.getcwd())
sys.path.insert(0, os.path.abspath(os.path.join(_here, "..", "..", "..")))
os.environ.setdefault("APP_LLM_MODELENGINE", "echo")
os.environ.setdefault("APP_EMBEDDINGS_MODELENGINE", "hash")

from generativeaiexamples_tpu_torch.config.wizard import load_config
from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
from generativeaiexamples_tpu_torch.device import resolve_device
from generativeaiexamples_tpu_torch.pipelines.base import (
    get_example_class, list_examples)
from generativeaiexamples_tpu_torch.pipelines.resources import Resources

# The card unless `--device cpu`; without CUDA that raises (no fallback).
# parse_known_args lets a notebook kernel's own argv pass through.
_ap = argparse.ArgumentParser()
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
DEVICE = resolve_device(_ap.parse_known_args()[0].device)

# %% [markdown]
# ## The pipeline registry
# Seven pluggable examples mirror the reference's chain-server examples
# (the reference discovers one by directory COPY; here they register by
# name and `EXAMPLE_NAME` picks one).

# %%
print("registered examples:", list_examples())

# %% [markdown]
# ## Build resources and ingest
# `Resources` is the factory layer: LLM + embedder + vector store +
# splitter + retriever from one config tree (YAML file + `APP_*` env),
# over an `EngineHub` that owns the in-process engines on `DEVICE`.

# %%
cfg = load_config(None)
res = Resources(cfg, hub=EngineHub(cfg, device=DEVICE))
rag = get_example_class("developer_rag")(res)

import tempfile

doc = os.path.join(tempfile.mkdtemp(), "facts.txt")
with open(doc, "w") as fh:
    fh.write("The H100 SXM has eighty gigabytes of HBM3 per card. "
             "Cards inside a node communicate over NVLink.")
rag.ingest_docs(doc, "facts.txt")
print("documents:", rag.get_documents())

# %% [markdown]
# ## Search and answer

# %%
hits = rag.document_search("how much memory does a card have?", 2)
print("top hit:", hits[0]["content"][:80], "| score", round(hits[0]["score"], 3))

answer = "".join(rag.rag_chain("how much memory does a card have?", [],
                               max_tokens=128))
print("answer:", answer[:200])

# %% [markdown]
# ## Going real
# Point the connectors at the port's engine server
# (`python -m generativeaiexamples_tpu_torch.serving`) or any OpenAI-
# compatible endpoint — no code changes:
#
# ```bash
# APP_LLM_MODELENGINE=openai APP_LLM_SERVERURL=http://localhost:8000/v1 \
# APP_EMBEDDINGS_MODELENGINE=openai \
# APP_EMBEDDINGS_SERVERURL=http://localhost:8000/v1 \
#   python generativeaiexamples_tpu_torch/examples/tutorials/01_rag_quickstart.py
# ```
