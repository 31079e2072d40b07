"""Port parity: query augmentation and the fact check (rag/augmentation.py,
Retriever.retrieve_multi, pipelines/base.py's helpers).

Every augmentation function runs over a scripted EchoLLM in both
packages and must send the same messages and return the same values;
reciprocal-rank fusion and `retrieve_multi` give the same ids. Then
developer_rag's `rag_chain` in both packages on the same fakes (EchoLLM,
HashEmbedder, the host store) for each augmentation mode, with and
without the fact check: the same pieces in the same order, the same LLM
calls.
"""

import dataclasses

import numpy as np
import pytest

from generativeaiexamples_tpu.config.schema import AppConfig as JAppConfig
from generativeaiexamples_tpu.connectors.fakes import (
    EchoLLM as JEcho, HashEmbedder as JHash)
from generativeaiexamples_tpu.pipelines.developer_rag import (
    QAChatbot as JQAChatbot)
from generativeaiexamples_tpu.pipelines.resources import (
    Resources as JResources)
from generativeaiexamples_tpu.rag import augmentation as jaug
from generativeaiexamples_tpu.rag import retriever as jret
from generativeaiexamples_tpu.rag.vectorstore import (
    MemoryVectorStore as JMemory, SearchResult as JHit)
from generativeaiexamples_tpu_torch.config.schema import load_config
from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
from generativeaiexamples_tpu_torch.connectors.fakes import (
    EchoLLM, HashEmbedder)
from generativeaiexamples_tpu_torch.pipelines.developer_rag import QAChatbot
from generativeaiexamples_tpu_torch.pipelines.resources import Resources
from generativeaiexamples_tpu_torch.rag import augmentation as taug
from generativeaiexamples_tpu_torch.rag import retriever as tret
from generativeaiexamples_tpu_torch.rag.vectorstore import (
    MemoryVectorStore, SearchResult)

SCRIPT = [
    ("additional self-contained questions",
     "What feeds the matrix units?\n\n  How wide is the array?  \n"
     "Which memory is fastest?\nWhat is a tile?\nWho built it?\nExtra?"),
    ("hypothetical answer", "The systolic array multiplies matrices."),
    ("Rewrite the user's latest", "What does the systolic array do?"),
    ("Fact-check", "TRUE: every claim is in the context."),
]
HISTORY = [{"role": "user", "content": "Tell me about the array."},
           {"role": "assistant", "content": "It multiplies."}]
DOCS = ["The systolic array multiplies matrices in tiles.",
        "HBM feeds the matrix units at high bandwidth.",
        "Bananas are yellow and sweet.",
        "The vector unit handles elementwise work.",
        "Tiles of 128 by 128 fill the array."]


def _both(fn):
    """fn(aug module, EchoLLM) for JAX then the port: (result, calls)."""
    out = []
    for aug, echo in ((jaug, JEcho), (taug, EchoLLM)):
        llm = echo(SCRIPT)
        out.append((fn(aug, llm), llm.calls))
    return out


@pytest.mark.parametrize("name, call", [
    ("fact_check", lambda aug, llm: list(aug.fact_check(
        llm, "ctx", "q?", "resp", max_tokens=9))),
    ("fact_check_verdict", lambda aug, llm: aug.fact_check_verdict(
        llm, "ctx", "q?", "resp")),
    ("multi_query", lambda aug, llm: aug.augment_multiple_query(llm, "q?")),
    ("multi_query_n2", lambda aug, llm: aug.augment_multiple_query(
        llm, "q?", n=2)),
    ("hyde", lambda aug, llm: aug.augment_query_generated(llm, "q?")),
    ("rewrite", lambda aug, llm: aug.query_rewriting(llm, "it?", HISTORY)),
    ("rewrite_no_history", lambda aug, llm: aug.query_rewriting(
        llm, "it?", [])),
])
def test_augmentation_functions_match_jax(name, call):
    (want, wcalls), (got, gcalls) = _both(call)
    assert got == want
    assert gcalls == wcalls
    if name == "fact_check_verdict":
        assert got is True
    if name == "rewrite_no_history":
        assert gcalls == []  # nothing to resolve: no LLM call
    if name == "multi_query":
        assert len(got) == 5


def test_prompts_match_jax():
    for key in ("FACT_CHECK_SYSTEM", "MULTI_QUERY_SYSTEM", "HYDE_SYSTEM",
                "REWRITE_SYSTEM"):
        assert getattr(taug, key) == getattr(jaug, key)


def _lists(cls):
    return [[cls("a", 0.9), cls("b", 0.8), cls("c", 0.1)],
            [cls("b", 0.7), cls("d", 0.6)], [], [cls("d", 0.5),
                                                 cls("a", 0.4)]]


@pytest.mark.parametrize("top_k, rrf_k", [(4, 60), (2, 1), (10, 60)])
def test_fuse_ranked_and_retrieve_fused_match_jax(top_k, rrf_k):
    got = taug.fuse_ranked(_lists(SearchResult), top_k=top_k, rrf_k=rrf_k)
    want = jaug.fuse_ranked(_lists(JHit), top_k=top_k, rrf_k=rrf_k)
    assert [(h.text, h.score) for h in got] == [(h.text, h.score)
                                                for h in want]
    assert taug.fuse_ranked([[], []]) == []
    lists = dict(zip("wxyz", _lists(SearchResult)))
    jlists = dict(zip("wxyz", _lists(JHit)))
    got = taug.retrieve_fused(lists.get, "wxyz", top_k=top_k, rrf_k=rrf_k)
    want = jaug.retrieve_fused(jlists.get, "wxyz", top_k=top_k, rrf_k=rrf_k)
    assert [h.text for h in got] == [h.text for h in want]


@pytest.mark.parametrize("hybrid", [False, True])
def test_retrieve_multi_matches_jax(hybrid):
    from generativeaiexamples_tpu.connectors.fakes import (
        OverlapReranker as JOverlap)
    from generativeaiexamples_tpu_torch.connectors.fakes import (
        OverlapReranker)

    emb, jemb = HashEmbedder(64), JHash(64)
    tstore, jstore = MemoryVectorStore(64), JMemory(64)
    tstore.add(DOCS, emb.embed_documents(DOCS))
    jstore.add(DOCS, jemb.embed_documents(DOCS))
    t = tret.Retriever(tstore, emb, top_k=3, score_threshold=0.2,
                       reranker=OverlapReranker() if hybrid else None,
                       default_hybrid=hybrid)
    j = jret.Retriever(jstore, jemb, top_k=3, score_threshold=0.2,
                       reranker=JOverlap() if hybrid else None,
                       default_hybrid=hybrid)
    for variants in (["systolic array"], ["systolic array", "matrix HBM",
                                          "yellow"], []):
        got, want = t.retrieve_multi(variants), j.retrieve_multi(variants)
        assert [h.text for h in got] == [h.text for h in want]
        np.testing.assert_allclose([h.score for h in got],
                                   [h.score for h in want], atol=1e-6)


# -- developer_rag with augmentation and the fact check -------------------


def _chains(modes, fact_check):
    knobs = {"query_augmentation": modes, "fact_check": fact_check,
             "top_k": 3}
    jcfg = JAppConfig()
    jcfg = dataclasses.replace(jcfg, retriever=dataclasses.replace(
        jcfg.retriever, **knobs))
    jllm = JEcho(SCRIPT)
    jres = JResources(jcfg, llm=jllm, embedder=JHash(64), reranker=None)
    tcfg = load_config(env={}, overrides={"retriever": knobs})
    tllm = EchoLLM(SCRIPT)
    tres = Resources(tcfg, hub=EngineHub(tcfg, device="cpu"), llm=tllm,
                     embedder=HashEmbedder(64), reranker=None)
    for res in (jres, tres):
        res.store.add(DOCS, res.embedder.embed_documents(DOCS),
                      [{"filename": "d.txt"}] * len(DOCS))
    return (JQAChatbot(jres), jllm), (QAChatbot(tres), tllm)


@pytest.mark.parametrize("modes", [
    "", "rewrite", "hyde", "multi_query", "rewrite,hyde,multi_query",
    " hyde , bogus ,"])
@pytest.mark.parametrize("fact_check", [False, True])
def test_rag_chain_frames_match_jax(modes, fact_check, caplog):
    (jchain, jllm), (tchain, tllm) = _chains(modes, fact_check)
    want = list(jchain.rag_chain("What does it do?", HISTORY, max_tokens=64))
    got = list(tchain.rag_chain("What does it do?", HISTORY, max_tokens=64))
    assert got == want
    assert tllm.calls == jllm.calls
    n_aug = sum(m in modes for m in ("rewrite", "hyde", "multi_query"))
    assert len(tllm.calls) == n_aug + 1 + fact_check
    if fact_check:
        assert "\n\n[fact-check] " in got
        assert "".join(got).endswith("TRUE: every claim is in the context.")
    else:
        assert "[fact-check]" not in "".join(got)
    if "bogus" in modes:
        assert "unknown query_augmentation modes ignored" in caplog.text


def test_augmented_variants_ride_one_embed_and_one_search():
    """Every variant goes through ONE embed_queries call and ONE
    search_batch dispatch (retrieve_multi), not one per variant."""
    (_, _), (tchain, _) = _chains("rewrite,hyde,multi_query", False)
    res = tchain.res
    calls = {"embed_queries": [], "search_batch": 0, "search": 0}
    real_eq, real_sb, real_s = (res.embedder.embed_queries,
                                res.store.search_batch, res.store.search)

    def eq(texts):
        calls["embed_queries"].append(len(texts))
        return real_eq(texts)

    def sb(*a, **k):
        calls["search_batch"] += 1
        return real_sb(*a, **k)

    def s(*a, **k):
        calls["search"] += 1
        return real_s(*a, **k)

    res.embedder.embed_queries, res.store.search_batch = eq, sb
    res.store.search = s
    # Every variant finds a hit above the threshold, so no list is
    # retried without it (a retry is a second dispatch, as in JAX).
    res.retriever.score_threshold = 0.0
    q, hits = tchain.retrieve_with_augmentation("What does it do?", HISTORY)
    assert q == "What does the systolic array do?"
    assert calls == {"embed_queries": [7], "search_batch": 1, "search": 0}
    assert 1 <= len(hits) <= 3
