"""Retriever: embed -> search -> (hybrid rerank) -> token budget.

The port's copy of generativeaiexamples_tpu/rag/retriever.py:
- top_k + score_threshold retrieval, retried without the threshold when
  nothing passes it;
- a whole-chunk token budget for the context (`limit_tokens`);
- `ranked_hybrid`: dense + BM25 candidate union, cross-encoder rerank,
  stdev outlier dropping;
- `retrieve_multi`: query-augmentation variants in one batched dense
  dispatch, fused by reciprocal rank.

`retrieve` and `retrieve_batch` run inside `retriever.retrieve` /
`retriever.retrieve_batch` spans (obs/tracing.py; as in the JAX
retriever, `retrieve_hybrid` opens none of its own). Under
`serving.microbatch_enabled` the device-bound stages this class drives
(embed_query, reranker.score, store.search) each coalesce across
concurrent request threads; `microbatch_stats()` gathers their counters
for the chain server's /metrics.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.obs import tracing
from generativeaiexamples_tpu_torch.rag.augmentation import fuse_ranked
from generativeaiexamples_tpu_torch.rag.splitter import ApproxTokenizer
from generativeaiexamples_tpu_torch.rag.vectorstore import SearchResult
from generativeaiexamples_tpu_torch.serving.batcher import microbatch_stats_of


class BM25Lexical:
    """Small BM25 over the store's documents for the hybrid candidate
    set."""

    _tok = re.compile(r"\w+")

    def __init__(self, k1: float = 1.5, b: float = 0.75):
        self.k1, self.b = k1, b
        self._docs: List[List[str]] = []
        self._df: Counter = Counter()
        self._avg = 0.0

    def fit(self, texts: Sequence[str]) -> None:
        self._docs = [self._tok.findall(t.lower()) for t in texts]
        self._df = Counter()
        for d in self._docs:
            self._df.update(set(d))
        self._avg = (sum(len(d) for d in self._docs) / len(self._docs)
                     if self._docs else 0.0)

    def scores(self, query: str) -> np.ndarray:
        q = self._tok.findall(query.lower())
        N = len(self._docs)
        out = np.zeros((N,), np.float32)
        for i, d in enumerate(self._docs):
            tf = Counter(d)
            s = 0.0
            for w in q:
                if w not in tf:
                    continue
                idf = math.log(1 + (N - self._df[w] + 0.5) / (self._df[w] + 0.5))
                denom = tf[w] + self.k1 * (
                    1 - self.b + self.b * len(d) / max(self._avg, 1e-9))
                s += idf * tf[w] * (self.k1 + 1) / denom
            out[i] = s
        return out


class Retriever:
    """The retrieval stage every pipeline shares."""

    def __init__(self, store, embedder, *, top_k: int = 4,
                 score_threshold: Optional[float] = 0.25,
                 max_context_tokens: int = 1500,
                 reranker=None, token_counter=None,
                 default_hybrid: bool = False):
        self.store = store
        self.embedder = embedder
        self.top_k = top_k
        self.score_threshold = score_threshold
        self.max_context_tokens = max_context_tokens
        self.reranker = reranker
        self.tk = token_counter or ApproxTokenizer()
        # retriever.nr_pipeline == "ranked_hybrid" routes default
        # retrieval through the hybrid path (dense + BM25 + rerank).
        self.default_hybrid = default_hybrid

    # -- core --------------------------------------------------------------

    def retrieve_default(self, query: str, top_k: Optional[int] = None
                         ) -> List[SearchResult]:
        """The configured retrieval path: ranked_hybrid when enabled,
        plain dense otherwise. Pipelines call this one."""
        if self.default_hybrid:
            return self.retrieve_hybrid(query, top_k=top_k)
        return self.retrieve(query, top_k=top_k)

    def retrieve(self, query: str, top_k: Optional[int] = None,
                 with_threshold: bool = True) -> List[SearchResult]:
        k = top_k or self.top_k
        with tracing.span("retriever.retrieve", {"top_k": k}) as sp:
            qv = self.embedder.embed_query(query)
            results = self.store.search(
                qv, top_k=k,
                score_threshold=self.score_threshold if with_threshold
                else None)
            if not results and with_threshold:
                # Nothing passed the threshold: retry without it.
                results = self.store.search(qv, top_k=k,
                                            score_threshold=None)
            sp.set_attribute("n_results", len(results))
        return results

    def retrieve_batch(self, queries: Sequence[str],
                       top_k: Optional[int] = None,
                       with_threshold: bool = True
                       ) -> List[List[SearchResult]]:
        """Dense retrieval for MANY queries: one embedder call and one
        store dispatch (sequential searches for a store without
        search_batch: the external ones). Result lists align with the
        query order; a query with no result above the threshold is
        retried without it."""
        k = top_k or self.top_k
        thr = self.score_threshold if with_threshold else None
        batched = hasattr(self.store, "search_batch")

        def search(qvs, threshold):
            if batched:
                return self.store.search_batch(qvs, top_k=k,
                                               score_threshold=threshold)
            return [self.store.search(qv, top_k=k,
                                      score_threshold=threshold)
                    for qv in qvs]

        with tracing.span("retriever.retrieve_batch",
                          {"top_k": k, "n_queries": len(queries)}) as sp:
            if hasattr(self.embedder, "embed_queries"):
                qvs = np.asarray(self.embedder.embed_queries(list(queries)))
            else:
                qvs = np.stack([self.embedder.embed_query(q)
                                for q in queries])
            batches = search(qvs, thr)
            if with_threshold and any(not b for b in batches):
                retry = [i for i, b in enumerate(batches) if not b]
                for i, b in zip(retry, search(qvs[retry], None)):
                    batches[i] = b
            sp.set_attribute("n_results", sum(len(b) for b in batches))
        return batches

    def retrieve_multi(self, queries: Sequence[str],
                       top_k: Optional[int] = None) -> List[SearchResult]:
        """Multi-query-variant retrieval through the CONFIGURED path
        (hybrid included) with ONE dense dispatch, fused by RRF."""
        k = top_k or self.top_k
        if not queries:
            return []
        if len(queries) == 1:
            return self.retrieve_default(queries[0], top_k=k)
        if self.default_hybrid:
            return self.retrieve_hybrid(queries[0], top_k=k,
                                        extra_queries=queries[1:])
        return fuse_ranked(self.retrieve_batch(queries, top_k=k), top_k=k)

    def retrieve_hybrid(self, query: str, top_k: Optional[int] = None,
                        candidates: int = 20,
                        drop_outliers: bool = True,
                        extra_queries: Sequence[str] = ()
                        ) -> List[SearchResult]:
        """ranked_hybrid: dense + BM25 candidates -> cross-encoder rerank
        -> stdev outlier drop. All dense legs (`query` + `extra_queries`)
        score in one batched dispatch; reranking stays against the
        primary query."""
        k = top_k or self.top_k
        if extra_queries:
            lists = self.retrieve_batch([query, *extra_queries],
                                        top_k=candidates,
                                        with_threshold=False)
            dense = [hit for lst in lists for hit in lst]
        else:
            dense = self.retrieve(query, top_k=candidates,
                                  with_threshold=False)
        docs = self.store.snapshot_docs()  # consistent view vs. ingestion
        merged = {r.text: r for r in dense}
        if docs:
            bm = BM25Lexical()
            bm.fit([d["text"] for d in docs])
            s = bm.scores(query)
            for i in np.argsort(s)[::-1][:candidates]:
                if s[i] <= 0:
                    break
                d = docs[int(i)]
                merged.setdefault(
                    d["text"],
                    SearchResult(d["text"], float(s[i]), dict(d["metadata"])))
        cands = list(merged.values())
        if self.reranker is not None and cands:
            scores = self.reranker.score(query, [c.text for c in cands])
            for c, s in zip(cands, scores):
                c.score = float(s)
        cands.sort(key=lambda c: -c.score)
        cands = cands[:k]
        if drop_outliers and len(cands) > 2:
            vals = np.array([c.score for c in cands])
            keep = vals >= vals.mean() - vals.std()
            cands = [c for c, kp in zip(cands, keep) if kp]
        return cands

    # -- observability -----------------------------------------------------

    def microbatch_stats(self) -> dict:
        """Cross-request batcher counters of the stages this retriever
        drives, keyed by stage ("embed" / "rerank" / "search"). Stages
        without a live batcher are omitted; empty = micro-batching off."""
        from generativeaiexamples_tpu_torch.serving.batcher import (
            microbatch_stats_of)

        out = {}
        for name, obj in (("embed", self.embedder),
                          ("rerank", self.reranker),
                          ("search", self.store)):
            snap = microbatch_stats_of(obj)
            if snap is not None:
                out[name] = snap
        return out

    # -- context assembly --------------------------------------------------

    def limit_tokens(self, results: Sequence[SearchResult],
                     budget: Optional[int] = None) -> List[SearchResult]:
        """Whole-chunk token budget."""
        budget = budget if budget is not None else self.max_context_tokens
        out, used = [], 0
        for r in results:
            n = len(self.tk.encode(r.text))
            if used + n > budget:
                break
            used += n
            out.append(r)
        return out

    def context(self, query: str, hybrid: Optional[bool] = None) -> str:
        if hybrid is None:
            hybrid = self.default_hybrid
        results = (self.retrieve_hybrid(query) if hybrid
                   else self.retrieve(query))
        results = self.limit_tokens(results)
        return "\n\n".join(r.text for r in results)
