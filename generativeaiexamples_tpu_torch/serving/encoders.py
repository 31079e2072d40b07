"""Embedding and reranking engines over the BERT encoder.

Counterpart of generativeaiexamples_tpu/serving/encoders.py: in-process
engines with bucketed padding (each batch is a fixed [max_batch, bucket]
shape). Every batch is dispatched first and its result copied to pinned
host memory without blocking; the host reads the copies only after the
last batch is on the device queue (the JAX engines' "dispatch all, then
drain"). Each encoder layer runs the K3 kernel on the card.

Both engines support cross-request dynamic micro-batching
(`enable_microbatch`, serving/batcher.py): concurrent callers coalesce
into one bucketed forward (one K3 launch a layer over more live rows)
instead of queueing batch-of-1 forwards behind the engine lock. The
batcher's dispatcher thread runs that forward and waits on its host
copies itself, so a caller only ever reads its own slice of a finished
numpy array. Off by default; off is the engine without the batcher.
"""

from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.models import bert
from generativeaiexamples_tpu_torch.serving.batcher import (
    MicroBatcher, MicroBatcherClosed, MicroBatchHost)
from generativeaiexamples_tpu_torch.serving.engine import HostCopy


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _specials(tk):
    """(cls_id, sep_id) if the tokenizer defines them (BERT-style), else
    Nones (hermetic byte tokenizer)."""
    return getattr(tk, "cls_id", None), getattr(tk, "sep_id", None)


def _wrap(ids, cls_id, sep_id, limit):
    """[CLS] ids [SEP], truncated to limit with specials preserved."""
    extra = (cls_id is not None) + (sep_id is not None)
    ids = list(ids)[: max(1, limit - extra)]
    if cls_id is not None:
        ids = [cls_id] + ids
    if sep_id is not None:
        ids = ids + [sep_id]
    return ids


class _EncoderBase(MicroBatchHost):
    """Device placement, fused weights and the batch forward shared by
    both engines."""

    def __init__(self, params, cfg: bert.BertConfig, tokenizer,
                 max_batch: int, buckets: Sequence[int],
                 device: DeviceLike):
        self.device = resolve_device(device)
        if params["tok_emb"].device.type != self.device.type:
            raise ValueError(f"params on {params['tok_emb'].device}, "
                             f"engine on {self.device}")
        # One-time QKV fusion (forward projects with wqkv).
        self.params = bert.fuse_qkv_params(params)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.buckets = [min(b, cfg.max_position) for b in buckets]
        self._lock = threading.Lock()
        self.forwards = 0  # bucketed forwards dispatched (one per batch)

    def _dispatch(self, toks: np.ndarray, lens: np.ndarray,
                  types: np.ndarray = None) -> HostCopy:
        """One bucketed forward, its pooled output on its way to pinned
        host memory (f32)."""
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        self.forwards += 1
        _, pooled = bert.forward(
            self.params, self.cfg, put(toks), lengths=put(lens),
            token_types=None if types is None else put(types))
        return HostCopy(pooled.float())


class EmbeddingEngine(_EncoderBase):
    """Batched text -> normalized vector encoder (arctic-embed recipe:
    CLS pooling + L2 norm; query prefix for queries)."""

    QUERY_PREFIX = "Represent this sentence for searching relevant passages: "

    def __init__(self, params, cfg: bert.BertConfig, tokenizer,
                 max_batch: int = 16, buckets: Sequence[int] = (32, 128, 512),
                 device: DeviceLike = None):
        super().__init__(params, cfg, tokenizer, max_batch, buckets, device)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    def _build_microbatcher(self, max_batch, max_wait_us) -> MicroBatcher:
        """enable_microbatch() coalesces concurrent embed()/embed_query()
        CALLS: one queue item per call (stats read in caller units).
        Calls merge only when their LONGEST row shares a `_bucket` rung,
        and the dispatcher flattens a group's rows into `_forward_ids`,
        which re-sorts by length and packs the same bucket ladder."""
        return MicroBatcher(
            "embed", self._embed_group,
            max_batch=max_batch or self.max_batch, max_wait_us=max_wait_us,
            bucket_fn=lambda ids: _bucket(
                max((len(r) for r in ids), default=1), self.buckets))

    def _embed_group(self, groups: List[List[List[int]]]) -> List[np.ndarray]:
        flat = [row for g in groups for row in g]
        vecs = self._forward_ids(flat)
        out, pos = [], 0
        for g in groups:
            out.append(vecs[pos: pos + len(g)])
            pos += len(g)
        return out

    def _encode_ids(self, texts: Sequence[str]) -> List[List[int]]:
        limit = self.buckets[-1]
        cls_id, sep_id = _specials(self.tokenizer)
        return [_wrap(self.tokenizer.encode(t), cls_id, sep_id, limit)
                for t in texts]

    def embed(self, texts: Sequence[str], is_query: bool = False) -> np.ndarray:
        """[n] texts -> [n, D] float32 normalized embeddings."""
        if not len(texts):
            return np.zeros((0, self.cfg.dim), np.float32)
        if is_query:
            texts = [self.QUERY_PREFIX + t for t in texts]
        ids = self._encode_ids(texts)
        b = self._batcher  # read once: a racing disable must not crash
        if b is not None:
            # The whole call is ONE queue item; calls whose longest rows
            # share a bucket merge into one length-sorted pass. Rows are
            # independent in the forward, so a coalesced single-row call
            # runs the same [max_batch, S] forward as a direct one.
            try:
                return b.submit(ids)
            except MicroBatcherClosed:
                pass  # raced a disable/re-enable: the direct forward
        return self._forward_ids(ids)

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed([text], is_query=True)[0]

    def _forward_ids(self, ids: Sequence[List[int]]) -> np.ndarray:
        """Token-id rows -> [n, D] embeddings: sort by length, pack into
        bucketed fixed-shape batches, one forward per chunk; all batches
        are dispatched before the first host read."""
        out = np.zeros((len(ids), self.cfg.dim), np.float32)
        order = sorted(range(len(ids)), key=lambda i: len(ids[i]))
        with self._lock:
            pending = []
            for start in range(0, len(order), self.max_batch):
                chunk = order[start: start + self.max_batch]
                S = _bucket(max(len(ids[i]) for i in chunk) or 1,
                            self.buckets)
                toks = np.zeros((self.max_batch, S), np.int32)
                lens = np.ones((self.max_batch,), np.int32)
                for row, i in enumerate(chunk):
                    toks[row, : len(ids[i])] = ids[i]
                    lens[row] = max(1, len(ids[i]))
                pending.append((self._dispatch(toks, lens), chunk))
            for copy, chunk in pending:
                vecs = copy.numpy()
                for row, i in enumerate(chunk):
                    out[i] = vecs[row]
        return out


class RerankEngine(_EncoderBase):
    """Cross-encoder (query, passage) -> relevance score, the reranker of
    ranked_hybrid retrieval."""

    def __init__(self, params, cfg: bert.BertConfig, tokenizer,
                 max_batch: int = 8, buckets: Sequence[int] = (128, 256, 512),
                 device: DeviceLike = None):
        if cfg.n_labels < 1:
            raise ValueError("reranker config must set n_labels >= 1")
        super().__init__(params, cfg, tokenizer, max_batch, buckets, device)

    def _build_microbatcher(self, max_batch, max_wait_us) -> MicroBatcher:
        """enable_microbatch() coalesces concurrent score() CALLS (one
        queue item per (query, passages) set), flattening a group's pairs
        into one cross-encoder pass and splitting the scores back per
        caller. Sets are keyed by their longest pair's bucket, so a short
        set never pays a long set's padding."""
        return MicroBatcher(
            "rerank", self._score_group,
            max_batch=max_batch or self.max_batch, max_wait_us=max_wait_us,
            bucket_fn=lambda pairs: _bucket(
                max(max(1, len(p[0])) for p in pairs), self.buckets))

    def _score_group(self, groups: List[List[Tuple[List[int], int]]]
                     ) -> List[np.ndarray]:
        flat = [pair for g in groups for pair in g]
        scores = self._forward_pairs(flat)
        out, pos = [], 0
        for g in groups:
            out.append(np.asarray(scores[pos: pos + len(g)], np.float32))
            pos += len(g)
        return out

    def score(self, query: str, passages: Sequence[str]) -> np.ndarray:
        """[n] passages -> [n] float32 relevance scores (higher=better)."""
        if not len(passages):
            return np.zeros((0,), np.float32)
        limit = self.buckets[-1]
        cls_id, sep_id = _specials(self.tokenizer)
        q_ids = self.tokenizer.encode(query)
        pairs: List[Tuple[List[int], int]] = []  # (ids, segment-B start)
        for p in passages:
            p_ids = self.tokenizer.encode(p)
            # [CLS] q [SEP] p [SEP] -- BERT sentence-pair convention
            head = _wrap(q_ids, cls_id, sep_id, limit)
            tail = list(p_ids)[: max(0, limit - len(head) - 1)]
            if sep_id is not None and tail:
                tail = tail + [sep_id]
            pairs.append((head + tail, len(head)))
        b = self._batcher  # read once: a racing disable must not crash
        if b is not None:
            # The (query, passages) set is ONE queue item (see embed).
            try:
                return b.submit(pairs)
            except MicroBatcherClosed:
                pass  # raced a disable/re-enable: the direct forward
        return self._forward_pairs(pairs)

    def _forward_pairs(self, pairs: Sequence[Tuple[List[int], int]]
                       ) -> np.ndarray:
        """(ids, segment-B start) rows -> [n] scores, one forward per
        bucketed chunk, dispatched before the first host read."""
        out = np.zeros((len(pairs),), np.float32)
        with self._lock:
            pending = []
            for start in range(0, len(pairs), self.max_batch):
                chunk = pairs[start: start + self.max_batch]
                S = _bucket(max(len(c[0]) for c in chunk) or 1, self.buckets)
                toks = np.zeros((self.max_batch, S), np.int32)
                lens = np.ones((self.max_batch,), np.int32)
                types = np.zeros((self.max_batch, S), np.int32)
                for row, (ids, sep) in enumerate(chunk):
                    toks[row, : len(ids)] = ids
                    lens[row] = max(1, len(ids))
                    types[row, sep: len(ids)] = 1  # segment B = passage
                pending.append((self._dispatch(toks, lens, types), start,
                                len(chunk)))
            for copy, start, n in pending:
                out[start: start + n] = copy.numpy()[:n, 0]
        return out
