"""Cross-request dynamic micro-batching for the RAG pre-generation path.

The port's copy of generativeaiexamples_tpu/serving/batcher.py (pure
Python and numpy): a submit-future queue per operation coalesces
concurrent callers into ONE device dispatch under `(max_batch,
max_wait_us)` knobs, the Triton dynamic-batcher role.

Grouping is length-bucket-aware: the owner passes a `bucket_fn` (the
encoder engines reuse their `_bucket` padding rungs from
serving/encoders.py) and only requests sharing a bucket key merge, so
coalescing never inflates padding: a 32-token query is never dragged
into a 512-token forward, and searches only merge when their (top_k,
threshold) agree.

Wiring (all off by default; the `serving.microbatch_*` config knobs):

- `EmbeddingEngine.enable_microbatch`: concurrent `embed_query` /
  `embed` calls merge into one bucketed BERT forward (K3 on the card).
- `RerankEngine.enable_microbatch`: concurrent (query, passages) sets
  merge into one cross-encoder batch, split back per caller.
- `MemoryVectorStore/DeviceVectorStore.enable_microbatch`: concurrent
  single-query searches funnel through the one-dispatch `search_batch`.
- `MicroBatchedEmbedder`: the connector-level wrapper for embedders
  without an engine (hash fake, remote HTTP): coalesces `embed_query`
  calls into one `embed_queries` call.

Counters (`MicroBatchStats`: lock-guarded writers, snapshot reads)
surface on the chain server's `GET /metrics`: mean coalesced batch
size, queue-wait p50/p99, and dispatches saved.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class MicroBatchStats:
    """Counters for one batcher. Single dispatcher-thread writer for
    dispatch stats, any-thread writer for submissions; snapshot() is
    what /metrics serves."""

    WAIT_WINDOW = 4096  # bounded percentile window, constant scrape cost

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.submitted = 0
        self.dispatches = 0
        self.dispatch_errors = 0    # dispatches whose fn raised
        self.coalesced_sum = 0      # requests that rode SOME dispatch
        self.max_coalesced = 0
        self._wait_ms: deque = deque(maxlen=self.WAIT_WINDOW)

    def note_submitted(self, n: int) -> None:
        with self._lock:
            self.submitted += n

    def note_dispatch(self, batch_size: int, waits_ms: Sequence[float],
                      error: bool = False) -> None:
        with self._lock:
            self.dispatches += 1
            if error:
                self.dispatch_errors += 1
            self.coalesced_sum += batch_size
            self.max_coalesced = max(self.max_coalesced, batch_size)
            self._wait_ms.extend(waits_ms)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            waits = sorted(self._wait_ms)
            pct = lambda p: (round(waits[int(p * (len(waits) - 1))], 3)  # noqa: E731
                             if waits else None)
            return {
                "submitted": self.submitted,
                "dispatches": self.dispatches,
                # Dispatches whose fn raised: the error fans out to the
                # waiting callers, but /metrics must show it too — a
                # rising count here with green caller stats means
                # callers are retrying around a sick device path.
                "dispatch_errors": self.dispatch_errors,
                # Device launches avoided vs. the serialize-everything
                # baseline (one dispatch per caller).
                "dispatches_saved": self.coalesced_sum - self.dispatches,
                "mean_batch_size": (round(self.coalesced_sum
                                          / self.dispatches, 3)
                                    if self.dispatches else None),
                "max_batch_size": self.max_coalesced,
                "queue_wait_p50_ms": pct(0.50),
                "queue_wait_p99_ms": pct(0.99),
            }


class MicroBatcherClosed(RuntimeError):
    """Raised by submit() on a closed batcher. Callers that hold a
    batcher reference across a concurrent disable/re-enable catch this
    and fall back to their direct (un-batched) path."""


class _Pending:
    __slots__ = ("item", "key", "event", "result", "error", "t")

    def __init__(self, item, key):
        self.item = item
        self.key = key
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t = time.perf_counter()


class MicroBatcher:
    """Submit-future queue coalescing concurrent callers into one
    `fn(items)` call.

    `fn` receives a list of items (all sharing one `bucket_fn` key, at
    most `max_batch` long) and must return a sequence of per-item
    results in the same order. The dispatcher thread waits up to
    `max_wait_us` from the OLDEST queued request before launching, or
    launches immediately once `max_batch` requests are queued; requests
    arriving while `fn` runs coalesce into the next dispatch, so under
    load the window never adds latency — the device is already busy.
    """

    def __init__(self, name: str, fn: Callable[[List[Any]], Sequence[Any]],
                 *, max_batch: int = 16, max_wait_us: int = 2000,
                 bucket_fn: Optional[Callable[[Any], Any]] = None,
                 stats: Optional[MicroBatchStats] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.name = name
        self.max_batch = int(max_batch)
        self.max_wait_s = max(0, int(max_wait_us)) / 1e6
        self._fn = fn
        self._bucket_fn = bucket_fn
        self.stats = stats or MicroBatchStats()
        self._cond = threading.Condition()
        self._queue: List[_Pending] = []
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # -- submission --------------------------------------------------------

    def submit(self, item: Any) -> Any:
        return self.submit_many([item])[0]

    def submit_many(self, items: Sequence[Any]) -> List[Any]:
        """Queue every item and block until all results land. Items from
        one call may ride different dispatches (different buckets) —
        results always come back in item order."""
        if not len(items):
            return []
        reqs = [_Pending(it, self._bucket_fn(it) if self._bucket_fn else None)
                for it in items]
        with self._cond:
            if self._closed:
                raise MicroBatcherClosed(
                    f"MicroBatcher {self.name!r} is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name=f"microbatch-{self.name}",
                    daemon=True)
                self._thread.start()
            self._queue.extend(reqs)
            self.stats.note_submitted(len(reqs))
            self._cond.notify_all()
        for r in reqs:
            r.event.wait()
        for r in reqs:
            if r.error is not None:
                raise r.error
        return [r.result for r in reqs]

    def close(self) -> None:
        """Stop accepting work; queued requests still complete."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- dispatcher thread -------------------------------------------------

    # graftlint: hot-path
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                deadline = self._queue[0].t + self.max_wait_s
                while len(self._queue) < self.max_batch and not self._closed:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                group = self._take_group()
            if group:
                self._run(group)

    def _take_group(self) -> List[_Pending]:
        """Pop the oldest request's bucket-mates (arrival order, at most
        max_batch). Other buckets stay queued; the loop re-enters with
        an already-expired deadline, so they drain right behind."""
        key0 = self._queue[0].key
        group: List[_Pending] = []
        rest: List[_Pending] = []
        for r in self._queue:
            if r.key == key0 and len(group) < self.max_batch:
                group.append(r)
            else:
                rest.append(r)
        self._queue = rest
        return group

    def _run(self, group: List[_Pending]) -> None:
        now = time.perf_counter()
        waits_ms = [(now - r.t) * 1e3 for r in group]
        try:
            results = self._fn([r.item for r in group])
            if len(results) != len(group):
                raise RuntimeError(
                    f"MicroBatcher {self.name!r}: fn returned "
                    f"{len(results)} results for {len(group)} items")
        except BaseException as e:  # propagate to every waiter
            results, error = None, e
        else:
            error = None
        # Record BEFORE waking waiters: a caller that reads stats right
        # after its result lands must see this dispatch counted.
        self.stats.note_dispatch(len(group), waits_ms,
                                 error=error is not None)
        for i, r in enumerate(group):
            if error is not None:
                r.error = error
            else:
                r.result = results[i]
            r.event.set()


class MicroBatchHost:
    """Shared enable/disable/stats plumbing for everything that owns a
    batcher (embedding engine, rerank engine, in-process vector
    stores). Subclasses implement `_build_microbatcher(max_batch,
    max_wait_us)` returning a configured MicroBatcher; `max_batch=None`
    means "the subclass's natural batch width"."""

    _batcher: Optional[MicroBatcher] = None

    def _build_microbatcher(self, max_batch: Optional[int],
                            max_wait_us: int) -> MicroBatcher:
        raise NotImplementedError

    def enable_microbatch(self, max_batch: Optional[int] = None,
                          max_wait_us: int = 2000) -> MicroBatcher:
        """Coalesce concurrent callers into one device dispatch
        (module docstring). Off (the default) is byte-identical to the
        un-batched code path."""
        if self._batcher is not None:
            self._batcher.close()
        self._batcher = self._build_microbatcher(max_batch, max_wait_us)
        return self._batcher

    def disable_microbatch(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None

    def microbatch_stats(self) -> Optional[Dict[str, Any]]:
        b = self._batcher  # read once: racing disable() must not crash
        return b.stats.snapshot() if b is not None else None


# -- connector-level fallback ----------------------------------------------


class MicroBatchedEmbedder:
    """Coalesce concurrent `embed_query` calls into ONE `embed_queries`
    call on any embedder that lacks an engine-level batcher (hash fake,
    remote HTTP endpoints). Everything else delegates to the inner
    embedder untouched; already-batched entry points stay direct."""

    def __init__(self, inner, *, max_batch: int = 16,
                 max_wait_us: int = 2000):
        self.inner = inner
        self._batcher = MicroBatcher(
            f"embed[{type(inner).__name__}]", self._embed_group,
            max_batch=max_batch, max_wait_us=max_wait_us)

    def _embed_group(self, texts: List[str]) -> List[np.ndarray]:
        return list(np.asarray(self.inner.embed_queries(list(texts)),
                               np.float32))

    def embed_query(self, text: str) -> np.ndarray:
        return self._batcher.submit(text)

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self.inner.embed_queries(texts)

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        return self.inner.embed_documents(texts)

    def microbatch_stats(self) -> Dict[str, Any]:
        return self._batcher.stats.snapshot()

    def __getattr__(self, name):
        return getattr(self.inner, name)


# -- wiring helpers (Resources / tests / bench) ----------------------------


def enable_embedder_microbatch(embedder, *, max_batch: int = 16,
                               max_wait_us: int = 2000):
    """Batch an embedder at the best available level: the in-process
    engine when there is one (bucketed forward merge), else a
    connector-level embed_queries wrapper, else unchanged."""
    eng = getattr(embedder, "engine", None)
    if eng is not None and hasattr(eng, "enable_microbatch"):
        eng.enable_microbatch(max_batch=max_batch, max_wait_us=max_wait_us)
        return embedder
    if hasattr(embedder, "embed_queries"):
        return MicroBatchedEmbedder(embedder, max_batch=max_batch,
                                    max_wait_us=max_wait_us)
    return embedder


def enable_reranker_microbatch(reranker, *, max_batch: int = 16,
                               max_wait_us: int = 2000):
    """Engine-level only: merging (query, passages) sets needs the
    cross-encoder pair layout, which lives in RerankEngine. Fakes and
    remote rerankers pass through unbatched."""
    if reranker is None:
        return None
    eng = getattr(reranker, "engine", None)
    if eng is not None and hasattr(eng, "enable_microbatch"):
        eng.enable_microbatch(max_batch=max_batch, max_wait_us=max_wait_us)
    return reranker


def microbatch_stats_of(obj) -> Optional[Dict[str, Any]]:
    """The batcher snapshot for a connector/engine/store, or None when
    it has no live batcher (wiring off or unsupported backend)."""
    if obj is None:
        return None
    for target in (obj, getattr(obj, "engine", None)):
        fn = getattr(target, "microbatch_stats", None)
        if fn is None:
            continue
        snap = fn()
        if snap is not None:
            return snap
    return None
