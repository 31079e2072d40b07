"""Async ingest pipeline over declarative source configs.

Counterpart of generativeaiexamples_tpu/ingest/pipeline.py:

    sources --> chunk (splitter) --> embed (batched) --> store sink
       \\-> per-stage counters (documents / chunks / embeddings)

Each source yields IngestItem(text, metadata): files (glob, optional
watch), RSS/Atom feeds (fetched over `urllib`; the JAX copy uses
`requests`) and an in-process queue. The embed stage batches across
sources and calls the embedder connector (on the card, the arctic
encoder's K3 launches); embed and store are pipelined, so one batch's
`store.add` runs while the next batch embeds. `html_to_text` is also
what rag/documents.py uses where bs4 is not installed.
"""

from __future__ import annotations

import asyncio
import dataclasses
import glob as globlib
import html
import html.parser
import logging
import os
import re
import time
import xml.etree.ElementTree as ET
from typing import AsyncIterator, Dict, List, Optional, Sequence

from generativeaiexamples_tpu_torch.utils import http

_LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class IngestItem:
    text: str
    metadata: Dict = dataclasses.field(default_factory=dict)


class _TextFromHTML(html.parser.HTMLParser):
    """Visible text of a page without bs4: scripts, styles, noscript and
    head dropped."""

    SKIP = {"script", "style", "noscript", "head"}

    def __init__(self):
        super().__init__()
        self.parts: List[str] = []
        self._skip_depth = 0

    def handle_starttag(self, tag, attrs):
        if tag in self.SKIP:
            self._skip_depth += 1

    def handle_endtag(self, tag):
        if tag in self.SKIP and self._skip_depth:
            self._skip_depth -= 1

    def handle_data(self, data):
        if not self._skip_depth and data.strip():
            self.parts.append(data.strip())


def html_to_text(markup: str) -> str:
    p = _TextFromHTML()
    try:
        p.feed(markup)
    except Exception:  # malformed markup: keep what parsed
        pass
    return "\n".join(p.parts)


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


class FileSource:
    """Glob-driven filesystem source with optional watch mode
    (filenames, watch, watch_interval)."""

    def __init__(self, filenames: Sequence[str], *, watch: bool = False,
                 watch_interval: float = 1.0, source_name: str = "file"):
        self.patterns = list(filenames)
        self.watch = watch
        self.watch_interval = watch_interval
        self.source_name = source_name
        self._seen: Dict[str, float] = {}  # path -> mtime
        self.stop_event = asyncio.Event()

    def _scan(self) -> List[str]:
        fresh = []
        for pat in self.patterns:
            for path in sorted(globlib.glob(pat)):
                try:
                    mtime = os.path.getmtime(path)
                except OSError:
                    continue
                if self._seen.get(path) != mtime:
                    self._seen[path] = mtime
                    fresh.append(path)
        return fresh

    async def items(self) -> AsyncIterator[IngestItem]:
        from generativeaiexamples_tpu_torch.rag.documents import load_document

        while True:
            for path in self._scan():
                try:
                    docs = await asyncio.to_thread(
                        load_document, path, os.path.basename(path))
                except Exception as e:
                    _LOG.warning("file source failed on %s: %s", path, e)
                    continue
                for d in docs:
                    yield IngestItem(d.text, {
                        **d.metadata, "source": self.source_name,
                        "filename": os.path.basename(path)})
            if not self.watch or self.stop_event.is_set():
                return
            try:
                await asyncio.wait_for(self.stop_event.wait(),
                                       timeout=self.watch_interval)
                return
            except asyncio.TimeoutError:
                continue


class RSSSource:
    """RSS/Atom feed source. Feeds come from URLs or local files; with
    fetch_content each entry's link is downloaded and text-extracted,
    otherwise the entry summary is used."""

    def __init__(self, feed_input: Sequence[str], *,
                 fetch_content: bool = False, source_name: str = "rss"):
        self.feeds = list(feed_input)
        self.fetch_content = fetch_content
        self.source_name = source_name

    @staticmethod
    def _read(ref: str) -> str:
        if re.match(r"https?://", ref):
            status, body = http.request("GET", ref, timeout=30)
            return http.checked(status, body, ref).decode("utf-8", "replace")
        with open(ref) as fh:
            return fh.read()

    @staticmethod
    def _entries(xml_text: str) -> List[Dict[str, str]]:
        """Both RSS (<item>) and Atom (<entry>), namespace-agnostic."""
        root = ET.fromstring(xml_text)
        out = []
        for node in root.iter():
            tag = node.tag.rsplit("}", 1)[-1]
            if tag not in ("item", "entry"):
                continue
            entry: Dict[str, str] = {}
            for child in node:
                ctag = child.tag.rsplit("}", 1)[-1]
                if ctag in ("title", "description", "summary", "content"):
                    entry[ctag] = html.unescape(
                        "".join(child.itertext()).strip())
                elif ctag == "link":
                    entry["link"] = child.get("href") or (child.text or "")
            if entry:
                out.append(entry)
        return out

    async def items(self) -> AsyncIterator[IngestItem]:
        for ref in self.feeds:
            try:
                entries = self._entries(await asyncio.to_thread(
                    self._read, ref))
            except Exception as e:
                _LOG.warning("rss source failed on %s: %s", ref, e)
                continue
            for e in entries:
                body = e.get("description") or e.get("summary") \
                    or e.get("content") or ""
                link = e.get("link", "")
                if self.fetch_content and link:
                    try:
                        body = html_to_text(await asyncio.to_thread(
                            self._read, link))
                    except Exception as ex:
                        _LOG.warning("content fetch failed for %s: %s",
                                     link, ex)
                text = "\n".join(p for p in (e.get("title", ""), body) if p)
                if text:
                    yield IngestItem(text, {"source": self.source_name,
                                            "link": link,
                                            "title": e.get("title", "")})


class QueueSource:
    """In-process message-bus source: the Kafka-consumer seam (a
    deployment points a thin consumer at `push`, from any thread).
    `close()` ends the stream."""

    _DONE = object()

    def __init__(self, source_name: str = "queue"):
        self.queue: asyncio.Queue = asyncio.Queue()
        self.source_name = source_name
        self._loop = None  # captured when the pipeline starts consuming

    def _put(self, item) -> None:
        # asyncio.Queue is NOT thread-safe; a consumer thread (the
        # advertised Kafka seam) must hand off through the loop.
        loop = self._loop
        if loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(self.queue.put_nowait, item)
        else:
            self.queue.put_nowait(item)  # pre-start, same-thread

    def push(self, text: str, metadata: Optional[Dict] = None) -> None:
        self._put(IngestItem(text, metadata or {}))

    def close(self) -> None:
        self._put(self._DONE)

    async def items(self) -> AsyncIterator[IngestItem]:
        import asyncio as _asyncio

        self._loop = _asyncio.get_running_loop()
        while True:
            item = await self.queue.get()
            if item is self._DONE:
                return
            item.metadata.setdefault("source", self.source_name)
            yield item


def build_sources(source_config: Sequence[Dict]) -> List:
    """Declarative configs -> source objects: [{"type": "filesystem",
    "filenames": [...], "watch": false}, {"type": "rss", ...},
    {"type": "queue"}]."""
    out = []
    for cfg in source_config:
        kind = cfg.get("type")
        if kind == "filesystem":
            out.append(FileSource(
                cfg["filenames"], watch=bool(cfg.get("watch", False)),
                watch_interval=float(cfg.get("watch_interval", 1.0)),
                source_name=cfg.get("name", "file")))
        elif kind == "rss":
            out.append(RSSSource(
                cfg["feed_input"],
                fetch_content=bool(cfg.get("fetch_content", False)),
                source_name=cfg.get("name", "rss")))
        elif kind == "queue":
            out.append(QueueSource(source_name=cfg.get("name", "queue")))
        else:
            raise ValueError(f"unknown source type {kind!r}")
    return out


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class IngestPipeline:
    """sources -> chunk -> batched embed -> store.

    `stats` carries the MonitorStage counters: per-stage totals and the
    embed-stage rate. The embed and store stages are PIPELINED through
    a bounded handoff: batch n+1 embeds while batch n's `store.add`
    runs, so a store whose add path does real work (the tiered ANN
    index assigning rows to partitions, a durable store persisting)
    no longer gates the encoder — the sustained-streaming shape the
    tiered index's warm-tail ingest is built for. When the store
    exposes `stats()` (the in-process vector stores), the final stats
    carry a `store` snapshot so callers see corpus size and the tier
    pager's counters alongside the stage totals.
    """

    def __init__(self, sources: Sequence, splitter, embedder, store, *,
                 embed_batch: int = 64):
        self.sources = list(sources)
        self.splitter = splitter
        self.embedder = embedder
        self.store = store
        self.embed_batch = embed_batch
        self.stats = {"documents": 0, "chunks": 0, "embeddings": 0,
                      "elapsed_s": 0.0}

    async def _produce(self, source, chunk_q: asyncio.Queue) -> None:
        async for item in source.items():
            self.stats["documents"] += 1
            for c in self.splitter.split(item.text):
                await chunk_q.put((c, dict(item.metadata)))
                self.stats["chunks"] += 1

    async def _store_sink(self, batch_q: asyncio.Queue) -> None:
        """Consume embedded batches and add them to the store. One
        batch in flight here overlaps with the NEXT batch's embedding
        in _embed_and_store; `None` ends the stage."""
        while True:
            batch = await batch_q.get()
            if batch is None:
                return
            texts, metas, embs = batch
            await asyncio.to_thread(self.store.add, texts, embs, metas)
            self.stats["embeddings"] += len(texts)

    async def _embed_and_store(self, chunk_q: asyncio.Queue,
                               done: asyncio.Event) -> None:
        buf: List = []
        batch_q: asyncio.Queue = asyncio.Queue(maxsize=2)
        sink = asyncio.create_task(self._store_sink(batch_q))

        async def put_or_die(item):
            """Enqueue for the store stage, racing the put against the
            sink itself: if store.add crashes while the bounded queue
            is full, a bare put would block forever with no consumer —
            surface the store error here instead."""
            put = asyncio.ensure_future(batch_q.put(item))
            await asyncio.wait({put, sink},
                               return_when=asyncio.FIRST_COMPLETED)
            if put.done():
                return put.result()
            put.cancel()
            sink.result()  # sink finished first -> raise its error
            raise RuntimeError("store sink exited before ingest finished")

        async def flush():
            if not buf:
                return
            texts = [t for t, _ in buf]
            metas = [m for _, m in buf]
            embs = await asyncio.to_thread(
                self.embedder.embed_documents, texts)
            await put_or_die((texts, metas, embs))
            buf.clear()

        try:
            while True:
                try:
                    buf.append(await asyncio.wait_for(chunk_q.get(),
                                                      timeout=0.1))
                    if len(buf) >= self.embed_batch:
                        await flush()
                except asyncio.TimeoutError:
                    await flush()  # drain partial batches while idle
                    if done.is_set() and chunk_q.empty():
                        return
        finally:
            if not sink.done():
                try:
                    await put_or_die(None)
                except Exception:
                    pass  # sink error re-raised by the await below
            await sink

    async def run_async(self) -> Dict:
        t0 = time.perf_counter()
        chunk_q: asyncio.Queue = asyncio.Queue(maxsize=4096)
        done = asyncio.Event()
        sink = asyncio.create_task(self._embed_and_store(chunk_q, done))
        try:
            await asyncio.gather(*(self._produce(s, chunk_q)
                                   for s in self.sources))
        finally:
            done.set()
            await sink
        self.stats["elapsed_s"] = round(time.perf_counter() - t0, 3)
        rate = self.stats["embeddings"] / max(self.stats["elapsed_s"], 1e-6)
        self.stats["embeddings_per_s"] = round(rate, 1)
        # Embedders with throttled learned state (LexicalEmbedder's DF
        # snapshot) force-persist what the throttle held back.
        for target in (self.embedder, getattr(self.embedder, "inner",
                                              None)):
            flush = getattr(target, "flush_state", None)
            if callable(flush):
                flush()
                break
        stats_fn = getattr(self.store, "stats", None)
        if callable(stats_fn):
            snap = stats_fn()
            self.stats["store"] = {
                k: snap[k] for k in
                ("ntotal", "index", "tiered", "hbm_resident_fraction",
                 "pager_hbm_hit_rate", "tier_promotions",
                 "tier_demotions") if k in snap}
        _LOG.info("ingest done: %s (%.0f embeddings/s)", self.stats, rate)
        return dict(self.stats)

    def run(self) -> Dict:
        return asyncio.run(self.run_async())
