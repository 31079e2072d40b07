"""Port parity: ingest/pipeline.py (sources, stages, stats).

Each source of both packages runs over the same inputs (files on disk;
RSS and Atom feeds as files and from a local stdlib HTTP server, with
linked pages fetched; a queue fed from another thread) and must yield
equal items. The pipelines run a tiny BERT embedder carried across
(models/convert.py) over the same files into each package's memory
store: equal stats, store rows (ids, texts, metadata) and embeddings
within 1e-5, and the same store-crash error.
"""

import asyncio
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.connectors.local import (
    LocalEmbedder as JLocalEmbedder)
from generativeaiexamples_tpu.ingest import pipeline as jp
from generativeaiexamples_tpu.models import bert as jb
from generativeaiexamples_tpu.rag.splitter import (
    RecursiveCharacterSplitter as JSplitter)
from generativeaiexamples_tpu.rag.vectorstore import (
    MemoryVectorStore as JStore)
from generativeaiexamples_tpu.serving.encoders import (
    EmbeddingEngine as JEmbed)
from generativeaiexamples_tpu.utils.tokenizer import ByteTokenizer as JTok
from generativeaiexamples_tpu_torch.connectors.local import LocalEmbedder
from generativeaiexamples_tpu_torch.ingest import pipeline as tp
from generativeaiexamples_tpu_torch.models import bert as tb
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.rag.splitter import (
    RecursiveCharacterSplitter)
from generativeaiexamples_tpu_torch.rag.vectorstore import MemoryVectorStore
from generativeaiexamples_tpu_torch.serving.encoders import EmbeddingEngine
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

RSS_XML = """<?xml version="1.0"?>
<rss version="2.0"><channel>
  <item><title>New accelerator</title>
    <description>The chip ships with &lt;b&gt;80 GB&lt;/b&gt; HBM.</description>
    <link>{base}/a.html</link></item>
  <item><title>Ring attention paper</title>
    <description>Sequence parallelism over links.</description></item>
  <item><link>{base}/missing.html</link></item>
</channel></rss>"""

ATOM_XML = """<?xml version="1.0"?>
<feed xmlns="http://www.w3.org/2005/Atom">
  <entry><title>Kernel guide</title>
    <summary>Kernels stream pages into shared memory.</summary>
    <link href="{base}/b.html"/></entry>
  <entry><title>Untitled</title><content>Plain content body.</content></entry>
</feed>"""

PAGES = {
    "/a.html": b"<html><head><script>x()</script></head><body><p>Article "
               b"A body</p><p>second para</p></body></html>",
    "/b.html": b"<p>Article B</p><style>p{}</style>",
}


def _pdf(pages):
    """A minimal PDF: one FlateDecode content stream a page."""
    out = (b"%PDF-1.4\n1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\n"
           b"endobj\n2 0 obj\n<< /Type /Pages /Kids ["
           + b" ".join(b"%d 0 R" % (3 + 2 * i) for i in range(len(pages)))
           + b"] /Count %d >>\nendobj\n" % len(pages))
    for i, ops in enumerate(pages):
        num, content = 3 + 2 * i, zlib.compress(ops)
        out += (b"%d 0 obj\n<< /Type /Page /Parent 2 0 R /Contents %d 0 R "
                b">>\nendobj\n%d 0 obj\n<< /Length %d /Filter /FlateDecode "
                b">>\nstream\n" % (num, num + 1, num + 1, len(content))
                + content + b"\nendstream\nendobj\n")
    return out + b"trailer\n<< /Root 1 0 R >>\n%%EOF"


@pytest.fixture
def site():
    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = PAGES.get(self.path)
            if self.path == "/feed.xml":
                body = RSS_XML.format(base=base).encode()
            if body is None:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield base
    httpd.shutdown()
    httpd.server_close()


def _corpus(d):
    rng = np.random.default_rng(0)
    words = ["pages", "kernel", "cache", "tensor", "stream", "batch",
             "query", "store", "chip", "token"]
    for i in range(3):
        (d / f"doc{i}.txt").write_text(" ".join(
            rng.choice(words, 120 + 40 * i)) + ".")
    (d / "page.html").write_text("<html><head><style>p{}</style></head>"
                                 "<body><h1>Title</h1><p>"
                                 + " ".join(rng.choice(words, 80))
                                 + "</p></body></html>")
    (d / "doc.pdf").write_bytes(_pdf([
        b"BT /F1 12 Tf 72 720 Td (Paged attention reads pages) Tj ET",
        b"BT (second page text) Tj ET"]))
    (d / "skip.md").write_text("not matched by the glob")


def _items(source):
    async def run():
        return [(i.text, i.metadata) async for i in source.items()]

    return asyncio.run(run())


def test_file_sources_yield_equal_items(tmp_path):
    _corpus(tmp_path)
    pats = [str(tmp_path / "*.txt"), str(tmp_path / "*.html"),
            str(tmp_path / "*.pdf"), str(tmp_path / "none*")]
    got = _items(tp.FileSource(pats, source_name="fs"))
    want = _items(jp.FileSource(pats, source_name="fs"))
    assert got == want and len(got) == 6
    # A second scan finds nothing new in either.
    src, jsrc = tp.FileSource(pats), jp.FileSource(pats)
    _items(src), _items(jsrc)
    assert _items(src) == _items(jsrc) == []


def test_rss_sources_yield_equal_items(tmp_path, site):
    rss = tmp_path / "feed.rss"
    rss.write_text(RSS_XML.format(base=site))
    atom = tmp_path / "feed.atom"
    atom.write_text(ATOM_XML.format(base=site))
    feeds = [str(rss), str(atom), f"{site}/feed.xml", f"{site}/nope.xml",
             str(tmp_path / "absent.xml")]
    for fetch in (False, True):
        got = _items(tp.RSSSource(feeds, fetch_content=fetch))
        want = _items(jp.RSSSource(feeds, fetch_content=fetch))
        assert got == want, fetch
    assert any("Article A body" in t for t, _ in got)
    assert tp.RSSSource._entries(RSS_XML.format(base="x")) == \
        jp.RSSSource._entries(RSS_XML.format(base="x"))


def test_queue_sources_yield_equal_items():
    def feed(src):
        def run():
            for i in range(5):
                src.push(f"message {i}", {"n": i} if i % 2 else None)
            src.close()
        return run

    out = {}
    for name, mod in (("port", tp), ("jax", jp)):
        src = mod.QueueSource(source_name="bus")

        async def consume():
            agen = src.items()
            first = asyncio.ensure_future(agen.__anext__())
            await asyncio.sleep(0.05)  # the source has captured the loop
            t = threading.Thread(target=feed(src))
            t.start()
            item = await first
            items = [(item.text, item.metadata)]
            async for i in agen:
                items.append((i.text, i.metadata))
            t.join()
            return items

        out[name] = asyncio.run(consume())
    assert out["port"] == out["jax"] and len(out["port"]) == 5


def test_build_sources_equal_jax(tmp_path):
    cfg = [{"type": "filesystem", "filenames": [str(tmp_path / "*.txt")],
            "watch": True, "watch_interval": 0.5, "name": "f"},
           {"type": "rss", "feed_input": ["x.xml"], "fetch_content": True},
           {"type": "queue", "name": "bus"}]
    got, want = tp.build_sources(cfg), jp.build_sources(cfg)
    assert [type(s).__name__ for s in got] == \
        [type(s).__name__ for s in want]
    for g, w in zip(got, want):
        for k in ("patterns", "watch", "watch_interval", "source_name",
                  "feeds", "fetch_content"):
            assert getattr(g, k, None) == getattr(w, k, None), k
    for bad in ([{"type": "kafka"}], [{}]):
        with pytest.raises(ValueError) as e:
            tp.build_sources(bad)
        with pytest.raises(ValueError) as je:
            jp.build_sources(bad)
        assert str(e.value) == str(je.value)


def test_html_to_text_equals_jax():
    for markup in (PAGES["/a.html"].decode(), "<p>un<b>closed",
                   "<script>only</script>", ""):
        assert tp.html_to_text(markup) == jp.html_to_text(markup)


GEOM = dict(vocab_size=512, dim=32, n_layers=2, n_heads=2, mlp_dim=64,
            max_position=128)


@pytest.fixture(scope="module")
def embedders():
    jcfg, tcfg = jb.BertConfig(**GEOM), tb.BertConfig(**GEOM)
    jparams = jb.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.bert_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return (JLocalEmbedder(JEmbed(jparams, jcfg, JTok(), max_batch=8,
                                  use_pallas=False)),
            LocalEmbedder(EmbeddingEngine(tparams, tcfg, ByteTokenizer(),
                                          max_batch=8, device="cpu")))


def _pipelines(tmp_path, embedders, store_cls=(JStore, MemoryVectorStore)):
    pats = [str(tmp_path / "*.txt"), str(tmp_path / "*.html"),
            str(tmp_path / "*.pdf")]
    jemb, temb = embedders
    jstore, tstore = store_cls[0](GEOM["dim"]), store_cls[1](GEOM["dim"])
    jpipe = jp.IngestPipeline([jp.FileSource(pats)], JSplitter(100, 10),
                              jemb, jstore, embed_batch=4)
    tpipe = tp.IngestPipeline([tp.FileSource(pats)],
                              RecursiveCharacterSplitter(100, 10), temb,
                              tstore, embed_batch=4)
    return (jpipe, jstore), (tpipe, tstore)


def test_pipelines_give_equal_stats_rows_and_embeddings(tmp_path,
                                                        embedders):
    _corpus(tmp_path)
    (jpipe, jstore), (tpipe, tstore) = _pipelines(tmp_path, embedders)
    want, got = jpipe.run(), tpipe.run()
    drop = ("elapsed_s", "embeddings_per_s")
    assert {k: v for k, v in got.items() if k not in drop} == \
        {k: v for k, v in want.items() if k not in drop}
    assert got["documents"] == 6 and got["chunks"] == got["embeddings"] > 8
    assert got["store"]["ntotal"] == got["chunks"]
    assert tstore._docs == jstore._docs
    np.testing.assert_allclose(tstore._vecs, jstore._vecs, atol=1e-5)


def test_store_crash_surfaces_the_same_error(tmp_path, embedders):
    _corpus(tmp_path)

    def crashing(base):
        class Crashing(base):
            def add(self, *a, **k):
                raise RuntimeError("disk full")
        return Crashing

    (jpipe, _), (tpipe, _) = _pipelines(
        tmp_path, embedders, (crashing(JStore), crashing(MemoryVectorStore)))
    errors = []
    for pipe in (jpipe, tpipe):
        with pytest.raises(RuntimeError) as e:
            pipe.run()
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "disk full"


def test_multi_source_pipeline_equal_as_sets(tmp_path, site, embedders):
    """Files, a feed and a queue at once: the producers interleave in
    either package's own order, so rows compare as sets."""
    _corpus(tmp_path)
    rss = tmp_path / "feed.rss"
    rss.write_text(RSS_XML.format(base=site))
    rows = {}
    for name, mod, split, emb, store in (
            ("jax", jp, JSplitter(100, 10), embedders[0],
             JStore(GEOM["dim"])),
            ("port", tp, RecursiveCharacterSplitter(100, 10), embedders[1],
             MemoryVectorStore(GEOM["dim"]))):
        q = mod.QueueSource()
        for i in range(3):
            q.push(f"queued event {i} about pages")
        q.close()
        pipe = mod.IngestPipeline(
            [mod.FileSource([str(tmp_path / "*.txt")]),
             mod.RSSSource([str(rss)], fetch_content=True), q],
            split, emb, store, embed_batch=3)
        stats = pipe.run()
        order = sorted(range(len(store._docs)), key=lambda i: (
            store._docs[i]["text"], sorted(store._docs[i]["metadata"]
                                           .items())))
        rows[name] = (stats["documents"], stats["chunks"],
                      [store._docs[i] for i in order],
                      store._vecs[order])
    assert rows["port"][:3] == rows["jax"][:3]
    # 3 files, 2 feed items (the third has no text once its link 404s),
    # 3 events.
    assert rows["port"][0] == 3 + 2 + 3
    # Batches group other chunks here, and a batch pads to its longest.
    np.testing.assert_allclose(rows["port"][3], rows["jax"][3], atol=1e-5)
