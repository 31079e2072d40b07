"""Port parity: the persisted store (rag/vectorstore.py save / load /
persist_dir, pipelines/resources.py) and the PDF and HTML loaders
(utils/pdf.py, rag/documents.py, ingest/pipeline.html_to_text).

A store directory written by the JAX package loads in the port and one
written by the port loads in the JAX package: the same queries must find
the same ids (texts) in both, within f32 atol 1e-5 on scores. PDF pages
and HTML text must equal the JAX `load_document`'s on the same bytes
(bs4 is installed here; the port's no-bs4 parser must equal the JAX
ingest pipeline's).
"""

import dataclasses
import json
import zlib

import numpy as np
import pytest

from generativeaiexamples_tpu.ingest.pipeline import (
    html_to_text as jax_html_to_text)
from generativeaiexamples_tpu.rag import documents as jdocs
from generativeaiexamples_tpu.rag.vectorstore import (
    MemoryVectorStore as JMemory, TPUVectorStore as JDevice)
from generativeaiexamples_tpu_torch.config.schema import load_config
from generativeaiexamples_tpu_torch.ingest.pipeline import html_to_text
from generativeaiexamples_tpu_torch.pipelines.resources import Resources
from generativeaiexamples_tpu_torch.rag import documents as tdocs
from generativeaiexamples_tpu_torch.rag.vectorstore import (
    DeviceVectorStore, MemoryVectorStore)

ATOL = 1e-5
DIM = 16


def _unit(rng, n):
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _fill(store, seed=0, n=40):
    rng = np.random.default_rng(seed)
    store.add([f"t{i}" for i in range(n)], _unit(rng, n),
              [{"filename": f"f{i % 4}.txt", "i": i} for i in range(n)])
    store.delete_documents(["f2.txt"])
    return _unit(rng, 6)  # queries


def _hits(store, queries):
    out = [[(h.text, h.metadata, h.score) for h in hits]
           for hits in store.search_batch(queries, top_k=5)]
    return out + [[(h.text, h.metadata, h.score)
                   for h in store.search(queries[0], top_k=3)]]


def _same(got, want):
    for g, w in zip(got, want):
        assert [x[:2] for x in g] == [x[:2] for x in w]
        np.testing.assert_allclose([x[2] for x in g], [x[2] for x in w],
                                   atol=ATOL, rtol=0)


PORT_STORES = {"device": lambda **kw: DeviceVectorStore(DIM, device="cpu",
                                                        **kw),
               "memory": lambda **kw: MemoryVectorStore(DIM, **kw)}
JAX_STORES = {"tpu": lambda **kw: JDevice(DIM, **kw),
              "memory": lambda **kw: JMemory(DIM, **kw)}


@pytest.mark.parametrize("jax_kind", sorted(JAX_STORES))
@pytest.mark.parametrize("port_kind", sorted(PORT_STORES))
def test_store_saved_by_either_package_loads_in_the_other(
        tmp_path, port_kind, jax_kind):
    jstore = JAX_STORES[jax_kind]()
    queries = _fill(jstore)
    jstore.save(str(tmp_path / "from_jax"))
    port = PORT_STORES[port_kind](persist_dir=str(tmp_path / "from_jax"))
    assert len(port) == len(jstore) == 30
    _same(_hits(port, queries), _hits(jstore, queries))

    tstore = PORT_STORES[port_kind]()
    queries = _fill(tstore, seed=1)
    tstore.save(str(tmp_path / "from_port"))
    back = JAX_STORES[jax_kind](persist_dir=str(tmp_path / "from_port"))
    _same(_hits(back, queries), _hits(tstore, queries))
    loaded = type(tstore).load(str(tmp_path / "from_port"), DIM,
                               **({"device": "cpu"} if port_kind == "device"
                                  else {}))
    _same(_hits(loaded, queries), _hits(tstore, queries))
    with open(tmp_path / "from_port" / "docs.jsonl") as fh:
        assert json.loads(fh.readline()) == {
            "text": "t0", "metadata": {"filename": "f0.txt", "i": 0}}


@pytest.mark.parametrize("port_kind", sorted(PORT_STORES))
def test_store_persists_every_mutation_and_refuses_another_width(
        tmp_path, port_kind):
    d = str(tmp_path / "store")
    store = PORT_STORES[port_kind](persist_dir=d)
    rng = np.random.default_rng(3)
    store.add(["a", "b"], _unit(rng, 2), [{"filename": "x"}] * 2)
    assert len(PORT_STORES[port_kind](persist_dir=d)) == 2
    store.add(["c"], _unit(rng, 1), [{"filename": "y"}])
    store.delete_documents(["x"])
    reopened = PORT_STORES[port_kind](persist_dir=d)
    assert [d["text"] for d in reopened.snapshot_docs()] == ["c"]
    assert reopened.list_documents() == ["y"]
    assert not list((tmp_path / "store").glob("*.tmp"))
    with pytest.raises(ValueError, match="holds 16-dim vectors"):
        (DeviceVectorStore(8, device="cpu", persist_dir=d)
         if port_kind == "device" else MemoryVectorStore(8, persist_dir=d))


class _Embedder:
    dim = DIM

    def embed_documents(self, texts):
        out = np.stack([np.random.default_rng(zlib.crc32(t.encode()))
                        .standard_normal(DIM) for t in texts])
        return (out / np.linalg.norm(out, axis=1, keepdims=True)).astype(
            np.float32)

    def embed_query(self, text):
        return self.embed_documents([text])[0]


def test_resources_persist_dir_round_trip(tmp_path):
    """The chain's document store loads `vector_store.persist_dir` at
    construction and saves on every mutation, as the JAX Resources'."""
    config = load_config(env={"APP_VECTORSTORE_PERSISTDIR": str(tmp_path),
                              "APP_VECTORSTORE_NAME": "tpu",
                              "APP_EMBEDDINGS_DIMENSIONS": str(DIM)})
    emb = _Embedder()

    def resources():
        from generativeaiexamples_tpu_torch.connectors.factory import (
            EngineHub)

        return Resources(config, hub=EngineHub(config, device="cpu"),
                         llm=object(), embedder=emb)

    res = resources()
    assert isinstance(res.store, DeviceVectorStore)
    texts = ["pages hold kv", "the scheduler batches", "kernels on hopper"]
    res.store.add(texts, emb.embed_documents(texts),
                  [{"filename": "a.txt"}] * 3)
    again = resources()
    assert again.store is not res.store and len(again.store) == 3
    assert again.retriever.retrieve_default(
        "the scheduler batches")[0].text == "the scheduler batches"
    again.store.delete_documents(["a.txt"])
    assert len(resources().store) == 0


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


PDF_PAGES = [b"BT /F1 12 Tf 72 720 Td (Paged attention reads) Tj ET",
             b"",  # an empty page: no document
             b"BT [(Split) -250 ( across) 120 (CTAs)] TJ ET\n"
             b"BT <48656c6c6f> Tj (esc\\(aped\\)) Tj ET",
             b"BT 0 -14 Td (line one) ' (line two) ' ET"]
HTML = """<html><head><title>T</title><style>p {color: red}</style>
<script>var x = "hidden";</script></head>
<body><h1>Prefix cache</h1><p>Pages are <b>shared</b> by ref count.</p>
<noscript>enable js</noscript><ul><li>one</li><li>two &amp; three</li></ul>
<p>Unicode: café — 中文</p></body></html>"""


@pytest.mark.parametrize("name, body", [
    ("doc.pdf", _pdf(PDF_PAGES)),
    ("page.html", HTML.encode()),
    ("page.htm", b"<p>short</p><script>x</script>"),
    ("bad.pdf", b"not a pdf"),
])
def test_pdf_and_html_documents_match_jax(tmp_path, name, body):
    p = tmp_path / name
    p.write_bytes(body)
    got = tdocs.load_document(str(p))
    want = jdocs.load_document(str(p))
    assert [(d.text, d.metadata) for d in got] == \
        [(d.text, d.metadata) for d in want]
    if name == "doc.pdf":
        assert [d.metadata["page"] for d in got] == [0, 1, 2]
        assert got[0].text.startswith("Paged attention reads")
    if name == "page.html":
        assert "Prefix cache" in got[0].text and "hidden" not in got[0].text


@pytest.mark.parametrize("markup", [
    HTML, "<p>unclosed <b>bold", "", "plain text, no tags",
    "<script>only script</script>", "<div><head>x</head>y</div>"])
def test_html_to_text_matches_jax_ingest(markup):
    assert html_to_text(markup) == jax_html_to_text(markup)


def test_html_without_bs4_uses_the_stdlib_parser(tmp_path, monkeypatch,
                                                 caplog):
    import importlib.util
    import logging

    p = tmp_path / "page.html"
    p.write_text(HTML)
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda n, *a: None if n == "bs4" else real(n, *a))
    with caplog.at_level(logging.INFO):
        (doc,) = tdocs.load_document(str(p))
    assert doc.text == jax_html_to_text(HTML)
    assert "no bs4" in caplog.text
    assert dataclasses.asdict(doc)["metadata"]["filename"] == "page.html"
