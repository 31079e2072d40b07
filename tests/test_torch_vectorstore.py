"""Port parity: ops/topk.py, rag/vectorstore.py, rag/splitter.py,
rag/documents.py and rag/retriever.py.

The same seeded rows and queries go into the port's stores (the device
store on the CPU, and the host store) and the JAX package's
`TPUVectorStore` / `MemoryVectorStore`. Ids (here: texts) must be equal
and scores within f32 atol 1e-5 (one f32 dot product of unit vectors),
through thresholds, deletes and re-adds.
"""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.connectors.fakes import OverlapReranker
from generativeaiexamples_tpu.ops.topk import mips_topk as jtopk
from generativeaiexamples_tpu.rag import documents as jdocs
from generativeaiexamples_tpu.rag import retriever as jret
from generativeaiexamples_tpu.rag import splitter as jsplit
from generativeaiexamples_tpu.rag.vectorstore import (
    MemoryVectorStore as JMemory, TPUVectorStore as JDevice)
from generativeaiexamples_tpu_torch.config.schema import load_config
from generativeaiexamples_tpu_torch.ops.topk import mips_topk
from generativeaiexamples_tpu_torch.rag import documents as tdocs
from generativeaiexamples_tpu_torch.rag import retriever as tret
from generativeaiexamples_tpu_torch.rag import splitter as tsplit
from generativeaiexamples_tpu_torch.rag.vectorstore import (
    DeviceVectorStore, MemoryVectorStore, create_vector_store)

ATOL = 1e-5
DIM = 32


def _unit(rng, n):
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _fill(stores, rng, n, prefix, files=3):
    vecs = _unit(rng, n)
    texts = [f"{prefix}{i}" for i in range(n)]
    metas = [{"filename": f"{prefix}{i % files}.txt"} for i in range(n)]
    for s in stores:
        s.add(texts, vecs, metas)


def _view(results):
    return [(r.text, r.metadata) for r in results], \
        np.array([r.score for r in results])


def _same(got, want):
    (gi, gs), (wi, ws) = _view(got), _view(want)
    assert gi == wi
    np.testing.assert_allclose(gs, ws, atol=ATOL, rtol=0)


def test_mips_topk_matches_jax():
    rng = np.random.default_rng(0)
    q, db = _unit(rng, 5), _unit(rng, 200)
    s, i = mips_topk(torch.from_numpy(q), torch.from_numpy(db), 7)
    js, ji = jtopk(jnp.asarray(q), jnp.asarray(db), 7)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL, rtol=0)


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_stores_match_jax_through_thresholds_deletes_and_readds(metric):
    rng = np.random.default_rng(1)
    port = [DeviceVectorStore(DIM, metric, device="cpu"),
            MemoryVectorStore(DIM, metric)]
    jax_ = [JDevice(DIM, metric), JMemory(DIM, metric)]
    _fill(port + jax_, rng, 60, "a")
    queries = _unit(rng, 6) * (3.0 if metric == "cosine" else 1.0)

    def check():
        for thr in (None, 0.1, 0.95):
            for (t, j) in zip(port, jax_):
                for q in queries:
                    _same(t.search(q, top_k=5, score_threshold=thr),
                          j.search(q, top_k=5, score_threshold=thr))
                for g, w in zip(t.search_batch(queries, 4, thr),
                                j.search_batch(queries, 4, thr)):
                    _same(g, w)

    check()
    for t, j in zip(port, jax_):
        assert t.delete_documents(["a1.txt"]) == j.delete_documents(
            ["a1.txt"]) == 20
        assert t.delete_documents(["nope.txt"]) == 0
        assert t.list_documents() == j.list_documents() == ["a0.txt",
                                                            "a2.txt"]
        assert len(t) == len(j) == 40
    check()
    _fill(port + jax_, rng, 30, "b")  # re-add after a delete
    check()
    for t, j in zip(port, jax_):
        assert t.snapshot_docs() == j.snapshot_docs()
        ts, js = t.stats(), j.stats()
        assert set(ts) <= set(js)
        assert ts["ntotal"] == js["ntotal"] == 70
        assert ts["searches"] == js["searches"]


def test_device_store_keeps_rows_on_its_device_and_takes_tensors():
    store = DeviceVectorStore(DIM, device="cpu")
    assert store.search(np.ones(DIM), top_k=3) == []
    rows = torch.from_numpy(_unit(np.random.default_rng(2), 10))
    store.add([str(i) for i in range(10)], rows)
    assert store._vecs is None and store._pending  # folded in lazily
    assert store.search(rows[4].numpy(), top_k=1)[0].text == "4"
    assert not store._pending
    torch.testing.assert_close(store.rows(), rows)
    with pytest.raises(ValueError, match="embeddings"):
        store.add(["x"], np.zeros((2, DIM)))


def test_create_vector_store_names_and_refusals(tmp_path):
    cfg = load_config(env={})
    assert isinstance(create_vector_store(cfg, 8), MemoryVectorStore)
    for name in ("tpu", "native"):
        c = load_config(env={}, overrides={"vector_store": {"name": name}})
        assert isinstance(create_vector_store(c, 8, device="cpu"),
                          DeviceVectorStore)
    # The external stores are built, and fail loudly without a server.
    for name in ("milvus", "pgvector"):
        c = dataclasses.replace(cfg, vector_store=dataclasses.replace(
            cfg.vector_store, name=name))
        with pytest.raises(RuntimeError, match="vector_store.url"):
            create_vector_store(c, 8, device="cpu")
    for over, item in (({"name": "weaviate"}, "not a bundled store"),
                       ({"index_type": "ivf"}, "A.18"),
                       ({"tiered": True}, "A.18")):
        c = dataclasses.replace(cfg, vector_store=dataclasses.replace(
            cfg.vector_store, **over))
        with pytest.raises(ValueError, match=item):
            create_vector_store(c, 8, device="cpu")
    # persist_dir is ported: the config is accepted and the factory hands
    # the directory to the store it builds.
    c = dataclasses.replace(cfg, vector_store=dataclasses.replace(
        cfg.vector_store, name="tpu", persist_dir="/x"))
    assert create_vector_store(c, 8, device="cpu").persist_dir is None
    store = create_vector_store(c, 8, device="cpu",
                                persist_dir=str(tmp_path))
    assert isinstance(store, DeviceVectorStore)
    assert store.persist_dir == str(tmp_path)


def test_splitter_and_documents_match_jax(tmp_path):
    text = " ".join(f"word{i}, stop. " for i in range(700))
    for size, overlap in ((508, 200), (10, 4)):
        assert tsplit.TokenTextSplitter(size, overlap).split(text) == \
            jsplit.TokenTextSplitter(size, overlap).split(text)
    assert tsplit.ApproxTokenizer().encode(text) == \
        jsplit.ApproxTokenizer().encode(text)
    pdf = (b"%PDF-1.4\n1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\nendobj\n"
           b"2 0 obj\n<< /Type /Pages /Kids [3 0 R 5 0 R] /Count 2 >>\n"
           b"endobj\n")
    for num, text in ((3, b"first page"), (5, b"second page")):
        content = zlib.compress(b"BT /F1 12 Tf 72 720 Td (" + text
                                + b") Tj ET")
        pdf += (b"%d 0 obj\n<< /Type /Page /Parent 2 0 R /Contents %d 0 R "
                b">>\nendobj\n%d 0 obj\n<< /Length %d /Filter /FlateDecode "
                b">>\nstream\n" % (num, num + 1, num + 1, len(content))
                + content + b"\nendstream\nendobj\n")
    pdf += b"trailer\n<< /Root 1 0 R >>\n%%EOF"
    for name, body in (("a.txt", "plain text\n"), ("b.json", '{"k": [1]}'),
                       ("c.md", "# md"), ("d.pdf", pdf),
                       ("e.bin", "x")):
        p = tmp_path / name
        if isinstance(body, bytes):
            p.write_bytes(body)
        else:
            p.write_text(body)
        got = tdocs.load_document(str(p))
        want = jdocs.load_document(str(p))
        assert [(d.text, d.metadata) for d in got] == \
            [(d.text, d.metadata) for d in want]
        if name == "d.pdf":  # PDF is ported: one document a page
            assert [(d.text, d.metadata["page"]) for d in got] == [
                ("first page", 0), ("second page", 1)]


class _SeededEmbedder:
    """Unit vectors drawn from a generator seeded by the text's CRC: no
    exact score ties (the hash embedder's bag-of-words vectors tie, and
    torch and JAX break top-k ties differently)."""

    dim = 64

    def embed_documents(self, texts):
        out = np.stack([np.random.default_rng(zlib.crc32(t.encode()))
                        .standard_normal(self.dim) for t in texts])
        return (out / np.linalg.norm(out, axis=1, keepdims=True)).astype(
            np.float32)

    def embed_query(self, text):
        return self.embed_documents([text])[0]

    def embed_queries(self, texts):
        return self.embed_documents(texts)


def test_retriever_matches_jax():
    texts = ["TPUs are matrix accelerators built by Google.",
             "The MXU is a systolic array for matrix multiplication.",
             "Bananas are yellow and rich in potassium.",
             "Apples can be red, green, or yellow.",
             "HBM feeds the matrix units at high bandwidth."]
    emb = _SeededEmbedder()
    vecs = emb.embed_documents(texts)
    metas = [{"filename": f"f{i}.txt"} for i in range(len(texts))]
    tstore = DeviceVectorStore(64, device="cpu")
    jstore = JDevice(64)
    tstore.add(texts, vecs, metas)
    jstore.add(texts, vecs, metas)
    for kw in (dict(top_k=2, score_threshold=0.3),
               dict(top_k=4, max_context_tokens=12),
               dict(top_k=3, reranker=OverlapReranker(),
                    default_hybrid=True)):
        t = tret.Retriever(tstore, emb, **kw)
        j = jret.Retriever(jstore, emb, **kw)
        for q in ("matrix units", "yellow fruit", "zzz"):
            _same(t.retrieve_default(q), j.retrieve_default(q))
            assert t.context(q) == j.context(q)
        for g, w in zip(t.retrieve_batch(["matrix", "apples"]),
                        j.retrieve_batch(["matrix", "apples"])):
            _same(g, w)
        for variants in (["matrix"], ["matrix", "apples", "yellow"]):
            _same(t.retrieve_multi(variants), j.retrieve_multi(variants))
    bm_t, bm_j = tret.BM25Lexical(), jret.BM25Lexical()
    bm_t.fit(texts)
    bm_j.fit(texts)
    np.testing.assert_array_equal(bm_t.scores("yellow matrix"),
                                  bm_j.scores("yellow matrix"))
    assert tret.Retriever(tstore, emb).retrieve_multi([]) == []
