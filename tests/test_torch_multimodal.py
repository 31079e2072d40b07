"""Port parity of the multimodal pipeline and what it brings
(utils/layout.py, utils/pptx.py, connectors/vlm.py,
pipelines/multimodal.py), on the documents of
tests/test_multimodal_depth.py: layout tables from a PDF's positioned
words, PPTX slides, ingestion with a fake VLM and with a VLM served over
HTTP by a local stub (chunks, metadata and embeddings equal), the
content_type-filtered search and its widening, and the VLM client's
request bodies, byte for byte those of the JAX client.
"""

import json
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from generativeaiexamples_tpu.config.wizard import load_config as jload
from generativeaiexamples_tpu.connectors import vlm as jvlm
from generativeaiexamples_tpu.connectors.fakes import (
    EchoLLM as JEcho, HashEmbedder as JHash)
from generativeaiexamples_tpu.pipelines import multimodal as jmm
from generativeaiexamples_tpu.pipelines.base import (
    get_example_class as jget)
from generativeaiexamples_tpu.pipelines.resources import (
    Resources as JResources)
from generativeaiexamples_tpu.utils import layout as jlayout
from generativeaiexamples_tpu.utils import pdf as jpdf
from generativeaiexamples_tpu.utils import pptx as jpptx
from generativeaiexamples_tpu_torch.config.schema import load_config
from generativeaiexamples_tpu_torch.connectors import vlm as tvlm
from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
from generativeaiexamples_tpu_torch.connectors.fakes import (
    EchoLLM, HashEmbedder)
from generativeaiexamples_tpu_torch.pipelines import multimodal as tmm
from generativeaiexamples_tpu_torch.pipelines.base import (
    get_example_class as tget)
from generativeaiexamples_tpu_torch.pipelines.resources import Resources
from generativeaiexamples_tpu_torch.utils import layout as tlayout
from generativeaiexamples_tpu_torch.utils import pdf as tpdf
from generativeaiexamples_tpu_torch.utils import pptx as tpptx
from test_multimodal_depth import (  # the JAX tests' documents
    FakeVLM, _NOTES_XML, _SLIDE_RELS, _SLIDE_XML, deck_pptx, table_pdf)

RAGGED = [(72, 700, "Name"), (200, 700, "Value"), (300, 700, "Unit"),
          (72, 680, "throughput"), (200, 680, "1811"), (300, 680, "tok/s"),
          (72, 660, "ttft"), (300, 660, "ms"),
          (72, 600, "prose line alone"),
          (72, 560, "a"), (90, 560, "b"), (72, 540, "c"), (400, 540, "d"),
          (72, 520, "e"), (90, 520, "f")]


def test_layout_tables_match_jax(tmp_path):
    path = table_pdf(tmp_path)
    words = tpdf.extract_words(path)
    assert words == jpdf.extract_words(path)
    got = tlayout.page_tables_as_text(words)
    assert got == jlayout.page_tables_as_text(words)
    assert "Q2 | 1.5M | 33%" in got[0]
    assert "Quarterly revenue report" not in got[0]
    for fn in ("group_rows", "detect_tables"):
        assert getattr(tlayout, fn)(RAGGED) == getattr(jlayout, fn)(RAGGED)
    assert tlayout.detect_tables(RAGGED)[0][2] == ["ttft", "", "ms"]
    assert tlayout.detect_tables(RAGGED, min_rows=2, x_tol=20.0) == \
        jlayout.detect_tables(RAGGED, min_rows=2, x_tol=20.0)


def _reordered_deck(tmp_path):
    """Two slides whose deck order (presentation.xml) is the reverse of
    their part numbers, one target package-absolute, notes on one."""
    p = tmp_path / "reordered.pptx"
    pres = ('<?xml version="1.0"?><p:presentation xmlns:p="http://schemas.'
            'openxmlformats.org/presentationml/2006/main" xmlns:r="http://'
            'schemas.openxmlformats.org/officeDocument/2006/relationships">'
            '<p:sldIdLst><p:sldId id="256" r:id="rId2"/><p:sldId id="257" '
            'r:id="rId1"/></p:sldIdLst></p:presentation>')
    rels = ('<?xml version="1.0"?><Relationships xmlns="http://schemas.'
            'openxmlformats.org/package/2006/relationships">'
            '<Relationship Id="rId1" Target="slides/slide1.xml"/>'
            '<Relationship Id="rId2" Target="/ppt/slides/slide2.xml"/>'
            '</Relationships>')
    slide2 = _SLIDE_XML.replace("TPU serving overview", "Second part first")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("ppt/presentation.xml", pres)
        zf.writestr("ppt/_rels/presentation.xml.rels", rels)
        zf.writestr("ppt/slides/slide1.xml", _SLIDE_XML)
        zf.writestr("ppt/slides/_rels/slide1.xml.rels", _SLIDE_RELS)
        zf.writestr("ppt/slides/slide2.xml", slide2)
        zf.writestr("ppt/media/image1.jpeg", b"\xff\xd8PLAINPHOTO\xff\xd9")
        zf.writestr("ppt/notesSlides/notesSlide1.xml", _NOTES_XML)
    return str(p)


def test_parse_pptx_matches_jax(tmp_path):
    for path in (deck_pptx(tmp_path), _reordered_deck(tmp_path)):
        got = [vars(s) for s in tpptx.parse_pptx(path)]
        assert got == [vars(s) for s in jpptx.parse_pptx(path)]
    assert got[0]["texts"][0] == "Second part first" and got[0]["notes"] == ""
    assert got[1]["tables"] == [[["Chip", "HBM"], ["v5e", "16 GB"]]]
    bad = tmp_path / "old.ppt"
    bad.write_bytes(b"\xd0\xcf\x11\xe0 legacy")
    errors = []
    for mod in (tpptx, jpptx):
        with pytest.raises(ValueError) as e:
            mod.parse_pptx(str(bad))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _pair(env=None, vlm=True):
    env = dict(env or {})
    jres = JResources(jload(path="", env=env), llm=JEcho(),
                      embedder=JHash(64), reranker=None)
    tcfg = load_config(env=env)
    tres = Resources(tcfg, hub=EngineHub(tcfg, device="cpu"), llm=EchoLLM(),
                     embedder=HashEmbedder(64), reranker=None)
    if vlm:
        for res in (jres, tres):
            res.extras["vlm"] = FakeVLM()
    return jres, tres


def _store(res):
    rows = getattr(res.store, "_host_rows", None)
    return res.store.snapshot_docs(), np.asarray(
        rows() if rows else res.store._vecs)


SEARCHES = [("quarterly revenue", 2, "table"), ("regional growth chart", 2,
                                                "image"),
            ("growth trends", 2, "text"), ("growth", 3, ""),
            ("decode throughput", 1, "image"), ("nothing", 5, "audio")]


def _ingest_all(jres, tres, tmp_path):
    out = []
    for res, get in ((jres, jget), (tres, tget)):
        ex = get("multimodal")(res)
        ex.ingest_docs(table_pdf(tmp_path), "report.pdf")
        ex.ingest_docs(deck_pptx(tmp_path), "deck.pptx")
        searches = [ex.document_search(q, n, content_type=c)
                    for q, n, c in SEARCHES]
        answer = list(ex.rag_chain("Q2 revenue and margin?", []))
        out.append((_store(res), searches, answer, res.llm.calls))
    return out


def test_multimodal_ingestion_with_a_fake_vlm_matches_jax(tmp_path):
    (jstore, jsearch, jans, jcalls), (tstore, tsearch, tans, tcalls) = \
        _ingest_all(*_pair(), tmp_path)
    assert tstore[0] == jstore[0]
    np.testing.assert_array_equal(tstore[1], jstore[1])
    assert tsearch == jsearch and tans == jans and tcalls == jcalls
    kinds = {d["metadata"]["content_type"] for d in tstore[0]}
    assert kinds == {"text", "table", "image"}
    assert "Q2 | 1.5M | 33%" in tsearch[0][0]["content"]
    assert "EMEA | 12%" in tsearch[1][0]["content"]
    assert tsearch[-1] == []
    assert "[table]" in tcalls[-1][0]["content"]


def test_without_a_vlm_images_are_skipped_like_jax(tmp_path):
    (jstore, _, jans, _), (tstore, _, tans, _) = _ingest_all(
        *_pair(vlm=False), tmp_path)
    assert tstore[0] == jstore[0] and tans == jans
    assert "image" not in {d["metadata"]["content_type"] for d in tstore[0]}


def test_content_type_search_widens_past_the_over_fetch_like_jax(tmp_path):
    """Many text chunks and one table that ranks below the 4x over-fetch:
    the filtered search widens to the whole store, in both packages."""
    prose = "\n\n".join(f"Paragraph {i} talks about revenue growth and "
                        f"margin in region {i}. " * 8 for i in range(30))
    doc = (prose + "\n\nzone   alpha   beta\nnorth  1   2\nsouth  3   4\n"
           "east   5   6\n")
    sides = []
    for res, get in zip(_pair(), (jget, tget)):
        ex = get("multimodal")(res)
        p = tmp_path / "long.txt"
        p.write_text(doc)
        ex.ingest_docs(str(p), "long.txt")
        sides.append([ex.document_search("revenue growth margin", n, c)
                      for n, c in ((1, "table"), (2, "text"), (1, ""))])
    assert sides[1] == sides[0]
    assert sides[1][0] and sides[1][0][0]["content_type"] == "table"
    assert tmm.find_tables(doc) == jmm.find_tables(doc)


# -- the VLM over HTTP -----------------------------------------------------

class _StubVLM(BaseHTTPRequestHandler):
    """An OpenAI-compatible image chat endpoint: records each request's
    path, Authorization header and raw body; answers yes to the chart
    question, a table to the DePlot prompt, else a description."""

    seen: list = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        raw = self.rfile.read(int(self.headers["Content-Length"]))
        self.seen.append((self.path, self.headers.get("Authorization"),
                          self.headers.get("Content-Type"), raw))
        prompt = json.loads(raw)["messages"][0]["content"][0]["text"]
        image = json.loads(raw)["messages"][0]["content"][1]["image_url"][
            "url"]
        if prompt.startswith("Is this image a chart"):
            # FakeVLM's rule: the fake JPEGs say CHART when they are one.
            import base64
            text = "Yes." if b"CHART" in base64.b64decode(
                image.split(",", 1)[1]) else "No"
        elif prompt.startswith("Generate the underlying data table"):
            text = "Region | Growth\nEMEA | 12%"
        else:
            text = "a photo of a data center"
        body = json.dumps({"choices": [{"message": {
            "role": "assistant", "content": text}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def stub_vlm():
    handler = type("Stub", (_StubVLM,), {"seen": []})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}/v1", handler.seen
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=10)


def test_vlm_client_sends_the_jax_body(stub_vlm):
    url, seen = stub_vlm
    chart, photo = b"\xff\xd8CHART\xff\xd9", b"\x89PNG photo"
    results = []
    for mod in (jvlm, tvlm):
        seen.clear()
        c = mod.VLMClient(url + "/", model="neva-22b", api_key="k3y")
        results.append(([c.is_chart(chart), c.is_chart(photo, "png"),
                         c.chart_to_table(chart),
                         c.describe(photo, "What is it?", "png", 64)],
                        list(seen)))
    (want, jseen), (got, tseen) = results
    assert got == want == [True, False, "Region | Growth\nEMEA | 12%",
                           "a photo of a data center"]
    assert [s[:2] + (s[3],) for s in tseen] == \
        [s[:2] + (s[3],) for s in jseen]
    assert all(s[0] == "/v1/chat/completions" and s[1] == "Bearer k3y"
               and s[2] == "application/json" for s in tseen)
    assert json.loads(tseen[0][3])["max_tokens"] == 8


def test_make_vlm_follows_the_config_like_jax(stub_vlm):
    url, _ = stub_vlm
    assert tvlm.make_vlm(load_config(env={})) is None
    assert jvlm.make_vlm(jload(path="", env={})) is None
    env = {"APP_VLM_SERVERURL": url, "APP_VLM_MODELNAME": "m"}
    t, j = tvlm.make_vlm(load_config(env=env)), jvlm.make_vlm(
        jload(path="", env=env))
    assert (t.base_url, t.model, t.timeout) == (j.base_url, j.model,
                                                j.timeout)


def test_multimodal_over_an_http_vlm_matches_jax(stub_vlm, tmp_path):
    """vlm.server_url set: each package's pipeline builds its own client
    and enriches the PDF's and the deck's images through the stub."""
    url, seen = stub_vlm
    (jstore, jsearch, _, _), (tstore, tsearch, _, _) = _ingest_all(
        *_pair({"APP_VLM_SERVERURL": url}, vlm=False), tmp_path)
    assert tstore[0] == jstore[0] and tsearch == jsearch
    np.testing.assert_array_equal(tstore[1], jstore[1])
    images = [d for d in tstore[0] if d["metadata"]["content_type"] ==
              "image"]
    assert [d["text"] for d in images] == [
        "Chart data table:\nRegion | Growth\nEMEA | 12%"] * 2
    assert len(seen) == 2 * 2 * 2  # 2 packages x 2 images x 2 calls
