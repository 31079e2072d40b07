# %% [markdown]
# # 07 — Multimodal ingestion: PDFs with tables and charts, PPTX decks
#
# The reference's multimodal_rag example ingests PDFs with pdfplumber
# layout analysis, detects charts with Neva-22B and linearizes them with
# DePlot (examples/multimodal_rag/*). This framework keeps the same
# structure in the port with in-repo engines: a pure-Python PDF extractor
# (`utils.pdf`), positioned-text layout analysis for tables
# (`utils.layout`), native PPTX parsing (`utils.pptx`), and a pluggable
# VLM connector seam for chart/image enrichment.
#
# This tutorial is hermetic: it synthesizes a PDF (with a real
# FlateDecode content stream and an embedded JPEG) and a PPTX deck, and
# uses a scripted VLM. Point `vlm.server_url` at any OpenAI-compatible
# vision endpoint to swap in a real model — the pipeline code is
# identical.

# %%
import argparse
import os
import sys
import zipfile
import zlib

# __file__ is undefined inside a Jupyter kernel; fall back to cwd.
_here = (os.path.dirname(os.path.abspath(__file__))
         if "__file__" in globals() else os.getcwd())
sys.path.insert(0, os.path.abspath(os.path.join(_here, "..", "..", "..")))

from generativeaiexamples_tpu_torch.device import resolve_device

# The card unless `--device cpu`; without CUDA that raises (no fallback).
# parse_known_args lets a notebook kernel's own argv pass through.
_ap = argparse.ArgumentParser()
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
DEVICE = resolve_device(_ap.parse_known_args()[0].device)

import tempfile

workdir = tempfile.mkdtemp(prefix="gaie07_")

# %% [markdown]
# ## Synthesize a "quarterly report" PDF
# A heading, a positioned 4x3 table (layout analysis will recover the
# grid from text run coordinates), prose, and an embedded chart JPEG.

# %%
rows = [("Quarter", "Revenue", "Margin"), ("Q1", "1.2M", "31%"),
        ("Q2", "1.5M", "33%"), ("Q3", "1.9M", "35%")]
ops = [b"BT", b"1 0 0 1 72 720 Tm (Quarterly revenue report) Tj"]
y = 660
for row in rows:
    for x, cell in zip((72, 220, 340), row):
        ops.append(f"1 0 0 1 {x} {y} Tm ({cell}) Tj".encode())
    y -= 20
ops.append(b"1 0 0 1 72 560 Tm "
           b"(The chart below shows regional growth trends.) Tj")
ops.append(b"ET")
content = zlib.compress(b"\n".join(ops))
jpeg = b"\xff\xd8\xff\xe0FAKECHART\xff\xd9"
pdf_bytes = (
    b"%PDF-1.4\n"
    b"1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\nendobj\n"
    b"2 0 obj\n<< /Type /Pages /Kids [3 0 R] /Count 1 >>\nendobj\n"
    b"3 0 obj\n<< /Type /Page /Parent 2 0 R /Contents 4 0 R >>\nendobj\n"
    b"4 0 obj\n<< /Length " + str(len(content)).encode() +
    b" /Filter /FlateDecode >>\nstream\n" + content +
    b"\nendstream\nendobj\n"
    b"5 0 obj\n<< /Subtype /Image /Filter /DCTDecode /Width 2 /Height 2 "
    b"/Length " + str(len(jpeg)).encode() +
    b" >>\nstream\n" + jpeg + b"\nendstream\nendobj\n"
    b"trailer\n<< /Root 1 0 R >>\n%%EOF")
pdf_path = os.path.join(workdir, "report.pdf")
with open(pdf_path, "wb") as fh:
    fh.write(pdf_bytes)
print(f"wrote {pdf_path} ({len(pdf_bytes)} bytes)")

# %% [markdown]
# ## What the extractors see
# `utils.pdf` recovers positioned words; `utils.layout` clusters them
# into a row/column grid — the pdfplumber-table role, from scratch.

# %%
from generativeaiexamples_tpu_torch.utils import layout, pdf

pages = pdf.extract_words(pdf_path)
tables = layout.detect_tables(pages[0])
print("page 1 words:", len(pages[0]), "tables:", len(tables))
print(layout.table_to_text(tables[0]))
assert "Q3" in layout.table_to_text(tables[0])

# %% [markdown]
# ## A PPTX deck, parsed natively
# The reference shells out to LibreOffice to rasterize slides; here the
# DrawingML XML is parsed directly so tables stay tables.

# %%
SLIDE = """<?xml version="1.0"?>
<p:sld xmlns:p="http://schemas.openxmlformats.org/presentationml/2006/main"
       xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main"
       xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
 <p:cSld><p:spTree>
  <p:sp><p:txBody>
    <a:p><a:r><a:t>GPU serving overview</a:t></a:r></a:p>
    <a:p><a:r><a:t>Paged attention streams KV pages.</a:t></a:r></a:p>
  </p:txBody></p:sp>
  <p:graphicFrame><a:graphic><a:graphicData><a:tbl>
    <a:tr><a:tc><a:txBody><a:p><a:r><a:t>Chip</a:t></a:r></a:p></a:txBody></a:tc>
          <a:tc><a:txBody><a:p><a:r><a:t>HBM</a:t></a:r></a:p></a:txBody></a:tc></a:tr>
    <a:tr><a:tc><a:txBody><a:p><a:r><a:t>H100</a:t></a:r></a:p></a:txBody></a:tc>
          <a:tc><a:txBody><a:p><a:r><a:t>80 GB</a:t></a:r></a:p></a:txBody></a:tc></a:tr>
  </a:tbl></a:graphicData></a:graphic></p:graphicFrame>
  <p:pic><p:blipFill><a:blip r:embed="rId2"/></p:blipFill></p:pic>
 </p:spTree></p:cSld>
</p:sld>"""
RELS = """<?xml version="1.0"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
 <Relationship Id="rId2"
   Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/image"
   Target="../media/image1.jpeg"/>
</Relationships>"""
pptx_path = os.path.join(workdir, "deck.pptx")
with zipfile.ZipFile(pptx_path, "w") as zf:
    zf.writestr("ppt/slides/slide1.xml", SLIDE)
    zf.writestr("ppt/slides/_rels/slide1.xml.rels", RELS)
    zf.writestr("ppt/media/image1.jpeg",
                b"\xff\xd8\xff\xe0FAKESLIDECHART\xff\xd9")

from generativeaiexamples_tpu_torch.utils.pptx import parse_pptx

slides = parse_pptx(pptx_path)
print(f"slide 1: {len(slides[0].tables)} table(s), "
      f"{len(slides[0].images)} image(s)")

# %% [markdown]
# ## The VLM seam
# Charts become linearized tables (DePlot role); other images become
# descriptions (Neva role). A scripted VLM keeps this hermetic — set
# `APP_VLM_SERVERURL` for a real endpoint (connectors/vlm.py).


# %%
class ScriptedVLM:
    def is_chart(self, data, fmt="jpeg"):
        return b"CHART" in data

    def chart_to_table(self, data, fmt="jpeg"):
        return "Region | Growth\nEMEA | 12%\nAPAC | 18%"

    def describe(self, data, prompt, fmt="jpeg", max_tokens=512):
        return "a bar chart of regional growth"


# %% [markdown]
# ## Ingest both documents through the multimodal pipeline
# Chunks carry a `content_type` tag ({text|table|image}) mirroring the
# reference's Milvus schema field, so retrieval can filter by modality.

# %%
from generativeaiexamples_tpu_torch.config.wizard import load_config
from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
from generativeaiexamples_tpu_torch.connectors.fakes import EchoLLM, HashEmbedder
from generativeaiexamples_tpu_torch.pipelines.base import get_example_class
from generativeaiexamples_tpu_torch.pipelines.resources import Resources

cfg = load_config(path="", env={})
res = Resources(cfg, hub=EngineHub(cfg, device=DEVICE), llm=EchoLLM(),
                embedder=HashEmbedder(64), reranker=None)
example = get_example_class("multimodal")(res)
example.res.extras["vlm"] = ScriptedVLM()

example.ingest_docs(pdf_path, "report.pdf")
example.ingest_docs(pptx_path, "deck.pptx")
print("store size:", len(res.store))

# %%
# Modality-filtered retrieval: only table chunks.
hits = example.document_search("revenue by quarter", 2,
                               content_type="table")
for h in hits:
    print(f"[{h['content_type']}] {h['filename']}: "
          + h["content"].splitlines()[0])
assert all(h["content_type"] == "table" for h in hits)

# Chart images surfaced as linearized tables via the VLM seam.
img_hits = example.document_search("regional growth chart", 2,
                                   content_type="image")
assert img_hits and "Growth" in img_hits[0]["content"]
print("chart-as-table:", img_hits[0]["content"].splitlines()[0])

# %%
# End-to-end RAG answer over the multimodal corpus (echo LLM shows the
# prompt assembly; a real engine slots in via config).
out = "".join(example.rag_chain("What was Q3 revenue?", []))
print(out[:200])
assert "Q3" in out

# %% [markdown]
# ## Where to go next
# - `APP_VLM_SERVERURL=http://...` wires a real vision endpoint.
# - `docs/support-matrix.md` lists the deployments; `chip_smoke.py`'s
#   pipelines phase drives this pipeline on the card.
# - Tutorial 06 evaluates a corpus like this one with RAGAS + judge.
