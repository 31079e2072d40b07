"""Multimodal document pipeline (reference: examples/multimodal_rag —
pdfplumber layout + OCR + Neva chart detection + DePlot chart->table,
~1000 LoC across chains.py / custom_pdf_parser.py / vectorstore_updater).

The port's copy of generativeaiexamples_tpu/pipelines/multimodal.py.

Structure kept, engines swapped for what this environment provides:
- text: utils.pdf pure-Python extractor (pdfplumber role)
- tables: PDF layout analysis — positioned text runs clustered into
  row/column grids (utils.layout, the pdfplumber-table role); plain-text
  inputs fall back to the whitespace-column heuristic.
- PPTX: parsed natively from DrawingML XML (utils.pptx) — slide text,
  explicit a:tbl tables, speaker notes, embedded images. The reference
  shells out to LibreOffice for a PPT->PDF->images detour
  (custom_powerpoint_parser.py:25-46); native parsing keeps tables as
  tables instead of rasterizing them.
- images (PDF-embedded or PPTX media): each runs through the VLM
  connector when configured — chart? -> chart_to_table (DePlot role),
  else a description (Neva role). No VLM -> images are skipped, text and
  tables still ingest (graceful degradation, reference behavior when its
  VLM endpoints are down).
- chunks carry a `content_type` tag ({text|table|image}) like the
  reference's Milvus schema (retriever/vector.py:45-80), surfaced in the
  RAG context header and filterable in document_search.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Generator, List, Tuple

from generativeaiexamples_tpu_torch.pipelines.base import register_example
from generativeaiexamples_tpu_torch.pipelines.developer_rag import QAChatbot
from generativeaiexamples_tpu_torch.rag.splitter import RecursiveCharacterSplitter

_LOG = logging.getLogger(__name__)

_TABLE_ROW = re.compile(r"\S+(?:\s{2,}\S+){2,}")  # >=3 columns


def enrich_image(vlm, data: bytes, fmt: str) -> str:
    """One image through the VLM seam: chart -> linearized table
    (DePlot role), else description (Neva role). Shared by the PDF and
    PPTX ingest paths so the behavior can't drift."""
    if vlm.is_chart(data, fmt):
        return "Chart data table:\n" + vlm.chart_to_table(data, fmt)
    return vlm.describe(data, "Describe this image in detail.", fmt)


def find_tables(text: str) -> List[str]:
    """Consecutive multi-column lines -> table blocks."""
    tables, cur = [], []
    for line in text.splitlines():
        if _TABLE_ROW.fullmatch(line.strip()):
            cur.append(line.rstrip())
        else:
            if len(cur) >= 3:
                tables.append("\n".join(cur))
            cur = []
    if len(cur) >= 3:
        tables.append("\n".join(cur))
    return tables


@register_example("multimodal")
class MultimodalRAG(QAChatbot):
    def _vlm(self):
        if "vlm" not in self.res.extras:
            from generativeaiexamples_tpu_torch.connectors.vlm import make_vlm

            self.res.extras["vlm"] = make_vlm(self.res.config)
        return self.res.extras["vlm"]

    def ingest_docs(self, filepath: str, filename: str) -> None:
        lower = filepath.lower()
        chunks: List[str] = []
        metas: List[Dict] = []
        if lower.endswith((".pptx", ".ppt")):
            self._ingest_pptx(filepath, filename, chunks, metas)
        else:
            self._ingest_document(filepath, filename, chunks, metas)
        if not chunks:
            raise ValueError(f"no extractable content in {filename}")
        embs = self.res.embedder.embed_documents(chunks)
        self.res.store.add(chunks, embs, metas)
        _LOG.info("multimodal ingested %s: %d chunks (%d tables, %d images)",
                  filename, len(chunks),
                  sum(m["content_type"] == "table" for m in metas),
                  sum(m["content_type"] == "image" for m in metas))

    def _ingest_document(self, filepath: str, filename: str,
                         chunks: List[str], metas: List[Dict]) -> None:
        splitter = RecursiveCharacterSplitter(1000, 100)  # multimodal split
        parsed = None
        if filepath.lower().endswith(".pdf"):
            # ONE parse serves text + layout tables + images (the
            # per-view functions each re-scan the whole file).
            from generativeaiexamples_tpu_torch.utils.pdf import ParsedPDF

            parsed = ParsedPDF(filepath)
            full_text = parsed.text()
        else:
            from generativeaiexamples_tpu_torch.rag.documents import load_document

            docs = load_document(filepath, filename)
            full_text = "\n".join(d.text for d in docs)
        for c in splitter.split(full_text):
            chunks.append(c)
            metas.append({"filename": filename, "content_type": "text"})
        for t in self._document_tables(parsed, full_text):
            chunks.append(t)
            metas.append({"filename": filename, "content_type": "table"})
        if parsed is not None:
            self._ingest_pdf_images(parsed, filename, chunks, metas)

    def _document_tables(self, parsed, full_text: str) -> List[str]:
        """Layout-analysis tables for PDFs (positioned runs -> grids);
        whitespace heuristic for everything else."""
        if parsed is not None:
            from generativeaiexamples_tpu_torch.utils import layout

            try:
                return layout.page_tables_as_text(parsed.words())
            except Exception:
                _LOG.exception("layout analysis failed for %s; falling "
                               "back to text heuristic", parsed.path)
        return find_tables(full_text)

    def _ingest_pptx(self, filepath: str, filename: str,
                     chunks: List[str], metas: List[Dict]) -> None:
        """Native PPTX ingestion (reference detours through LibreOffice,
        custom_powerpoint_parser.py:25-46)."""
        from generativeaiexamples_tpu_torch.utils.layout import table_to_text
        from generativeaiexamples_tpu_torch.utils.pptx import parse_pptx

        splitter = RecursiveCharacterSplitter(1000, 100)
        slides = parse_pptx(filepath)
        vlm = self._vlm()
        skipped_images = 0
        for slide in slides:
            base = {"filename": filename, "slide": slide.number}
            text = slide.all_text()
            if slide.notes:
                text = f"{text}\nSpeaker notes: {slide.notes}".strip()
            for c in splitter.split(text):
                chunks.append(c)
                metas.append({**base, "content_type": "text"})
            for grid in slide.tables:
                chunks.append(table_to_text(grid))
                metas.append({**base, "content_type": "table"})
            for i, (name, data) in enumerate(slide.images):
                if vlm is None:
                    skipped_images += 1
                    continue
                fmt = name.rsplit(".", 1)[-1].lower()
                try:
                    desc = enrich_image(vlm, data, fmt)
                except Exception:
                    _LOG.exception("VLM enrichment failed for %s on "
                                   "slide %d", name, slide.number)
                    continue
                chunks.append(desc)
                metas.append({**base, "content_type": "image",
                              "image_index": i})
        if skipped_images:
            _LOG.warning("%s has %d slide images but no VLM endpoint "
                         "configured; skipping image enrichment",
                         filename, skipped_images)

    def _ingest_pdf_images(self, parsed, filename: str,
                           chunks: List[str], metas: List[Dict]) -> None:
        vlm = self._vlm()
        images = parsed.images()
        if images and vlm is None:
            _LOG.warning("%s has %d images but no VLM endpoint configured "
                         "(vlm.server_url); skipping image enrichment",
                         filename, len(images))
            return
        for i, (fmt, data) in enumerate(images):
            try:
                desc = enrich_image(vlm, data, fmt)
            except Exception:
                _LOG.exception("VLM enrichment failed for image %d of %s",
                               i, filename)
                continue
            chunks.append(desc)
            metas.append({"filename": filename, "content_type": "image",
                          "image_index": i})

    def document_search(self, content: str, num_docs: int,
                        content_type: str = "") -> List[Dict]:
        """Search with an optional content_type filter (text|table|image)
        — the reference filters on its Milvus content-type field
        (retriever/vector.py:95-120)."""
        def fetch(k: int) -> List[Dict]:
            results = self.res.retriever.retrieve(content, top_k=k,
                                                  with_threshold=False)
            out = []
            for r in results:
                if content_type and \
                        r.metadata.get("content_type") != content_type:
                    continue
                out.append({"content": r.text,
                            "filename": r.metadata.get("filename", ""),
                            "content_type": r.metadata.get("content_type",
                                                           ""),
                            "score": r.score})
                if len(out) >= num_docs:
                    break
            return out

        if not content_type:
            return fetch(num_docs)
        first_k = num_docs * 4
        out = fetch(first_k)
        if len(out) < num_docs and first_k < len(self.res.store):
            # The wanted type may rank below the over-fetch horizon
            # (e.g. 5 tables among hundreds of text chunks): widen to
            # the whole store rather than report a false empty. Skipped
            # when the first fetch already spanned the store — there is
            # nothing more to find.
            out = fetch(len(self.res.store))
        return out

    def rag_chain(self, query: str, chat_history, **llm_settings
                  ) -> Generator[str, None, None]:
        query, results = self.retrieve_with_augmentation(query, chat_history)
        if not results:
            yield ("No response generated from LLM, make sure your query is "
                   "relevant to the ingested document.")
            return
        results = self.res.retriever.limit_tokens(results)
        parts = []
        for r in results:
            tag = r.metadata.get("content_type", "text")
            parts.append(f"[{tag}] {r.text}")
        context = "\n\n".join(parts)
        system = self.res.config.prompts.rag_template.format(context=context)
        messages = [{"role": "system", "content": system},
                    {"role": "user", "content": query}]
        yield from self.answer_with_fact_check(
            query, context,
            self.res.llm.stream_chat(messages, **llm_settings))
