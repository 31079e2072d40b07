"""Document loading: file -> text (+ metadata), by extension.

The port's copy of generativeaiexamples_tpu/rag/documents.py:

  .pdf        utils/pdf.py (pure Python): one document per non-empty
              page, its index in `page`
  .html/.htm  bs4's text with scripts and styles removed, as the JAX
              package does; where bs4 is not installed (the card's
              machine), `ingest.pipeline.html_to_text`, the JAX ingest
              pipeline's standard-library parser; each load logs which
  .json       pretty-printed text
  .md/.txt/.py/.rst/.csv/...   plain text

Any other type is logged as unsupported and yields nothing.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List

from generativeaiexamples_tpu_torch.ingest.pipeline import html_to_text
from generativeaiexamples_tpu_torch.utils import pdf

_LOG = logging.getLogger(__name__)

TEXT_EXTS = {".txt", ".md", ".rst", ".py", ".log", ".yaml", ".yml", ".cfg",
             ".ini", ".toml", ".csv", ".tsv"}


@dataclass
class Document:
    text: str
    metadata: Dict = field(default_factory=dict)


def _html_text(markup: str, name: str) -> str:
    """bs4's text of a page (scripts and styles removed), or the standard
    library parser's where bs4 is not installed; logs which."""
    if importlib.util.find_spec("bs4") is None:
        _LOG.info("%s: HTML read with html_to_text (no bs4)", name)
        return html_to_text(markup)
    from bs4 import BeautifulSoup

    _LOG.info("%s: HTML read with bs4", name)
    soup = BeautifulSoup(markup, "html.parser")
    for tag in soup(["script", "style"]):
        tag.decompose()
    return soup.get_text(separator="\n")


def load_document(path: str, filename: str = "") -> List[Document]:
    """One file -> list of documents (metadata carries filename and
    source, and a PDF page's index)."""
    name = filename or os.path.basename(path)
    ext = os.path.splitext(name)[1].lower()
    meta = {"filename": name, "source": path}
    try:
        if ext == ".pdf":
            pages = pdf.extract_text(path).split("\f")
            return [Document(p, {**meta, "page": i})
                    for i, p in enumerate(pages) if p.strip()]
        if ext in (".html", ".htm"):
            with open(path, "r", encoding="utf-8", errors="replace") as fh:
                return [Document(_html_text(fh.read(), name), meta)]
        if ext == ".json":
            with open(path, "r", encoding="utf-8", errors="replace") as fh:
                return [Document(json.dumps(json.load(fh), indent=1), meta)]
        if ext in TEXT_EXTS or ext == "":
            with open(path, "r", encoding="utf-8", errors="replace") as fh:
                return [Document(fh.read(), meta)]
    except (OSError, ValueError):
        _LOG.exception("failed to load %s", path)
        return []
    _LOG.warning("unsupported file type %s (%s); skipped", ext, name)
    return []
