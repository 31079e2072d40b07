"""Document loading: file -> text (+ metadata), by extension.

The port's copy of generativeaiexamples_tpu/rag/documents.py for the
plain-text extensions and `.json`. PDF (the JAX package's pure-Python
extractor, utils/pdf.py) and HTML (bs4, which the card's machine lacks)
are not ported (ROADMAP A.11): such files are logged as unsupported and
yield nothing, as any unsupported type does.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List

_LOG = logging.getLogger(__name__)

TEXT_EXTS = {".txt", ".md", ".rst", ".py", ".log", ".yaml", ".yml", ".cfg",
             ".ini", ".toml", ".csv", ".tsv"}


@dataclass
class Document:
    text: str
    metadata: Dict = field(default_factory=dict)


def load_document(path: str, filename: str = "") -> List[Document]:
    """One file -> list of documents (metadata carries filename and
    source)."""
    name = filename or os.path.basename(path)
    ext = os.path.splitext(name)[1].lower()
    meta = {"filename": name, "source": path}
    try:
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
