"""Ingest helpers: HTML to text without bs4.

The port's copy of `html_to_text` from
generativeaiexamples_tpu/ingest/pipeline.py (standard library only),
which `rag/documents.py` uses where bs4 is not installed, as on the
card's machine. The rest of the JAX ingest pipeline (sources, the
chunk / embed / store stages) is not ported yet (ROADMAP A.23).
"""

from __future__ import annotations

import html.parser
from typing import List


class _TextFromHTML(html.parser.HTMLParser):
    """Visible text of a page: scripts, styles, noscript and head
    dropped."""

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
