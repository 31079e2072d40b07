"""Minimal pure-Python PDF text extraction.

The port's copy of generativeaiexamples_tpu/utils/pdf.py (standard
library and zlib only). It handles the common machine-generated PDF
shape:

- classic xref tables AND xref streams (PDF 1.5+), object streams
- FlateDecode content streams (zlib)
- text operators Tj / TJ / ' / " inside BT..ET, with () string escapes
  and <> hex strings
- page ordering via the page tree

It does NOT do layout analysis, OCR, or encrypted PDFs — those degrade
to empty text with a warning.
"""

from __future__ import annotations

import logging
import re
import zlib
from typing import Dict, List, Optional, Tuple

_LOG = logging.getLogger(__name__)

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj")
_STREAM_RE = re.compile(rb"stream\r?\n")


class _PDF:
    def __init__(self, data: bytes):
        self.data = data
        self.objects: Dict[int, bytes] = {}
        self._scan_objects()

    def _scan_objects(self) -> None:
        """Brute scan for `N G obj ... endobj` — robust to broken xrefs."""
        for m in _OBJ_RE.finditer(self.data):
            start = m.end()
            end = self.data.find(b"endobj", start)
            if end < 0:
                continue
            self.objects[int(m.group(1))] = self.data[start:end]
        self._expand_object_streams()

    def _expand_object_streams(self) -> None:
        """Objects stored inside /Type/ObjStm compressed streams."""
        for num in list(self.objects):
            body = self.objects[num]
            if b"/ObjStm" not in body:
                continue
            payload = self._stream_payload(body)
            if payload is None:
                continue
            n = self._int_key(body, b"/N")
            first = self._int_key(body, b"/First")
            if n is None or first is None:
                continue
            header = payload[:first].split()
            try:
                pairs = [(int(header[i]), int(header[i + 1]))
                         for i in range(0, 2 * n, 2)]
            except (ValueError, IndexError):
                continue
            for i, (onum, off) in enumerate(pairs):
                end = pairs[i + 1][1] if i + 1 < len(pairs) else len(payload) - first
                self.objects.setdefault(onum, payload[first + off: first + end])

    @staticmethod
    def _int_key(body: bytes, key: bytes) -> Optional[int]:
        m = re.search(re.escape(key) + rb"\s+(\d+)", body)
        return int(m.group(1)) if m else None

    def _stream_payload(self, body: bytes) -> Optional[bytes]:
        m = _STREAM_RE.search(body)
        if not m:
            return None
        raw = body[m.end():]
        end = raw.rfind(b"endstream")
        if end >= 0:
            raw = raw[:end].rstrip(b"\r\n")
        if b"/FlateDecode" in body[:m.start()]:
            try:
                return zlib.decompress(raw)
            except zlib.error:
                try:  # some writers pad; try raw deflate
                    return zlib.decompressobj().decompress(raw)
                except zlib.error:
                    return None
        return raw

    # -- page tree ---------------------------------------------------------

    def _ref(self, body: bytes, key: bytes) -> List[int]:
        m = re.search(re.escape(key) + rb"\s*\[?((?:\s*\d+\s+\d+\s+R)+)", body)
        if not m:
            return []
        return [int(x) for x in re.findall(rb"(\d+)\s+\d+\s+R", m.group(1))]

    def page_content_streams(self) -> List[bytes]:
        pages = [num for num, b in self.objects.items()
                 if re.search(rb"/Type\s*/Page\b(?!s)", b)]
        # order via the page tree when possible
        ordered: List[int] = []
        roots = [num for num, b in self.objects.items()
                 if b.find(b"/Type") >= 0 and b.find(b"/Pages") >= 0
                 and b.find(b"/Kids") >= 0]

        def walk(num: int, seen) -> None:
            if num in seen:
                return
            seen.add(num)
            body = self.objects.get(num, b"")
            if re.search(rb"/Type\s*/Page\b(?!s)", body):
                ordered.append(num)
                return
            for kid in self._ref(body, b"/Kids"):
                walk(kid, seen)

        seen: set = set()
        for r in roots:
            walk(r, seen)
        page_nums = ordered or sorted(pages)
        streams = []
        for p in page_nums:
            body = self.objects.get(p, b"")
            for c in self._ref(body, b"/Contents"):
                cbody = self.objects.get(c)
                if cbody is None:
                    continue
                payload = self._stream_payload(cbody)
                if payload:
                    streams.append(payload)
        return streams


_TEXT_OP = re.compile(
    rb"\((?P<str>(?:\\.|[^\\()])*)\)\s*(?:Tj|')|"
    rb"\[(?P<arr>(?:\\.|[^\]])*)\]\s*TJ|"
    rb"<(?P<hex>[0-9A-Fa-f\s]+)>\s*Tj", re.S)
_ESC = {b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b", b"f": b"\f",
        b"(": b"(", b")": b")", b"\\": b"\\"}


def _unescape(s: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(s):
        c = s[i:i + 1]
        if c == b"\\" and i + 1 < len(s):
            nxt = s[i + 1:i + 2]
            if nxt.isdigit():  # octal escape
                j = i + 1
                while j < min(i + 4, len(s)) and s[j:j + 1].isdigit():
                    j += 1
                out.append(int(s[i + 1:j], 8) & 0xFF)
                i = j
                continue
            out += _ESC.get(nxt, nxt)
            i += 2
            continue
        out += c
        i += 1
    return bytes(out)


def _stream_text(payload: bytes) -> str:
    parts: List[str] = []
    for m in _TEXT_OP.finditer(payload):
        if m.group("str") is not None:
            parts.append(_unescape(m.group("str")).decode("latin-1"))
        elif m.group("arr") is not None:
            for sm in re.finditer(rb"\((?:\\.|[^\\()])*\)", m.group("arr")):
                parts.append(_unescape(sm.group(0)[1:-1]).decode("latin-1"))
        elif m.group("hex") is not None:
            hx = re.sub(rb"\s", b"", m.group("hex"))
            try:
                raw = bytes.fromhex(hx.decode())
                # UTF-16BE if BOM, else latin-1
                parts.append(raw.decode("utf-16-be") if raw[:2] == b"\xfe\xff"
                             else raw.decode("latin-1"))
            except (ValueError, UnicodeDecodeError):
                continue
    text = "".join(parts)
    return text


def extract_images(path: str) -> List[Tuple[str, bytes]]:
    """Embedded raster images as (format, bytes). JPEG (/DCTDecode)
    streams carry their own container; other encodings are skipped (no
    imaging libs in the environment to re-encode raw pixel data)."""
    with open(path, "rb") as fh:
        data = fh.read()
    return _images_from(_PDF(data))


def _images_from(pdf: "_PDF") -> List[Tuple[str, bytes]]:
    out: List[Tuple[str, bytes]] = []
    for body in pdf.objects.values():
        if b"/Subtype" not in body or b"/Image" not in body:
            continue
        m = _STREAM_RE.search(body)
        if not m:
            continue
        raw = body[m.end():]
        end = raw.rfind(b"endstream")
        if end >= 0:
            raw = raw[:end].rstrip(b"\r\n")
        if b"/DCTDecode" in body[:m.start()]:
            out.append(("jpeg", raw))
    return out


def extract_text(path: str) -> str:
    """Whole-document text, pages separated by form feeds."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(b"%PDF"):
        raise ValueError(f"{path} is not a PDF")
    if b"/Encrypt" in data[:4096] or b"/Encrypt" in data[-4096:]:
        _LOG.warning("%s is encrypted; cannot extract text", path)
        return ""
    pdf = _PDF(data)
    pages = [_stream_text(s) for s in pdf.page_content_streams()]
    return "\f".join(p for p in pages if p.strip())


# ---------------------------------------------------------------------------
# Positioned text (layout analysis input)
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    rb"\((?P<str>(?:\\.|[^\\()])*)\)|"          # literal string
    rb"\[(?P<arr>(?:\\.|[^\]])*)\]|"            # array (TJ)
    rb"<(?P<hex>[0-9A-Fa-f\s]*)>|"              # hex string
    rb"(?P<num>[-+]?\d*\.?\d+)|"                # number
    rb"(?P<op>[A-Za-z'\"*]{1,3})", re.S)


def _decode_pdf_string(raw: bytes) -> str:
    return _unescape(raw).decode("latin-1")


def _stream_words(payload: bytes) -> List[Tuple[float, float, str]]:
    """Interpret the text-positioning subset of a content stream:
    Tm/Td/TD/TL/T* cursor ops and Tj/TJ/'/\" show ops. Returns text runs
    with their line-start coordinates — the input for layout analysis
    (pdfplumber's `words` role). Rotation/scaling in Tm is ignored
    beyond the translation (machine-generated report PDFs are axis-
    aligned; anything else degrades to unpositioned text elsewhere)."""
    words: List[Tuple[float, float, str]] = []
    nums: List[float] = []
    strings: List[str] = []
    x = y = 0.0
    lx = ly = 0.0  # line matrix origin
    leading = 12.0

    def show(text: str) -> None:
        if text:
            words.append((x, y, text))

    for m in _TOKEN.finditer(payload):
        if m.group("str") is not None:
            strings.append(_decode_pdf_string(m.group("str")))
        elif m.group("arr") is not None:
            parts = [
                _decode_pdf_string(sm.group(0)[1:-1])
                for sm in re.finditer(rb"\((?:\\.|[^\\()])*\)",
                                      m.group("arr"))
            ]
            strings.append("".join(parts))
        elif m.group("hex") is not None:
            hx = re.sub(rb"\s", b"", m.group("hex"))
            try:
                raw = bytes.fromhex(hx.decode())
                strings.append(raw.decode("utf-16-be")
                               if raw[:2] == b"\xfe\xff"
                               else raw.decode("latin-1"))
            except (ValueError, UnicodeDecodeError):
                strings.append("")
        elif m.group("num") is not None:
            nums.append(float(m.group("num")))
            continue  # operands accumulate until an operator
        else:
            op = m.group("op")
            if op == b"BT":
                x = y = lx = ly = 0.0
            elif op == b"Tm" and len(nums) >= 6:
                lx, ly = nums[-2], nums[-1]
                x, y = lx, ly
            elif op in (b"Td", b"TD") and len(nums) >= 2:
                lx += nums[-2]
                ly += nums[-1]
                x, y = lx, ly
                if op == b"TD":
                    leading = -nums[-1] or leading
            elif op == b"TL" and nums:
                leading = nums[-1]
            elif op == b"T*":
                ly -= leading
                x, y = lx, ly
            elif op == b"Tj" and strings:
                show(strings[-1])
            elif op == b"TJ" and strings:
                show(strings[-1])
            elif op == b"'" and strings:
                ly -= leading
                x, y = lx, ly
                show(strings[-1])
            elif op == b'"' and strings:
                ly -= leading
                x, y = lx, ly
                show(strings[-1])
            nums.clear()
            strings.clear()
    return words


def extract_words(path: str) -> List[List[Tuple[float, float, str]]]:
    """Per-page positioned text runs [(x, y, text), ...] for layout
    analysis (the pdfplumber-words role in the reference's
    custom_pdf_parser.py table/paragraph grouping)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(b"%PDF"):
        raise ValueError(f"{path} is not a PDF")
    pdf = _PDF(data)
    return [_stream_words(s) for s in pdf.page_content_streams()]


class ParsedPDF:
    """One parse, all views: the multimodal pipeline needs text, words
    AND images from the same file; the function-per-view API re-scanned
    and re-decompressed every stream per call (3x ingest cost)."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        if not data.startswith(b"%PDF"):
            raise ValueError(f"{path} is not a PDF")
        self.path = path
        self.encrypted = (b"/Encrypt" in data[:4096]
                          or b"/Encrypt" in data[-4096:])
        self._pdf = None if self.encrypted else _PDF(data)
        self._streams = (self._pdf.page_content_streams()
                         if self._pdf else [])

    def text(self) -> str:
        if self.encrypted:
            _LOG.warning("%s is encrypted; cannot extract text", self.path)
            return ""
        pages = [_stream_text(s) for s in self._streams]
        return "\f".join(p for p in pages if p.strip())

    def words(self) -> List[List[Tuple[float, float, str]]]:
        return [_stream_words(s) for s in self._streams]

    def images(self) -> List[Tuple[str, bytes]]:
        if self._pdf is None:
            return []
        return _images_from(self._pdf)
