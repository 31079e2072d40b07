"""Minimal pure-Python PPTX extraction.

The port's copy of generativeaiexamples_tpu/utils/pptx.py.

The reference converts PPT->PDF with LibreOffice and re-parses
(custom_powerpoint_parser.py:25-46) because its PDF path is where the
layout tooling lives. Neither LibreOffice nor python-pptx ships in this
image — but PPTX is a zip of DrawingML XML, so slides parse directly
with the stdlib: text runs per shape, native a:tbl tables (no layout
inference needed — PPTX tables are explicit), speaker notes, and
embedded media via each slide's relationship file.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import zipfile
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

_LOG = logging.getLogger(__name__)

_NS = {
    "a": "http://schemas.openxmlformats.org/drawingml/2006/main",
    "p": "http://schemas.openxmlformats.org/presentationml/2006/main",
    "r": "http://schemas.openxmlformats.org/officeDocument/2006/relationships",
}
_REL_NS = "http://schemas.openxmlformats.org/package/2006/relationships"


@dataclasses.dataclass
class Slide:
    number: int
    texts: List[str]
    tables: List[List[List[str]]]  # tables -> rows -> cells
    images: List[Tuple[str, bytes]]  # (media name, payload)
    notes: str = ""

    def all_text(self) -> str:
        return "\n".join(self.texts)


def _para_text(para) -> str:
    return "".join(t.text or "" for t in para.findall(".//a:t", _NS))


def _shape_paragraphs(root) -> List[str]:
    """Paragraph strings from every text body, in document order,
    skipping paragraphs that live inside tables (handled separately)."""
    out: List[str] = []
    table_paras = {id(p) for tbl in root.findall(".//a:tbl", _NS)
                   for p in tbl.findall(".//a:p", _NS)}
    for para in root.findall(".//a:p", _NS):
        if id(para) in table_paras:
            continue
        text = _para_text(para).strip()
        if text:
            out.append(text)
    return out


def _tables(root) -> List[List[List[str]]]:
    tables: List[List[List[str]]] = []
    for tbl in root.findall(".//a:tbl", _NS):
        rows: List[List[str]] = []
        for tr in tbl.findall("a:tr", _NS):
            rows.append([" ".join(_para_text(p).strip()
                                  for p in tc.findall(".//a:p", _NS)).strip()
                         for tc in tr.findall("a:tc", _NS)])
        if rows:
            tables.append(rows)
    return tables


def _rels(zf: zipfile.ZipFile, part_path: str) -> Dict[str, str]:
    """A part's relationship map: rId -> resolved target path."""
    rels_path = (os.path.dirname(part_path) + "/_rels/"
                 + os.path.basename(part_path) + ".rels")
    out: Dict[str, str] = {}
    try:
        rels = ET.fromstring(zf.read(rels_path))
    except (KeyError, ET.ParseError):
        return out
    for rel in rels.findall(f"{{{_REL_NS}}}Relationship"):
        target = rel.get("Target", "")
        if target.startswith("/"):
            # OPC package-absolute target: resolve from the zip root
            # (zip members carry no leading slash).
            resolved = target.lstrip("/")
        else:
            resolved = os.path.normpath(
                os.path.join(os.path.dirname(part_path), target))
        out[rel.get("Id", "")] = resolved
    return out


def _slide_images(zf: zipfile.ZipFile, rel_map: Dict[str, str],
                  root) -> List[Tuple[str, bytes]]:
    """Resolve r:embed ids through the slide's rels to media payloads."""
    images: List[Tuple[str, bytes]] = []
    for blip in root.findall(".//a:blip", _NS):
        rid = blip.get(f"{{{_NS['r']}}}embed", "")
        path = rel_map.get(rid)
        if not path or "media" not in path:
            continue
        try:
            images.append((os.path.basename(path), zf.read(path)))
        except KeyError:
            _LOG.warning("pptx image %s missing from archive", path)
    return images


def _notes(zf: zipfile.ZipFile, rel_map: Dict[str, str]) -> str:
    """Speaker notes via the slide's OPC relationship — part numbers do
    NOT correspond (a deck where only slide 3 has notes stores them as
    notesSlide1.xml, linked from slide3.xml.rels)."""
    path = next((t for t in rel_map.values() if "notesSlide" in t), None)
    if not path:
        return ""
    try:
        root = ET.fromstring(zf.read(path))
    except (KeyError, ET.ParseError):
        return ""
    return "\n".join(p for p in (_para_text(para).strip()
                                 for para in root.findall(".//a:p", _NS)) if p)


def _presentation_order(zf: zipfile.ZipFile) -> List[str]:
    """Slide part paths in PRESENTATION order (presentation.xml's
    sldIdLst through its rels) — slideN.xml numbering is not deck order
    for reordered decks. Falls back to numeric part sort."""
    try:
        pres = ET.fromstring(zf.read("ppt/presentation.xml"))
        rel_map = _rels(zf, "ppt/presentation.xml")
        ordered = []
        for sld in pres.findall(".//p:sldIdLst/p:sldId", _NS):
            rid = sld.get(f"{{{_NS['r']}}}id", "")
            path = rel_map.get(rid)
            if path and path in zf.namelist():
                ordered.append(path)
        if ordered:
            return ordered
    except (KeyError, ET.ParseError):
        pass
    return sorted(
        (n for n in zf.namelist()
         if re.fullmatch(r"ppt/slides/slide\d+\.xml", n)),
        key=lambda n: int(re.search(r"\d+", os.path.basename(n)).group()))


def parse_pptx(path: str) -> List[Slide]:
    """Slides in deck order with text, native tables, images, notes.
    Raises ValueError for non-PPTX input (legacy binary .ppt is not a
    zip; the reference converts those via LibreOffice, which is not in
    this image — re-save as .pptx)."""
    slides: List[Slide] = []
    try:
        zf = zipfile.ZipFile(path)
    except zipfile.BadZipFile as e:
        raise ValueError(
            f"{os.path.basename(path)} is not a PPTX (legacy binary .ppt "
            "is unsupported; re-save as .pptx)") from e
    with zf:
        for pos, spath in enumerate(_presentation_order(zf), start=1):
            try:
                root = ET.fromstring(zf.read(spath))
            except ET.ParseError as e:
                _LOG.warning("slide %s unparseable: %s", spath, e)
                continue
            rel_map = _rels(zf, spath)
            slides.append(Slide(
                number=pos,
                texts=_shape_paragraphs(root),
                tables=_tables(root),
                images=_slide_images(zf, rel_map, root),
                notes=_notes(zf, rel_map),
            ))
    return slides
