"""Layout analysis: positioned text runs -> tables.

The port's copy of generativeaiexamples_tpu/utils/layout.py.

The role pdfplumber's layout/table engine plays in the reference's
multimodal parser (custom_pdf_parser.py:273 get_pdf_documents groups
words into paragraphs/tables by bounding boxes). Input is
utils.pdf.extract_words output: (x, y, text) line-start runs.

Algorithm: cluster runs into rows by y; a maximal block of >=3
consecutive rows whose runs align on >=2 shared column x-positions is a
table. Columns come from clustering the x starts across the block, so
ragged rows (merged cells, missing values) still land in the right
column.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Run = Tuple[float, float, str]

Y_TOL = 3.0   # runs within this vertical distance share a row
X_TOL = 6.0   # column alignment tolerance


def group_rows(runs: Sequence[Run], y_tol: float = Y_TOL
               ) -> List[List[Run]]:
    """Cluster runs into visual rows, top to bottom, left to right."""
    rows: List[List[Run]] = []
    for run in sorted(runs, key=lambda r: (-r[1], r[0])):
        if rows and abs(rows[-1][0][1] - run[1]) <= y_tol:
            rows[-1].append(run)
        else:
            rows.append([run])
    return [sorted(r, key=lambda w: w[0]) for r in rows]


def _cluster_columns(rows: Sequence[List[Run]], x_tol: float = X_TOL
                     ) -> List[float]:
    """Representative x-position per column across the row block."""
    xs = sorted(x for row in rows for x, _, _ in row)
    cols: List[List[float]] = []
    for x in xs:
        if cols and x - cols[-1][-1] <= x_tol:
            cols[-1].append(x)
        else:
            cols.append([x])
    return [sum(c) / len(c) for c in cols]


def _is_tabular(row: List[Run]) -> bool:
    return len(row) >= 2


def detect_tables(runs: Sequence[Run], *, min_rows: int = 3,
                  x_tol: float = X_TOL) -> List[List[List[str]]]:
    """Find table blocks; each table is rows of column-aligned cells.

    A block qualifies when >=min_rows consecutive rows are multi-column
    and their x-starts agree on at least two columns (same bar the
    reference's layout grouping sets before calling a region a table).
    """
    rows = group_rows(runs)
    tables: List[List[List[str]]] = []
    block: List[List[Run]] = []

    def flush() -> None:
        if len(block) < min_rows:
            block.clear()
            return
        cols = _cluster_columns(block, x_tol)
        if len(cols) < 2:
            block.clear()
            return
        grid: List[List[str]] = []
        for row in block:
            cells = [""] * len(cols)
            for x, _, text in row:
                idx = min(range(len(cols)), key=lambda i: abs(cols[i] - x))
                cells[idx] = (cells[idx] + " " + text).strip()
            grid.append(cells)
        tables.append(grid)
        block.clear()

    for row in rows:
        if _is_tabular(row):
            # Alignment check against the block's existing columns.
            if block:
                cols = _cluster_columns(block, x_tol)
                aligned = sum(
                    1 for x, _, _ in row
                    if any(abs(c - x) <= x_tol for c in cols))
                if aligned < 2:
                    flush()
            block.append(row)
        else:
            flush()
    flush()
    return tables


def table_to_text(grid: List[List[str]]) -> str:
    """Render a detected table as pipe-separated rows — compact,
    unambiguous to an LLM, and greppable in tests."""
    return "\n".join(" | ".join(cell for cell in row) for row in grid)


def page_tables_as_text(pages: Sequence[Sequence[Run]]) -> List[str]:
    out: List[str] = []
    for runs in pages:
        out.extend(table_to_text(g) for g in detect_tables(runs))
    return out
