"""Time-indexed transcript store (framework-neutral).

Counterpart of generativeaiexamples_tpu/streaming/timestamps.py, copied:
every ingested chunk carries an insertion timestamp (float epoch
seconds) in SQLite, so "what was said in the last five minutes" reads a
time window rather than a similarity search.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class TimedDoc:
    """A transcript chunk with its ingest time (reference reformat())."""

    content: str
    tstamp: float  # epoch seconds
    source_id: str
    metadata: Dict = field(default_factory=dict)


class TimestampDatabase:
    """SQLite-backed time index (":memory:" by default — the reference
    writes timeseries.db into the container's cwd; pass a path for
    persistence across restarts)."""

    def __init__(self, path: str = ":memory:"):
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()  # sqlite conn shared across threads
        with self._lock:
            self.conn.execute(
                """
                CREATE TABLE IF NOT EXISTS messages (
                    id INTEGER PRIMARY KEY,
                    text TEXT,
                    tstamp REAL,
                    source_id TEXT
                )
                """
            )
            self.conn.commit()

    def insert_docs(self, docs: List[str], source_id: str,
                    tstamp: Optional[float] = None) -> None:
        tnow = time.time() if tstamp is None else tstamp
        with self._lock:
            self.conn.executemany(
                "INSERT INTO messages (text, tstamp, source_id) "
                "VALUES (?, ?, ?)",
                [(doc, tnow, source_id) for doc in docs])
            self.conn.commit()

    def _rows(self, query: str, args: tuple) -> List[TimedDoc]:
        with self._lock:
            rows = self.conn.execute(query, args).fetchall()
        return [TimedDoc(content=r[1], tstamp=r[2], source_id=r[3])
                for r in rows]

    def recent(self, tstamp: float) -> List[TimedDoc]:
        """All entries since epoch-seconds tstamp (database.py:66-71)."""
        return self._rows(
            "SELECT * FROM messages WHERE tstamp >= ? ORDER BY tstamp",
            (tstamp,))

    def past(self, tstamp: float, window: float = 90.0) -> List[TimedDoc]:
        """Entries within `window` seconds of tstamp (database.py:73-93)."""
        return self._rows(
            "SELECT * FROM messages WHERE tstamp BETWEEN ? AND ? "
            "ORDER BY tstamp", (tstamp - window, tstamp + window))

    def __len__(self) -> int:
        with self._lock:
            return self.conn.execute("SELECT COUNT(*) FROM messages"
                                     ).fetchone()[0]
