"""Baseline suppression file for graftlint.

A baseline entry records a *justified* finding: the check id, a content
hash of the finding's anchor line, where it lived when recorded, and a
human reason. Matching is by ``(check, content_hash)`` only — the
recorded file/line are documentation — so suppressions survive both
line-number drift (code added above) and file moves/renames. The flip
side: editing the offending line itself invalidates the suppression,
which is exactly when a human should re-look.

Format (checked in as ``lint-baseline-torch.json`` at the repo root:
the port's own file; the JAX package's ``lint-baseline.json`` is never
read)::

    {"version": 1,
     "entries": [{"check": "GL201", "file": "pkg/mod.py", "line": 10,
                  "hash": "ab12...", "reason": "why this is fine"}]}
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from generativeaiexamples_tpu_torch.lint.core import Finding

BASELINE_FILENAME = "lint-baseline-torch.json"


class Baseline:
    def __init__(self, entries: Optional[List[Dict]] = None,
                 path: Optional[str] = None):
        self.path = path
        self.entries = list(entries or [])
        self._index: Dict[tuple, Dict] = {
            (e.get("check", ""), e.get("hash", "")): e for e in self.entries}
        self._hits: set = set()

    def __len__(self) -> int:
        return len(self.entries)

    def matches(self, finding: Finding) -> bool:
        key = (finding.check, finding.content_hash)
        if key in self._index:
            self._hits.add(key)
            return True
        return False

    def filter(self, findings: Sequence[Finding]) -> List[Finding]:
        return [f for f in findings if not self.matches(f)]

    def unused_entries(self) -> List[Dict]:
        """Entries that suppressed nothing this run — stale: the code
        they justified was fixed or removed. Reported (not fatal) so
        the file can be pruned."""
        return [e for (k, e) in self._index.items() if k not in self._hits]

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        if not isinstance(data, dict) or "entries" not in data:
            raise ValueError(f"{path}: not a graftlint baseline "
                             f"(missing 'entries')")
        return cls(data["entries"], path=path)

    @classmethod
    def discover(cls, start_paths: Sequence[str]) -> Optional["Baseline"]:
        """Walk up from each input path looking for
        lint-baseline-torch.json (the git-root-adjacent convention, like
        pyproject discovery)."""
        seen = set()
        for p in start_paths:
            d = os.path.abspath(p)
            if os.path.isfile(d):
                d = os.path.dirname(d)
            while d not in seen:
                seen.add(d)
                cand = os.path.join(d, BASELINE_FILENAME)
                if os.path.isfile(cand):
                    return cls.load(cand)
                parent = os.path.dirname(d)
                if parent == d:
                    break
                d = parent
        return None

    @classmethod
    def from_findings(cls, findings: Sequence[Finding],
                      reason: str = "seeded by --write-baseline; "
                                    "justify or fix",
                      previous: Optional["Baseline"] = None) -> "Baseline":
        """Seed a baseline from current findings. Entries that already
        exist in `previous` (same check + hash) keep their hand-written
        reason — regenerating must never discard a curated
        justification."""
        entries = []
        seen = set()
        for f in findings:
            key = (f.check, f.content_hash)
            if key in seen:
                continue
            seen.add(key)
            old = previous._index.get(key) if previous is not None else None
            entries.append({"check": f.check, "file": f.path, "line": f.line,
                            "hash": f.content_hash,
                            "reason": old["reason"] if old
                            and old.get("reason") else reason})
        return cls(entries)

    def save(self, path: str) -> None:
        from generativeaiexamples_tpu_torch.utils.fsio import atomic_write_text

        payload = {"version": 1, "entries": self.entries}
        # Own idiom, dogfooded (GL502): the checked-in baseline is a
        # persisted artifact too — never truncate it in place.
        atomic_write_text(
            path, json.dumps(payload, indent=2, sort_keys=False) + "\n")
