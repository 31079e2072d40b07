"""In-process entity graph.

The port's copy of generativeaiexamples_tpu/kg/graph.py.

The role LangChain's NetworkxEntityGraph + GraphML files play in the
reference (backend/utils/lc_graph.py, routers/chat.py:36): store
(subject, relation, object) triples with entity types, answer
depth-bounded neighborhood queries, persist to disk. JSON is the native
format; GraphML import/export via networkx keeps interchange with the
reference's artifacts (knowledge_graph.graphml) and Gephi-Lite
visualization.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from collections import deque
from typing import Dict, List, Optional, Set, Tuple


@dataclasses.dataclass(frozen=True)
class Triple:
    subject: str
    subject_type: str
    relation: str
    object: str
    object_type: str

    def as_text(self) -> str:
        return f"{self.subject} {self.relation} {self.object}"


class EntityGraph:
    """Directed multigraph over entities; lookups are case-insensitive
    (the reference disambiguates case at extraction time only, which
    makes 'MIT' vs 'mit' silently miss — normalize here instead)."""

    def __init__(self):
        self._triples: List[Triple] = []
        self._adj: Dict[str, List[int]] = {}   # entity(lower) -> triple idx
        self._names: Dict[str, str] = {}       # entity(lower) -> display
        self._types: Dict[str, str] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._triples)

    @property
    def triples(self) -> List[Triple]:
        return list(self._triples)

    def entities(self) -> List[str]:
        return sorted(self._names.values())

    def add_triple(self, subject: str, subject_type: str, relation: str,
                   object: str, object_type: str) -> None:
        t = Triple(subject.strip(), subject_type.strip(), relation.strip(),
                   object.strip(), object_type.strip())
        if not t.subject or not t.object or not t.relation:
            return
        with self._lock:
            idx = len(self._triples)
            self._triples.append(t)
            for name, typ in ((t.subject, t.subject_type),
                              (t.object, t.object_type)):
                key = name.lower()
                self._adj.setdefault(key, []).append(idx)
                self._names.setdefault(key, name)
                if typ:
                    self._types[key] = typ

    def add_triples(self, triples) -> None:
        for t in triples:
            if isinstance(t, Triple):
                self.add_triple(t.subject, t.subject_type, t.relation,
                                t.object, t.object_type)
            elif isinstance(t, dict):
                self.add_triple(t.get("subject", ""),
                                t.get("subject_type", ""),
                                t.get("relation", ""),
                                t.get("object", ""),
                                t.get("object_type", ""))
            else:  # 5-tuple
                self.add_triple(*t)

    def get_entity_knowledge(self, entity: str, depth: int = 2
                             ) -> List[str]:
        """BFS over the undirected entity neighborhood up to `depth`
        hops; returns 'subject relation object' strings in discovery
        order (NetworkxEntityGraph.get_entity_knowledge contract used at
        routers/chat.py:58-60)."""
        start = entity.strip().lower()
        if start not in self._adj:
            return []
        seen_triples: Set[int] = set()
        seen_entities: Set[str] = {start}
        out: List[str] = []
        frontier: deque = deque([(start, 0)])
        while frontier:
            node, d = frontier.popleft()
            if d >= depth:
                continue
            for idx in self._adj.get(node, ()):
                t = self._triples[idx]
                if idx not in seen_triples:
                    seen_triples.add(idx)
                    out.append(t.as_text())
                for nxt in (t.subject.lower(), t.object.lower()):
                    if nxt not in seen_entities:
                        seen_entities.add(nxt)
                        frontier.append((nxt, d + 1))
        return out

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        from generativeaiexamples_tpu_torch.utils.fsio import (
            atomic_write_text)

        with self._lock:
            rows = [dataclasses.asdict(t) for t in self._triples]
        # Persisted under vector_store.persist_dir (knowledge_graph.json)
        # — written via tmp + os.replace so a crash mid-dump can't leave
        # a truncated graph for the next load (GL502 idiom).
        atomic_write_text(path, json.dumps({"triples": rows}))

    @classmethod
    def load(cls, path: str) -> "EntityGraph":
        g = cls()
        with open(path) as fh:
            data = json.load(fh)
        g.add_triples(data.get("triples", []))
        return g

    def to_graphml(self, path: str) -> None:
        """Interchange with the reference's GraphML artifacts (Gephi
        visualization router)."""
        import networkx as nx

        G = nx.MultiDiGraph()
        for key, name in self._names.items():
            G.add_node(name, entity_type=self._types.get(key, ""))
        for t in self._triples:
            G.add_edge(t.subject, t.object, relation=t.relation)
        nx.write_graphml(G, path)

    @classmethod
    def from_graphml(cls, path: str) -> "EntityGraph":
        import networkx as nx

        G = nx.read_graphml(path)
        g = cls()
        for u, v, data in G.edges(data=True):
            g.add_triple(str(u), G.nodes[u].get("entity_type", ""),
                         str(data.get("relation", "Relate_To")),
                         str(v), G.nodes[v].get("entity_type", ""))
        return g
