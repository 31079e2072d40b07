"""HTTP connectors: any OpenAI-compatible /v1 endpoint.

The port's copy of generativeaiexamples_tpu/connectors/openai_http.py on
the standard library's `urllib.request` (the JAX copy uses `requests`):
a chat client that reads the server-sent-event stream of
/chat/completions, an embedder over /embeddings and a reranker over the
NIM-style /ranking. The port's own OpenAI server (serving/openai_server.py)
implements all three routes, so the chain can reach an engine running in
another process. The request bodies are the JAX clients'.
"""

from __future__ import annotations

import json
import logging
import urllib.request
from typing import Dict, Iterator, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.connectors.base import ChatBase, Message
from generativeaiexamples_tpu_torch.obs.tracing import traced_llm_stream

_LOG = logging.getLogger(__name__)


class _Client:
    """JSON POSTs to `base_url` (urllib raises HTTPError on a 4xx/5xx)."""

    def __init__(self, base_url: str, api_key: str, timeout: float):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.headers: Dict[str, str] = {"Content-Type": "application/json"}
        if api_key:
            self.headers["Authorization"] = f"Bearer {api_key}"

    def _open(self, path: str, body: Dict):
        req = urllib.request.Request(f"{self.base_url}{path}",
                                     data=json.dumps(body).encode(),
                                     headers=self.headers, method="POST")
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _post(self, path: str, body: Dict) -> Dict:
        with self._open(path, body) as r:
            return json.loads(r.read())


class OpenAIChatLLM(_Client, ChatBase):
    def __init__(self, base_url: str, model: str = "", api_key: str = "",
                 timeout: float = 120.0):
        super().__init__(base_url, api_key, timeout)
        self.model = model

    def stream_chat(self, messages: Sequence[Message], *, temperature=0.2,
                    top_p=0.7, max_tokens=1024, stop=()) -> Iterator[str]:
        yield from traced_llm_stream(
            "llm.openai", self._stream(messages, temperature, top_p,
                                       max_tokens, stop),
            {"model": self.model, "max_tokens": max_tokens})

    def _stream(self, messages, temperature, top_p, max_tokens, stop
                ) -> Iterator[str]:
        body = {
            "model": self.model, "messages": list(messages),
            "temperature": temperature, "top_p": top_p,
            "max_tokens": max_tokens, "stream": True,
        }
        if stop:
            body["stop"] = list(stop)
        with self._open("/chat/completions", body) as r:
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                payload = line[6:]
                if payload.strip() == "[DONE]":
                    return
                try:
                    delta = json.loads(payload)["choices"][0].get("delta", {})
                except (json.JSONDecodeError, KeyError, IndexError):
                    _LOG.debug("bad SSE frame: %r", payload)
                    continue
                piece = delta.get("content")
                if piece:
                    yield piece


class OpenAIEmbedder(_Client):
    def __init__(self, base_url: str, model: str = "", api_key: str = "",
                 dim: int = 1024, timeout: float = 60.0, batch: int = 32):
        super().__init__(base_url, api_key, timeout)
        self.model = model
        self.dim = dim
        self.batch = batch

    def _call(self, texts, input_type):
        out = []
        for i in range(0, len(texts), self.batch):
            body = {"model": self.model,
                    "input": list(texts[i:i + self.batch]),
                    "input_type": input_type}
            data = sorted(self._post("/embeddings", body)["data"],
                          key=lambda d: d["index"])
            out.extend(d["embedding"] for d in data)
        return np.asarray(out, np.float32)

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        return self._call(list(texts), "passage")

    def embed_query(self, text: str) -> np.ndarray:
        return self._call([text], "query")[0]

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self._call(list(texts), "query")


class OpenAIReranker(_Client):
    """NIM-style /v1/ranking client (the port's OpenAI server has it)."""

    def __init__(self, base_url: str, model: str = "", api_key: str = "",
                 timeout: float = 60.0):
        super().__init__(base_url, api_key, timeout)
        self.model = model

    def score(self, query: str, passages: Sequence[str]) -> np.ndarray:
        body = {"model": self.model, "query": {"text": query},
                "passages": [{"text": p} for p in passages]}
        out = np.zeros((len(passages),), np.float32)
        for rk in self._post("/ranking", body)["rankings"]:
            out[rk["index"]] = rk["logit"]
        return out
