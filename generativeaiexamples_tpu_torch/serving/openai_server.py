"""OpenAI-compatible HTTP surface over the port's engine (standard library).

Counterpart of generativeaiexamples_tpu/serving/openai_server.py, built on
`http.server.ThreadingHTTPServer` (one thread per connection; each live
stream parks its thread on the request's event queue):

  POST /v1/chat/completions   (stream=SSE chunks or one JSON body)
  POST /v1/completions
  POST /v1/embeddings          (EmbeddingEngine; 503 without one)
  POST /v1/ranking             (RerankEngine; 503 without one)
  GET  /v1/models, /health, /metrics

Response bodies have the same JSON shapes as the JAX server's. The JAX
server bridges streams through an executor whose width it floors (128,
and 2 x serving.microbatch_max_batch with micro-batching on); here every
connection has its own thread, so there is no pool width to floor.
"""

from __future__ import annotations

import json
import logging
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import torch

from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, PromptTooLongError)

_LOG = logging.getLogger(__name__)

# /v1/embeddings' model id when the request names none.
EMBED_MODEL_NAME = "snowflake-arctic-embed-l"


class StopStream:
    """Stop-sequence matching over a token stream. Emitted text never
    contains any part of a stop string, including a prefix that arrived
    in an earlier chunk (held back until disambiguated)."""

    def __init__(self, stops):
        self.stops = [s for s in stops if s]
        self.full = ""
        self.sent = 0

    def push(self, new: str):
        """-> (text_safe_to_emit, hit_stop)."""
        self.full += new
        for s in self.stops:
            i = self.full.find(s)
            if i >= 0:
                emit = self.full[self.sent: i]
                self.sent = i
                return emit, True
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(self.full)), 0, -1):
                if self.full.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        end = len(self.full) - hold
        emit = self.full[self.sent: end] if end > self.sent else ""
        self.sent = max(self.sent, end)
        return emit, False

    def flush(self) -> str:
        """Release held-back text (a stop-prefix false alarm) at the end."""
        out = self.full[self.sent:]
        self.sent = len(self.full)
        return out


class HTTPError(Exception):
    def __init__(self, status: int, body: Dict[str, Any]):
        super().__init__(status)
        self.status = status
        self.body = body


def _error(status: int, message: str, kind: str, code: str) -> HTTPError:
    return HTTPError(status, {"error": {"message": message, "type": kind,
                                        "code": code}})


def _sse(data: Any) -> bytes:
    payload = data if isinstance(data, str) else json.dumps(data)
    return f"data: {payload}\n\n".encode()


class OpenAIServer:
    """Request handling, independent of the transport. `make_http_server`
    puts it behind a ThreadingHTTPServer."""

    def __init__(self, llm_engine=None, embed_engine=None, rerank_engine=None,
                 model_name: str = "llama3-8b-instruct"):
        self.llm = llm_engine
        self.embed = embed_engine
        self.rerank = rerank_engine
        self.model_name = model_name

    # -- helpers -----------------------------------------------------------

    def _prompt_ids(self, body: Dict, chat: bool) -> list:
        tk = self.llm.tokenizer
        if chat:
            text = tk.apply_chat_template(body["messages"],
                                          add_generation_prompt=True)
        else:
            p = body.get("prompt", "")
            if isinstance(p, list):
                if p and all(isinstance(x, int) for x in p):
                    return list(p)  # pre-tokenized prompt
                if len(p) != 1 or not isinstance(p[0], str):
                    raise HTTPError(422, {"detail": "prompt must be a string, "
                                          "[string], or [token ids]"})
                p = p[0]
            text = p
        return tk.encode(text, add_bos=not chat)

    def _gen_request(self, body: Dict, chat: bool) -> GenRequest:
        return GenRequest(
            prompt_ids=self._prompt_ids(body, chat),
            max_new_tokens=int(body.get("max_tokens") or 128),
            temperature=float(body.get("temperature") or 0.0),
            top_p=float(body.get("top_p") or 1.0),
            top_k=int(body.get("top_k") or 0),
            request_id=f"cmpl-{uuid.uuid4().hex[:20]}")

    @staticmethod
    def _stop_strings(body: Dict) -> list:
        stop = body.get("stop") or []
        return [stop] if isinstance(stop, str) else list(stop)

    @staticmethod
    def _events(req: GenRequest):
        while True:
            ev = req.stream.get()
            yield ev
            if ev["finished"]:
                return

    # -- handlers ----------------------------------------------------------

    def health(self) -> Tuple[int, Dict]:
        """Device liveness, not just process liveness: a CUDA runtime
        query (free memory) on the engine's device."""
        dev = next((e.device for e in (self.llm, self.embed, self.rerank)
                    if e is not None), None)
        payload = {"status": "healthy",
                   "engines": {"llm": self.llm is not None,
                               "embedding": self.embed is not None,
                               "reranking": self.rerank is not None}}
        try:
            if dev is not None and dev.type == "cuda":
                free, total = torch.cuda.mem_get_info(dev)
                payload.update(devices=torch.cuda.device_count(),
                               device=str(dev),
                               device_name=torch.cuda.get_device_name(dev),
                               memory_free_bytes=free,
                               memory_total_bytes=total)
            else:
                payload.update(devices=1, device=str(dev or "cpu"))
        except RuntimeError as e:  # device lost
            return 503, {"status": "unhealthy", "error": str(e)}
        return 200, payload

    def models(self) -> Tuple[int, Dict]:
        data = ([{"id": self.model_name, "object": "model"}]
                if self.llm is not None else [])
        return 200, {"object": "list", "data": data}

    def metrics(self) -> Tuple[int, Dict]:
        return 200, (self.llm.metrics.snapshot() if self.llm else {})

    def embeddings(self, body: Dict) -> Tuple[int, Dict]:
        if self.embed is None:
            return 503, {"error": "no embedding engine"}
        inputs = body.get("input", [])
        if isinstance(inputs, str):
            inputs = [inputs]
        is_query = body.get("input_type") == "query"  # NIM extension
        vecs = self.embed.embed(inputs, is_query=is_query)
        return 200, {
            "object": "list",
            "model": body.get("model", EMBED_MODEL_NAME),
            "data": [{"object": "embedding", "index": i,
                      "embedding": v.tolist()} for i, v in enumerate(vecs)],
            "usage": {"prompt_tokens": 0, "total_tokens": 0},
        }

    def ranking(self, body: Dict) -> Tuple[int, Dict]:
        if self.rerank is None:
            return 503, {"error": "no reranking engine"}
        query = body["query"]["text"] if isinstance(body.get("query"), dict) \
            else body.get("query", "")
        passages = [p["text"] if isinstance(p, dict) else p
                    for p in body.get("passages", [])]
        scores = self.rerank.score(query, passages)
        rankings = sorted(
            ({"index": i, "logit": float(s)} for i, s in enumerate(scores)),
            key=lambda r: -r["logit"])
        return 200, {"rankings": rankings}

    def submit(self, body: Dict, chat: bool) -> GenRequest:
        """Build and submit the engine request; HTTPError on refusal."""
        if self.llm is None:
            raise HTTPError(503, {"error": "no LLM engine"})
        req = self._gen_request(body, chat)
        try:
            self.llm.submit(req)
        except PromptTooLongError as e:
            raise _error(422, str(e), "invalid_request_error",
                         "context_length_exceeded") from e
        except ValueError as e:
            raise _error(422, str(e), "invalid_request_error",
                         "unsupported_parameter") from e
        except RuntimeError as e:
            raise _error(503, str(e), "service_unavailable",
                         "submit_failed") from e
        return req

    def _chunk(self, req, body, chat, created, delta: str,
               finish: Optional[str]) -> Dict:
        if chat:
            choice = {"index": 0,
                      "delta": {"content": delta} if delta else {},
                      "finish_reason": finish}
        else:
            choice = {"index": 0, "text": delta, "finish_reason": finish}
        return {"id": req.request_id,
                "object": "chat.completion.chunk" if chat
                else "text_completion",
                "created": created,
                "model": body.get("model", self.model_name),
                "choices": [choice]}

    def stream_events(self, req: GenRequest, body: Dict, chat: bool):
        """SSE payloads (bytes) for a streaming completion."""
        created = int(time.time())
        matcher = StopStream(self._stop_strings(body))
        for ev in self._events(req):
            text, cut = matcher.push(ev["text"])
            if text:
                yield _sse(self._chunk(req, body, chat, created, text, None))
            if cut or ev["finished"]:
                req.cancelled = True
                if not cut:
                    tail = matcher.flush()
                    if tail:
                        yield _sse(self._chunk(req, body, chat, created,
                                               tail, None))
                yield _sse(self._chunk(req, body, chat, created, "",
                                       "stop" if cut
                                       else ev["finish_reason"]))
                break
        yield _sse("[DONE]")

    def complete(self, req: GenRequest, body: Dict, chat: bool) -> Dict:
        """The whole (non-streaming) completion body."""
        created = int(time.time())
        matcher = StopStream(self._stop_strings(body))
        full, finish, n_tokens, cut = "", None, 0, False
        for ev in self._events(req):
            text, cut = matcher.push(ev["text"])
            full += text
            n_tokens += 1 if ev["token_id"] >= 0 else 0
            finish = ev["finish_reason"]
            if cut:
                finish = "stop"
                req.cancelled = True
                break
        if not cut:
            full += matcher.flush()
        msg = ({"message": {"role": "assistant", "content": full}}
               if chat else {"text": full})
        return {
            "id": req.request_id,
            "object": "chat.completion" if chat else "text_completion",
            "created": created, "model": body.get("model", self.model_name),
            "choices": [{**msg, "index": 0, "finish_reason": finish or "stop"}],
            "usage": {"prompt_tokens": len(req.prompt_ids),
                      "completion_tokens": n_tokens,
                      "total_tokens": len(req.prompt_ids) + n_tokens},
        }


class _Handler(BaseHTTPRequestHandler):
    server_version = "gaie-torch"
    app: OpenAIServer  # set on the subclass made by make_http_server

    def log_message(self, fmt, *args):  # route access logs to logging
        _LOG.debug("%s - " + fmt, self.address_string(), *args)

    def _json(self, status: int, payload: Dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        routes = {"/health": self.app.health, "/v1/models": self.app.models,
                  "/metrics": self.app.metrics}
        fn = routes.get(self.path.split("?", 1)[0])
        if fn is None:
            return self._json(404, {"error": f"no route {self.path}"})
        return self._json(*fn())

    def do_POST(self):
        path = self.path.split("?", 1)[0]
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
        except ValueError:
            return self._json(400, {"error": "body is not valid JSON"})
        encoders = {"/v1/embeddings": self.app.embeddings,
                    "/v1/ranking": self.app.ranking}
        if path in encoders:
            try:
                return self._json(*encoders[path](body))
            except (KeyError, TypeError, ValueError) as e:
                return self._json(422, {"detail": f"bad request: {e}"})
        if path not in ("/v1/chat/completions", "/v1/completions"):
            return self._json(404, {"error": f"no route {self.path}"})
        chat = path == "/v1/chat/completions"
        try:
            req = self.app.submit(body, chat)
        except HTTPError as e:
            return self._json(e.status, e.body)
        except (KeyError, TypeError, ValueError) as e:
            return self._json(422, {"detail": f"bad request: {e}"})
        if not body.get("stream"):
            return self._json(200, self.app.complete(req, body, chat))
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        try:
            for payload in self.app.stream_events(req, body, chat):
                self.wfile.write(payload)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            req.cancelled = True  # client went away: stop decoding


class BurstHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with aiohttp's listen backlog (the JAX servers'
    transport): a burst of concurrent clients queues instead of being
    reset, as it is past the standard library's default of 5."""

    request_queue_size = 128


def make_http_server(app: OpenAIServer, host: str = "0.0.0.0",
                     port: int = 8000) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer bound to (host, port) serving `app`; port 0
    picks a free port (see `server_address`)."""
    handler = type("OpenAIHandler", (_Handler,), {"app": app})
    httpd = BurstHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    return httpd


def run_server(app: OpenAIServer, host: str = "0.0.0.0",
               port: int = 8000) -> None:
    httpd = make_http_server(app, host, port)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
