"""OpenAI-compatible HTTP surface over the port's engine (standard library).

Counterpart of generativeaiexamples_tpu/serving/openai_server.py, built on
`http.server.ThreadingHTTPServer` (one thread per connection; each live
stream parks its thread on the request's event queue):

  POST /v1/chat/completions   (stream=SSE chunks or one JSON body)
  POST /v1/completions
  POST /v1/embeddings          (EmbeddingEngine; 503 without one)
  POST /v1/ranking             (RerankEngine; 503 without one)
  GET  /v1/models, /health, /metrics (?format=prometheus: text
       exposition 0.0.4), /debug/timeline (the flight recorder's
       Chrome trace JSON: one lane per local fleet replica)
  POST /v1/kv/export, /v1/kv/import   (disaggregated prefill/decode:
       a replica server's cached prefix pages on the GKVT wire,
       serving/disagg.py)

`llm_engine` is one LLMEngine or an EngineFleet (serving/fleet.py): both
have the same surface. Requests carry a QoS tier (`priority` / the
x-priority header), a tenant (x-tenant-id, else `user`) and a session
(`user`, else x-session-id); the edge (serving/qos.py EdgeAdmission,
`serving.qos_edge`) sheds a tier's requests past its in-flight bound
with 429 and Retry-After before they queue.

Response bodies have the same JSON shapes as the JAX server's. The JAX
server bridges streams through an executor whose width it floors (128,
and 2 x serving.microbatch_max_batch with micro-batching on); here every
connection has its own thread, so there is no pool width to floor.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs

import torch

from generativeaiexamples_tpu_torch.config.schema import ServingConfig
from generativeaiexamples_tpu_torch.serving.disagg import (
    deserialize_kv_transfer, serialize_kv_transfer)
from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, PromptTooLongError)
from generativeaiexamples_tpu_torch.serving.fleet import (
    FleetUnavailableError)
from generativeaiexamples_tpu_torch.serving.flight import (
    chrome_trace, prometheus_text)
from generativeaiexamples_tpu_torch.serving.kv_pager import KV_PAGER_KEYS
from generativeaiexamples_tpu_torch.serving.qos import (
    EdgeAdmission, normalize_tier)

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
    def __init__(self, status: int, body: Dict[str, Any],
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(status)
        self.status = status
        self.body = body
        self.headers = headers or {}


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
                 model_name: str = "llama3-8b-instruct", serving_cfg=None):
        self.llm = llm_engine
        self.embed = embed_engine
        self.rerank = rerank_engine
        self.model_name = model_name
        scfg = serving_cfg or ServingConfig()
        # Edge admission: always constructed, so the /metrics shed
        # counters exist (0) with shedding off.
        self.edge = EdgeAdmission(
            bounds={"latency": scfg.qos_bound_latency,
                    "standard": scfg.qos_bound_standard,
                    "batch": scfg.qos_bound_batch},
            retry_after_s=scfg.qos_retry_after_s, enabled=scfg.qos_edge)

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

    def _gen_request(self, body: Dict, chat: bool,
                     headers=None) -> GenRequest:
        headers = headers or {}
        return GenRequest(
            prompt_ids=self._prompt_ids(body, chat),
            max_new_tokens=int(body.get("max_tokens") or 128),
            temperature=float(body.get("temperature") or 0.0),
            top_p=float(body.get("top_p") or 1.0),
            top_k=int(body.get("top_k") or 0),
            request_id=f"cmpl-{uuid.uuid4().hex[:20]}",
            # Fleet session affinity: the OpenAI `user` field, else the
            # x-session-id header.
            session_id=str(body.get("user")
                           or headers.get("x-session-id") or ""),
            # QoS tier (body `priority` / x-priority; unknown ->
            # standard) and tenant (x-tenant-id over `user`).
            priority=normalize_tier(body.get("priority")
                                    or headers.get("x-priority")),
            tenant_id=str(headers.get("x-tenant-id")
                          or body.get("user") or ""))

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
        query (free memory) on the engine's device. With an LLM engine,
        the JAX server's sections too: `fused_prefill` (always),
        `prefix_cache` (when the cache is on), `kv_pager` and
        `flight_recorder` (always)."""
        dev = next((getattr(e, "device", None)
                    for e in (self.llm, self.embed, self.rerank)
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
        pc = getattr(self.llm, "prefix_cache", None)
        if pc is not None:
            m = self.llm.metrics
            payload["prefix_cache"] = {
                "enabled": True, "cached_pages": pc.n_cached_pages,
                "hits": m.prefix_hits, "misses": m.prefix_miss,
                "evictions": m.prefix_evictions,
                "hit_tokens": m.prefix_hit_tokens}
        ecfg = getattr(self.llm, "ecfg", None)
        if ecfg is not None:
            # Always present with an engine (counters 0 and enabled false
            # with the knob off), so the keys never flicker.
            m = self.llm.metrics
            payload["fused_prefill"] = {
                "enabled": bool(ecfg.fused_prefill),
                "fused_steps": m.fused_steps,
                "fused_prefill_tokens": m.fused_prefill_tokens,
                "prefill_stall_beats": m.prefill_stall_beats}
        # Always present: the pager's tiers and counters, zeros when off.
        kp = getattr(self.llm, "kv_pager", None)
        payload["kv_pager"] = ({"enabled": True, **kp.stats()}
                               if kp is not None else
                               {"enabled": False,
                                **dict.fromkeys(KV_PAGER_KEYS, 0)})
        # Always present: a fleet reports its replicas' states, roles and
        # probe failures; one engine reports enabled false.
        fleet_health = getattr(self.llm, "fleet_health", None)
        payload["fleet"] = (fleet_health() if callable(fleet_health)
                            else {"enabled": False, "replicas": {}})
        # Always present (enabled false, zeros without a recorder): beats
        # and lifecycle events over the lanes this server fronts, and
        # where the timeline is.
        lanes = self._flight_lanes()
        section = {"enabled": False, "flight_beats": 0, "flight_events": 0,
                   "lanes": len(lanes), "timeline": "/debug/timeline"}
        for rec in lanes.values():
            st = rec.stats()
            section["enabled"] = section["enabled"] or bool(
                st["flight_enabled"])
            section["flight_beats"] += st["flight_beats"]
            section["flight_events"] += st["flight_events"]
        payload["flight_recorder"] = section
        # Always present: the engine's weighted-fair scheduling and
        # preemptions, and the edge's per-tier shedding and depth.
        edge = self.edge.snapshot()
        metrics = getattr(self.llm, "metrics", None)
        payload["qos"] = {
            "enabled": bool(getattr(ecfg, "qos", False)) if ecfg else False,
            "edge_enabled": self.edge.enabled,
            "preemptions": getattr(metrics, "qos_preemptions", 0),
            "shed": {k: v for k, v in edge.items()
                     if k.startswith("qos_shed_")},
            "edge_depth": edge["qos_edge_depth"]}
        return 200, payload

    def _flight_lanes(self) -> Dict[str, Any]:
        """name -> FlightRecorder of each lane this server fronts: a
        fleet's one per local replica and its control-plane lane, one
        engine's "engine"."""
        get = getattr(self.llm, "flight_recorders", None)
        if callable(get):
            return get()
        rec = getattr(self.llm, "flight", None)
        return {"engine": rec} if rec is not None else {}

    def timeline(self) -> Tuple[int, Dict]:
        """The flight recorder's rings as Chrome trace-event JSON
        (Perfetto loads it directly)."""
        return 200, chrome_trace(self._flight_lanes())

    def models(self) -> Tuple[int, Dict]:
        data = ([{"id": self.model_name, "object": "model"}]
                if self.llm is not None else [])
        return 200, {"object": "list", "data": data}

    def metrics(self) -> Tuple[int, Dict]:
        snap = self.llm.metrics.snapshot() if self.llm else {}
        # The edge's shed counters and depths ride the same scrape.
        snap.update(self.edge.snapshot())
        return 200, snap

    def metrics_prometheus(self) -> str:
        """/metrics?format=prometheus: the snapshot as Prometheus text
        exposition 0.0.4 (the histograms in native form)."""
        return prometheus_text(self.metrics()[1])

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

    def kv_export(self, body: Dict) -> Tuple[int, Any]:
        """Disagg transfer source: the cached full-page prefix of the
        posted prompt (token ids) as GKVT bytes, 204 when nothing is
        cached. `start_page` / `max_pages` pick a window; `publish`
        first makes an in-flight prefill's completed pages exportable,
        and `probe` answers {"pages": covered} without the payload. A
        router-only fleet has no pool to export (501). The export runs
        as an engine control op (the scheduler thread)."""
        eng = self.llm
        if eng is None or not hasattr(eng, "export_prefix_pages"):
            return 501, {"error": "no engine-level KV surface"}
        ids = list(body.get("prompt") or [])
        start_page = int(body.get("start_page") or 0)
        max_pages = int(body.get("max_pages") or 0)
        publish = bool(body.get("publish"))
        probe = bool(body.get("probe"))
        try:
            if publish or probe:
                covered = eng.run_control_op(
                    lambda: eng.publish_prefill_pages(ids))
                if probe:
                    return 200, {"pages": int(covered or 0)}
            out = eng.run_control_op(lambda: eng.export_prefix_pages(
                ids, start_page=start_page, max_pages=max_pages))
        except Exception as e:
            _LOG.warning("kv export failed: %s", e)
            return 503, {"error": {"message": str(e),
                                   "type": "service_unavailable",
                                   "code": "kv_export_failed"}}
        if out is None:
            return 204, b""
        codes, scales, n_tokens = out
        return 200, serialize_kv_transfer(ids[:n_tokens], codes, scales)

    def kv_import(self, buf: bytes, first_page: int = 0) -> Tuple[int, Dict]:
        """Disagg transfer target: seat a GKVT payload's pages into this
        engine's pool and radix tree; {"pages": n}. A bad payload is 422
        bad_kv_payload; pool pressure or a stopped engine is 503 (the
        fleet falls back to colocated serving)."""
        eng = self.llm
        if eng is None or not hasattr(eng, "import_prefix_pages"):
            return 501, {"error": "no engine-level KV surface"}
        try:
            ids, codes, scales = deserialize_kv_transfer(buf)
            pages = eng.run_control_op(lambda: eng.import_prefix_pages(
                ids, codes, scales, first_page=first_page))
        except ValueError as e:  # bad payload
            return 422, {"error": {"message": str(e),
                                   "type": "invalid_request_error",
                                   "code": "bad_kv_payload"}}
        except Exception as e:
            _LOG.warning("kv import failed: %s", e)
            return 503, {"error": {"message": str(e),
                                   "type": "service_unavailable",
                                   "code": "kv_import_failed"}}
        return 200, {"pages": int(pages)}

    def admit(self, req: GenRequest) -> None:
        """Edge admission: raise 429 with Retry-After past the request's
        tier bound, BEFORE the engine sees it. An admitted request holds
        its tier's slot until `release`."""
        retry_after = self.edge.try_admit(req.priority)
        if retry_after is not None:
            raise HTTPError(
                429, {"error": {"message": f"{req.priority}-tier queue is "
                                "full; retry later",
                                "type": "rate_limit_exceeded",
                                "code": "tier_queue_full"}},
                headers={"Retry-After": str(max(1, round(retry_after)))})

    def release(self, req: GenRequest) -> None:
        self.edge.release(req.priority)

    def submit(self, body: Dict, chat: bool, headers=None) -> GenRequest:
        """Build, admit at the edge and submit the engine request;
        HTTPError on refusal. The caller releases the edge slot
        (`release`) once the request's stream has ended."""
        if self.llm is None:
            raise HTTPError(503, {"error": "no LLM engine"})
        req = self._gen_request(body, chat, headers)
        self.admit(req)
        try:
            self.llm.submit(req)
        except FleetUnavailableError as e:
            # Every replica is draining or evicted: retryable.
            self.release(req)
            raise _error(503, str(e), "service_unavailable",
                         "no_replica_available") from e
        except PromptTooLongError as e:
            self.release(req)
            raise _error(422, str(e), "invalid_request_error",
                         "context_length_exceeded") from e
        except ValueError as e:
            self.release(req)
            raise _error(422, str(e), "invalid_request_error",
                         "unsupported_parameter") from e
        except RuntimeError as e:
            # A replica-side submit fault: the fleet has unwound its
            # tracking; a retryable 503.
            self.release(req)
            raise _error(503, str(e), "service_unavailable",
                         "replica_submit_failed") from e
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

    def _json(self, status: int, payload: Dict,
              headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _bytes(self, status: int, data: bytes) -> None:
        self.send_response(status)
        if data:
            self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _kv_import(self):
        n = int(self.headers.get("Content-Length") or 0)
        buf = self.rfile.read(n)
        # The window's first page rides a header; the GKVT body is the
        # same for every window.
        first = int(self.headers.get("X-KV-First-Page", "0") or 0)
        return self._json(*self.app.kv_import(buf, first_page=first))

    def do_GET(self):
        path, _, query = self.path.partition("?")
        if path == "/metrics" and parse_qs(query).get("format") == [
                "prometheus"]:
            data = self.app.metrics_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("X-Prometheus-Exposition-Version", "0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return None
        routes = {"/health": self.app.health, "/v1/models": self.app.models,
                  "/metrics": self.app.metrics,
                  "/debug/timeline": self.app.timeline}
        fn = routes.get(path)
        if fn is None:
            return self._json(404, {"error": f"no route {self.path}"})
        return self._json(*fn())

    def do_POST(self):
        path = self.path.split("?", 1)[0]
        if path == "/v1/kv/import":
            return self._kv_import()
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
        if path == "/v1/kv/export":
            status, out = self.app.kv_export(body)
            if isinstance(out, bytes):
                return self._bytes(status, out)
            return self._json(status, out)
        if path not in ("/v1/chat/completions", "/v1/completions"):
            return self._json(404, {"error": f"no route {self.path}"})
        chat = path == "/v1/chat/completions"
        headers = {k.lower(): v for k, v in self.headers.items()}
        try:
            req = self.app.submit(body, chat, headers)
        except HTTPError as e:
            return self._json(e.status, e.body, e.headers)
        except (KeyError, TypeError, ValueError) as e:
            return self._json(422, {"detail": f"bad request: {e}"})
        try:
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
        finally:
            self.app.release(req)


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
    """Serve until interrupted. SIGTERM (from the main thread) ends the
    loop like Ctrl-C does, so the caller's cleanup runs: the launcher
    stops the engine, and a tensor-parallel rank 0 publishes the stop
    record that ends its followers' replay."""
    httpd = make_http_server(app, host, port)
    old = None
    if threading.current_thread() is threading.main_thread():
        old = signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
            target=httpd.shutdown, daemon=True).start())
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        if old is not None:
            signal.signal(signal.SIGTERM, old)
