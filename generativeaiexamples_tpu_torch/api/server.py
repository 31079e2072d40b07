"""Chain server: the RAG REST surface over the port's pipelines.

Counterpart of generativeaiexamples_tpu/api/server.py on the standard
library's `http.server.ThreadingHTTPServer` (the card's machine has no
aiohttp). Same routes, bodies, error bodies and input hygiene:

  POST /generate   Prompt{messages, use_knowledge_base, temperature,
                   top_p, max_tokens, stop} -> SSE of ChainResponse
                   {id, choices:[{index, message{role,content},
                   finish_reason}]} ending with a finish_reason "[DONE]"
                   sentinel frame
  POST /documents  multipart upload (field "file" or "files") -> ingest
  GET  /documents  -> {documents: [filenames]}
  DELETE /documents?filename=x
  POST /search     DocumentSearch{query, top_k} -> {chunks: [
                   DocumentChunk{content, filename, score}]}
  GET  /metrics    -> the vector store's counters and the micro-batchers'
  GET  /health     -> {message}; 503 when the CUDA device does not answer

Chains, ingests and searches run on an executor of
`serving.executor_workers` threads (at least 2 x microbatch_max_batch
with micro-batching on, so the batchers can fill a window), as in the
JAX server; the HTTP thread of a /generate request writes the frames the
chain thread hands it. Tracing (obs/tracing.py): /generate reads the
caller's W3C traceparent and opens a `generate` span with the TTFT and
the frames streamed; the chain thread attaches that span's context, so
the retriever, LLM and engine spans join its trace.
"""

from __future__ import annotations

import email.parser
import email.policy
import html
import json
import logging
import os
import queue
import re
import tempfile
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

import torch

from generativeaiexamples_tpu_torch.config.schema import AppConfig
from generativeaiexamples_tpu_torch.obs import tracing
from generativeaiexamples_tpu_torch.serving.openai_server import (
    BurstHTTPServer)

_LOG = logging.getLogger(__name__)

_CTRL = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")
MAX_CONTENT_CHARS = 131072
MAX_UPLOAD_BYTES = 100 * 1024 * 1024


def sanitize(text: str) -> str:
    return html.escape(_CTRL.sub("", text or "")[:MAX_CONTENT_CHARS],
                       quote=False)


def _chain_response(rid: str, content: str = "",
                    finish_reason: str = "") -> Dict[str, Any]:
    return {"id": rid, "choices": [{
        "index": 0,
        "message": {"role": "assistant", "content": content},
        "finish_reason": finish_reason,
    }]}


def _sse(payload: Dict[str, Any]) -> bytes:
    return f"data: {json.dumps(payload)}\n\n".encode()


class ChainServer:
    """One pipeline (example) behind the REST contract. Request handling
    is independent of the transport; `make_http_server` puts it behind a
    ThreadingHTTPServer."""

    def __init__(self, config: AppConfig, example=None,
                 example_name: Optional[str] = None,
                 upload_dir: Optional[str] = None, hub=None):
        from generativeaiexamples_tpu_torch.pipelines.base import (
            get_example_class)
        from generativeaiexamples_tpu_torch.pipelines.resources import (
            Resources)

        self.config = config
        tracing.setup(config)  # no-op unless tracing.enabled/ENABLE_TRACING
        if example is not None:
            self.example = example
        else:
            name = (example_name or os.environ.get("EXAMPLE_NAME")
                    or "developer_rag")
            self.example = get_example_class(name)(Resources(config, hub=hub))
        self.upload_dir = upload_dir or os.path.join(
            tempfile.gettempdir(), "gaie_torch", "uploaded_files")
        os.makedirs(self.upload_dir, exist_ok=True)
        # With micro-batching on, concurrency below the batch window
        # could never fill a dispatch: the width is floored above it.
        workers = config.serving.executor_workers
        if config.serving.microbatch_enabled:
            workers = max(workers, 2 * config.serving.microbatch_max_batch)
        self._executor = ThreadPoolExecutor(max_workers=workers,
                                            thread_name_prefix="chain-srv")

    def close(self) -> None:
        self._executor.shutdown(wait=True)

    # -- /health -----------------------------------------------------------

    def health(self) -> Tuple[int, Dict]:
        """Device liveness: a CUDA runtime query on the chain's device."""
        res = getattr(self.example, "res", None)
        hub = getattr(res, "hub", None)
        dev = getattr(hub, "device", None)
        try:
            if dev is not None and dev.type == "cuda":
                torch.cuda.mem_get_info(dev)
        except RuntimeError as e:  # device lost
            return 503, {"message": f"unhealthy: {e}"}
        return 200, {"message": "Service is up."}

    # -- /metrics ----------------------------------------------------------

    def metrics(self) -> Tuple[int, Dict]:
        """The vector store's counters and the cross-request
        micro-batchers' per stage (embed / rerank / search: mean
        coalesced batch size, queue-wait p50/p99, dispatches saved;
        empty with micro-batching off)."""
        payload: Dict[str, Any] = {}
        res = getattr(self.example, "res", None)
        store = getattr(res, "store", None)
        if store is not None and hasattr(store, "stats"):
            payload["vector_store"] = store.stats()
        retriever = getattr(res, "retriever", None)
        if retriever is not None and hasattr(retriever, "microbatch_stats"):
            payload["microbatch"] = retriever.microbatch_stats()
        return 200, payload

    # -- /generate ---------------------------------------------------------

    def parse_generate(self, body: Dict) -> Tuple[str, list, bool, Dict]:
        """(query, chat_history, use_kb, llm_settings) from a Prompt body;
        ValueError with the 422 detail on bad input."""
        messages = body.get("messages") or []
        if not isinstance(messages, list) or not messages:
            raise ValueError("messages required")
        chat_history = [{"role": sanitize(str(m.get("role", "user"))),
                         "content": sanitize(str(m.get("content", "")))}
                        for m in messages]
        # The last user message is the query; remove it by index (a
        # duplicate earlier in the history must stay).
        query = ""
        for i in range(len(chat_history) - 1, -1, -1):
            if chat_history[i]["role"] == "user":
                query = chat_history[i]["content"]
                del chat_history[i]
                break
        llm_settings = {
            "temperature": float(body.get("temperature", 0.2)),
            "top_p": float(body.get("top_p", 0.7)),
            "max_tokens": int(body.get("max_tokens", 1024)),
            "stop": [sanitize(s) for s in (body.get("stop") or [])],
        }
        return query, chat_history, bool(body.get("use_knowledge_base",
                                                  False)), llm_settings

    def generate_frames(self, query: str, chat_history: list, use_kb: bool,
                        llm_settings: Dict, headers: Optional[Dict] = None):
        """SSE frames (bytes) of one answer: the chain runs on the
        executor, its pieces cross a queue, and the [DONE] sentinel frame
        ends the stream whatever happened in the chain. `headers` are the
        request's (a W3C traceparent in them parents the spans)."""
        rid = str(uuid.uuid4())
        pieces: "queue.Queue" = queue.Queue()
        done = object()
        gspan = tracing.GenerationSpan(
            "generate", context=tracing.extract_context(headers or {}))
        gspan.sp.set_attribute("use_knowledge_base", use_kb)
        gspan.sp.set_attribute("request_id", rid)
        chain_ctx = gspan.sp.context()

        def run_chain():
            # Attached on the thread that runs the chain, so the spans it
            # opens (retriever, LLM, engine) join the generate span.
            tok = tracing.attach_context(chain_ctx)
            try:
                gen = (self.example.rag_chain(query, chat_history,
                                              **llm_settings) if use_kb
                       else self.example.llm_chain(query, chat_history,
                                                   **llm_settings))
                for piece in gen:
                    pieces.put(piece)
            except Exception as e:  # the error frame, then [DONE]
                _LOG.exception("chain failed")
                pieces.put("Error from chain server. Please check "
                           "chain-server logs for more details. "
                           f"({type(e).__name__})")
            finally:
                tracing.detach_context(tok)
                pieces.put(done)

        fut = self._executor.submit(run_chain)
        try:
            while True:
                piece = pieces.get()
                if piece is done:
                    break
                gspan.on_token()
                yield _sse(_chain_response(rid, piece))
            yield _sse(_chain_response(rid, "", "[DONE]"))
        finally:
            fut.result()
            gspan.__exit__(None, None, None)

    # -- /documents --------------------------------------------------------

    def upload(self, content_type: str, body: bytes) -> Tuple[int, Dict]:
        """Multipart upload: save the "file"/"files" part and ingest it."""
        msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
            f"Content-Type: {content_type}\r\n\r\n".encode() + body)
        part = None
        if msg.is_multipart():
            part = next((p for p in msg.iter_parts() if p.get_param(
                "name", header="content-disposition") in ("file", "files")),
                None)
        if part is None:
            return 422, {"detail": "file field required"}
        filename = os.path.basename(part.get_filename() or "upload.bin")
        path = os.path.join(self.upload_dir, filename)
        with open(path, "wb") as fh:
            fh.write(part.get_payload(decode=True) or b"")
        try:
            self._executor.submit(self.example.ingest_docs, path,
                                  filename).result()
        except Exception as e:
            _LOG.exception("ingest failed for %s", filename)
            return 500, {"detail": f"ingest failed: {type(e).__name__}: {e}"}
        return 200, {"message": f"File {filename} uploaded successfully"}

    def list_documents(self) -> Tuple[int, Dict]:
        try:
            return 200, {"documents": self.example.get_documents()}
        except NotImplementedError:
            return 200, {"documents": []}

    def delete_document(self, filename: str) -> Tuple[int, Dict]:
        if not filename:
            return 422, {"detail": "filename required"}
        try:
            ok = self.example.delete_documents([filename])
        except NotImplementedError:
            return 405, {"detail": "not supported"}
        except ValueError as e:
            return 422, {"detail": str(e)}
        if not ok:
            return 404, {"detail": f"{filename} not found"}
        p = os.path.join(self.upload_dir, os.path.basename(filename))
        if os.path.isfile(p):
            os.unlink(p)
        return 200, {"message": f"Deleted {filename}"}

    # -- /search -----------------------------------------------------------

    def search(self, body: Dict) -> Tuple[int, Dict]:
        query = sanitize(str(body.get("query", "")))
        top_k = int(body.get("top_k", self.config.retriever.top_k))
        try:
            chunks = self._executor.submit(self.example.document_search,
                                           query, top_k).result()
        except NotImplementedError:
            return 200, {"chunks": []}
        except Exception as e:
            _LOG.exception("search failed")
            return 500, {"detail": str(e)}
        return 200, {"chunks": chunks}


class _Handler(BaseHTTPRequestHandler):
    server_version = "gaie-torch-chain"
    app: ChainServer  # set on the subclass made by make_http_server

    def log_message(self, fmt, *args):  # route access logs to logging
        _LOG.debug("%s - " + fmt, self.address_string(), *args)

    def _json(self, status: int, payload: Dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        if n > MAX_UPLOAD_BYTES:
            raise ValueError(f"body of {n} bytes exceeds {MAX_UPLOAD_BYTES}")
        return self.rfile.read(n)

    def _json_body(self) -> Optional[Dict]:
        try:
            body = json.loads(self._body() or b"{}")
        except ValueError:
            self._json(422, {"detail": "invalid JSON"})
            return None
        if not isinstance(body, dict):
            self._json(422, {"detail": "invalid JSON"})
            return None
        return body

    def do_GET(self):
        path = urlsplit(self.path).path
        routes = {"/health": self.app.health, "/metrics": self.app.metrics,
                  "/documents": self.app.list_documents}
        if path not in routes:
            return self._json(404, {"detail": f"no route {self.path}"})
        return self._json(*routes[path]())

    def do_DELETE(self):
        url = urlsplit(self.path)
        if url.path != "/documents":
            return self._json(404, {"detail": f"no route {self.path}"})
        name = parse_qs(url.query).get("filename", [""])[0]
        return self._json(*self.app.delete_document(name))

    def do_POST(self):
        path = urlsplit(self.path).path
        if path == "/documents":
            try:
                body = self._body()
            except ValueError as e:
                return self._json(413, {"detail": str(e)})
            return self._json(*self.app.upload(
                self.headers.get("Content-Type", ""), body))
        if path not in ("/generate", "/search"):
            return self._json(404, {"detail": f"no route {self.path}"})
        body = self._json_body()
        if body is None:
            return None
        if path == "/search":
            return self._json(*self.app.search(body))
        try:
            args = self.app.parse_generate(body)
        except (TypeError, ValueError, AttributeError) as e:
            return self._json(422, {"detail": str(e)})
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        frames = self.app.generate_frames(*args, headers=dict(self.headers))
        try:
            for frame in frames:
                self.wfile.write(frame)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            _LOG.info("client disconnected from /generate")
            frames.close()  # waits for the chain to finish


def make_http_server(app: ChainServer, host: str = "0.0.0.0",
                     port: int = 8081) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer bound to (host, port) serving `app`; port 0
    picks a free port (see `server_address`)."""
    handler = type("ChainHandler", (_Handler,), {"app": app})
    httpd = BurstHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    return httpd


def main(argv=None) -> None:
    import argparse

    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.serving.__main__ import GEOMETRIES

    ap = argparse.ArgumentParser(
        description="RAG chain server of the PyTorch port. Config: the "
                    "APP_<SECTION>_<FIELD> environment variables; the "
                    "pipeline: $EXAMPLE_NAME (default developer_rag).")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8081)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--model-size", default=None, choices=sorted(GEOMETRIES),
                    help="LLM geometry (default: 8b on cuda, tiny on cpu)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    config = load_config()
    hub = EngineHub(config, device=args.device, model_size=args.model_size)
    server = ChainServer(config, hub=hub)
    httpd = make_http_server(server, args.host, args.port)
    _LOG.info("chain server: example=%s on %s:%d (device %s)",
              server.example.example_name, args.host, args.port, hub.device)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.close()
        hub.close()


if __name__ == "__main__":
    main()
