"""Streaming chain server: /storeStreamingText and intent-routed
/generate.

Counterpart of generativeaiexamples_tpu/streaming/server.py, with its
routes, bodies and status codes: POST /storeStreamingText ingests
transcript fragments, POST /flush ends a source's stream, GET
/serverStatus reports readiness, POST /generate streams an intent-routed
answer as SSE (utils/sse.py). `python -m
generativeaiexamples_tpu_torch.streaming` serves it with the LLM and the
embedder of the port's connector factory: the in-process engines on the
card (K1 and K2 answer, K3 embeds), or any OpenAI-compatible endpoint.
"""

from __future__ import annotations

import asyncio
import json
import logging

from aiohttp import web

from generativeaiexamples_tpu_torch.streaming.accumulator import (
    StreamingStore, TextAccumulator)
from generativeaiexamples_tpu_torch.streaming.chains import StreamingRagChain
from generativeaiexamples_tpu_torch.streaming.timestamps import (
    TimestampDatabase)
from generativeaiexamples_tpu_torch.utils.sse import stream_sse

_LOG = logging.getLogger(__name__)


class StreamingServer:
    def __init__(self, llm, embedder, *, chunk_size: int = 256,
                 chunk_overlap: int = 32, max_docs: int = 4,
                 allow_summary: bool = True,
                 timestamp_db_path: str = ":memory:"):
        self.llm = llm
        self.store = StreamingStore(embedder)
        self.accumulator = TextAccumulator(
            self.store, chunk_size=chunk_size, chunk_overlap=chunk_overlap,
            timestamp_db=TimestampDatabase(timestamp_db_path))
        self.max_docs = max_docs
        self.allow_summary = allow_summary
        self.app = web.Application()
        self.app.add_routes([
            web.get("/serverStatus", self.handle_status),
            web.post("/storeStreamingText", self.handle_store),
            web.post("/flush", self.handle_flush),
            web.post("/generate", self.handle_generate),
        ])

    async def handle_status(self, request: web.Request) -> web.Response:
        return web.json_response({"is_ready": True})

    async def handle_store(self, request: web.Request) -> web.Response:
        body = await self._json_body(request)
        if body is None:
            return web.json_response({"detail": "invalid JSON"}, status=422)
        transcript = body.get("transcript", "")
        source_id = body.get("source_id", "default")
        end_of_stream = bool(body.get("end_of_stream", False))
        if not transcript and not end_of_stream:
            return web.json_response({"detail": "transcript required"},
                                     status=422)
        out = {"status": "Added 0 entries"}
        if transcript:
            out = await asyncio.to_thread(self.accumulator.update, source_id,
                                          transcript)
        if end_of_stream:
            out["flushed"] = await asyncio.to_thread(self.accumulator.flush,
                                                     source_id)
        return web.json_response(out)

    async def handle_flush(self, request: web.Request) -> web.Response:
        """Flush a source's tail buffer (its stream ended)."""
        body = await self._json_body(request)
        if body is None:
            return web.json_response({"detail": "invalid JSON"}, status=422)
        flushed = await asyncio.to_thread(
            self.accumulator.flush, body.get("source_id", "default"))
        return web.json_response({"flushed": flushed})

    @staticmethod
    async def _json_body(request: web.Request):
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return None
        return body if isinstance(body, dict) else None

    async def handle_generate(self, request: web.Request
                              ) -> web.StreamResponse:
        body = await self._json_body(request)
        if body is None:
            return web.json_response({"detail": "invalid JSON"}, status=422)
        question = body.get("question", "")
        if not question:
            return web.json_response({"detail": "question required"},
                                     status=422)
        chain = StreamingRagChain(
            self.llm, self.accumulator, self.store, max_docs=self.max_docs,
            allow_summary=bool(body.get("allow_summary",
                                        self.allow_summary)))
        return await stream_sse(
            request,
            lambda: chain.answer(
                question,
                use_knowledge_base=bool(
                    body.get("use_knowledge_base", True))),
            final_payload=lambda: {"done": True})


def main(argv=None) -> None:
    import argparse

    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import (
        EngineHub, get_embedder, get_llm)
    from generativeaiexamples_tpu_torch.serving.__main__ import GEOMETRIES

    ap = argparse.ArgumentParser(
        description="Streaming RAG chain server of the PyTorch port. "
                    "Config: --config or $APP_CONFIG_FILE, then the "
                    "APP_<SECTION>_<FIELD> environment variables.")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--model-size", default=None, choices=sorted(GEOMETRIES),
                    help="LLM geometry (default: 8b on cuda, tiny on cpu)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    cfg = load_config(args.config)
    hub = EngineHub(cfg, device=args.device, model_size=args.model_size)
    server = StreamingServer(get_llm(cfg, hub), get_embedder(cfg, hub))
    _LOG.info("streaming chain server on %s:%d (device %s)", args.host,
              args.port, hub.device)
    try:
        web.run_app(server.app, host=args.host, port=args.port, print=None)
    finally:
        hub.close()


if __name__ == "__main__":
    main()
