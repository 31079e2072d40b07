"""Playground web server: static pages + thin JSON/SSE proxy.

Counterpart of generativeaiexamples_tpu/ui/server.py, route for route:
`/` and `/converse` serve the chat page, `/kb` the knowledge-base page;
the page scripts call the `/api/*` endpoints below, which proxy to the
chain server through ChatClient so every hop carries W3C trace context,
re-emitting /generate's stream as SSE (utils/sse.py). Unlike the port's
chain and OpenAI servers (stdlib `http.server`) this one stays on
aiohttp: `/api/transcribe/ws` is a websocket, which the standard
library cannot serve. The pages are the port's own copy (`static/`).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import tempfile
from aiohttp import web

from generativeaiexamples_tpu_torch.ui.chat_client import ChatClient

_LOG = logging.getLogger(__name__)
STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")


class PlaygroundServer:
    """aiohttp app wrapping a ChatClient.

    With `asr`/`tts` clients (streaming/asr.py protocols) the voice
    path is live: the mic button posts WAV to /api/transcribe (or
    streams PCM over /api/transcribe/ws) and replies can be spoken via
    /api/speech."""

    def __init__(self, client: ChatClient, asr=None, tts=None,
                 voice_sample_rate: int = 16000,
                 feedback_path: str = "") -> None:
        self.client = client
        self.asr = asr
        self.tts = tts
        self.voice_sample_rate = voice_sample_rate
        # User feedback log: rated turns appended as JSONL.
        # Default lives under the user's state dir, NOT the shared temp
        # dir (a predictable /tmp name invites symlink-following writes
        # and cross-user interleaving on shared hosts).
        state_dir = os.environ.get(
            "XDG_STATE_HOME", os.path.join(os.path.expanduser("~"),
                                           ".local", "state"))
        self.feedback_path = feedback_path or os.path.join(
            state_dir, "gaie_tpu", "feedback.jsonl")
        self._feedback_lock = asyncio.Lock()
        self.app = web.Application(client_max_size=100 * 1024 * 1024)
        self.app.add_routes([
            web.get("/", self.page_converse),
            web.get("/converse", self.page_converse),
            web.get("/kb", self.page_kb),
            web.get("/health", self.handle_health),
            web.post("/api/chat", self.handle_chat),
            web.post("/api/search", self.handle_search),
            web.get("/api/documents", self.handle_list),
            web.post("/api/documents", self.handle_upload),
            web.delete("/api/documents", self.handle_delete),
            web.get("/api/voice", self.handle_voice_caps),
            web.post("/api/transcribe", self.handle_transcribe),
            web.get("/api/transcribe/ws", self.handle_transcribe_ws),
            web.post("/api/speech", self.handle_speech),
            web.post("/api/feedback", self.handle_feedback),
        ])
        self.app.router.add_static("/static", STATIC_DIR)

    # -- pages -------------------------------------------------------------

    async def page_converse(self, request: web.Request) -> web.FileResponse:
        return web.FileResponse(os.path.join(STATIC_DIR, "converse.html"))

    async def page_kb(self, request: web.Request) -> web.FileResponse:
        return web.FileResponse(os.path.join(STATIC_DIR, "kb.html"))

    async def handle_health(self, request: web.Request) -> web.Response:
        up = await asyncio.to_thread(self.client.health)
        return web.json_response(
            {"message": "Service is up." if up else "chain server unreachable",
             "chain_server": up}, status=200 if up else 503)

    # -- API proxies -------------------------------------------------------

    async def handle_chat(self, request: web.Request) -> web.StreamResponse:
        """Browser -> SSE -> ChatClient.predict -> chain server. Emits
        {"content": ...} data lines and a final {"done": true} with the
        search context when use_knowledge_base is on."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"detail": "invalid JSON"}, status=422)
        query = (body.get("query") or "").strip()
        if not query:
            return web.json_response({"detail": "query required"}, status=422)
        use_kb = bool(body.get("use_knowledge_base", False))
        num_tokens = int(body.get("max_tokens", 1024))

        docs = []
        if use_kb:
            docs = await asyncio.to_thread(self.client.search, query)

        from generativeaiexamples_tpu_torch.utils.sse import stream_sse

        return await stream_sse(
            request,
            lambda: self.client.predict(query, use_kb,
                                        num_tokens=num_tokens),
            # predict yields None as its own end sentinel — skip it.
            map_item=lambda c: {"content": c} if c else None,
            final_payload=lambda: {"done": True, "context": docs})

    async def handle_search(self, request: web.Request) -> web.Response:
        body = await request.json()
        chunks = await asyncio.to_thread(
            self.client.search, body.get("query", ""),
            int(body.get("top_k", 4)))
        return web.json_response({"chunks": chunks})

    async def handle_list(self, request: web.Request) -> web.Response:
        docs = await asyncio.to_thread(self.client.get_uploaded_documents)
        return web.json_response({"documents": docs})

    async def handle_upload(self, request: web.Request) -> web.Response:
        try:
            reader = await request.multipart()
        except (AssertionError, ValueError):
            return web.json_response({"detail": "multipart form required"},
                                     status=422)
        field = await reader.next()
        while field is not None and field.name != "file":
            field = await reader.next()
        if field is None:
            return web.json_response({"detail": "file field required"},
                                     status=422)
        fname = os.path.basename(field.filename or "upload.txt")
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, fname)
            with open(path, "wb") as fh:
                while True:
                    chunk = await field.read_chunk()
                    if not chunk:
                        break
                    fh.write(chunk)
            try:
                await asyncio.to_thread(self.client.upload_documents, [path])
            except ValueError as e:
                return web.json_response({"message": str(e)}, status=500)
        return web.json_response({"message": f"File {fname} uploaded"})

    async def handle_delete(self, request: web.Request) -> web.Response:
        fname = request.query.get("filename", "")
        if not fname:
            return web.json_response({"detail": "filename required"},
                                     status=422)
        out = await asyncio.to_thread(self.client.delete_documents, fname)
        return web.json_response(out if isinstance(out, dict)
                                 else {"message": str(out)})

    # -- voice ---------------------------------------------------------------

    async def handle_voice_caps(self, request: web.Request) -> web.Response:
        """The page probes this to decide whether to show the mic /
        speaker controls."""
        return web.json_response({"asr": self.asr is not None,
                                  "tts": self.tts is not None})

    async def handle_transcribe(self, request: web.Request) -> web.Response:
        """WAV body (audio/wav) -> {"text": transcript}."""
        if self.asr is None:
            return web.json_response(
                {"detail": "no ASR endpoint configured "
                           "(set APP_VOICE_ASRSERVERURL)"}, status=501)
        from generativeaiexamples_tpu_torch.streaming.asr import (
            wav_bytes_to_pcm)

        data = await request.read()
        try:
            pcm, rate = wav_bytes_to_pcm(data)
        except Exception as e:
            return web.json_response({"detail": f"bad WAV payload: {e}"},
                                     status=422)
        text = await asyncio.to_thread(self.asr.transcribe, pcm, rate)
        return web.json_response({"text": text})

    async def handle_transcribe_ws(self, request: web.Request
                                   ) -> web.WebSocketResponse:
        """Streaming transcription with INTERIM results (partial
        transcripts while the user speaks).

        Protocol: client opens the socket, sends one JSON text frame
        {"rate": <sample_rate>}, then binary frames of raw mono int16
        little-endian PCM as recorded. The server re-transcribes the
        ACCUMULATED audio (throttled to one in-flight interim request,
        min `interim_s` apart) and pushes {"text", "final": false}
        after each pass; on {"end": true} it transcribes the complete
        take once more and replies {"text", "final": true}. Works with
        any batch ASR endpoint behind the seam — no streaming ASR API
        required."""
        ws = web.WebSocketResponse(max_msg_size=16 * 1024 * 1024)
        await ws.prepare(request)
        if self.asr is None:
            await ws.send_json({"error": "no ASR endpoint configured"})
            await ws.close()
            return ws
        import time as _time

        rate = self.voice_sample_rate
        buf: list = []
        n_buffered = 0
        n_at_last = 0
        interim_s = float(os.environ.get("VOICE_INTERIM_INTERVAL_S", "0.5"))
        # Bounded take: a client that streams without ever sending
        # {"end": true} must not grow server memory without limit (16 MB
        # per frame is allowed), and each interim pass re-transcribes
        # the accumulation — so cap the take and window the interim.
        max_take_s = float(os.environ.get("VOICE_MAX_TAKE_S", "300"))
        interim_window_s = float(
            os.environ.get("VOICE_INTERIM_WINDOW_S", "30"))
        cap_notified = False
        last_interim = 0.0
        interim_task: "asyncio.Task | None" = None

        def _pcm(window_s: "float | None" = None):
            import numpy as np

            pcm = (np.concatenate(buf) if buf
                   else np.zeros((0,), "int16"))
            if window_s is not None:
                pcm = pcm[-int(window_s * rate):]
            return pcm

        async def send_interim(snapshot):
            try:
                text = await asyncio.to_thread(self.asr.transcribe,
                                               snapshot, rate)
                if text and not ws.closed:
                    await ws.send_json({"text": text, "final": False})
            except Exception:  # interim results are best-effort
                _LOG.debug("interim transcription failed", exc_info=True)

        async for msg in ws:
            if msg.type == web.WSMsgType.BINARY:
                import numpy as np

                if len(msg.data) % 2:
                    await ws.send_json(
                        {"error": "binary frames must be int16 PCM "
                                  "(even byte length)"})
                    continue
                arr = np.frombuffer(msg.data, "<i2")
                if n_buffered + len(arr) > max_take_s * rate:
                    if not cap_notified:
                        cap_notified = True
                        await ws.send_json(
                            {"error": f"take exceeds {max_take_s:.0f}s "
                                      "cap; send {\"end\": true} to "
                                      "finalize the buffered audio"})
                    continue
                buf.append(arr)
                n_buffered += len(arr)
                now = _time.monotonic()
                if (n_buffered > n_at_last
                        and now - last_interim >= interim_s
                        and (interim_task is None or interim_task.done())):
                    last_interim = now
                    n_at_last = n_buffered
                    interim_task = asyncio.create_task(
                        send_interim(_pcm(window_s=interim_window_s)))
            elif msg.type == web.WSMsgType.TEXT:
                try:
                    data = json.loads(msg.data)
                except json.JSONDecodeError:
                    continue
                if "rate" in data:
                    rate = int(data["rate"])
                if data.get("end"):
                    if interim_task is not None:
                        interim_task.cancel()
                    try:
                        text = await asyncio.to_thread(self.asr.transcribe,
                                                       _pcm(), rate)
                        await ws.send_json({"text": text, "final": True})
                    except Exception as e:
                        # A failed final must reach the client as an
                        # error frame, not a bare close — the page falls
                        # back to the one-shot WAV POST with the take it
                        # still has buffered.
                        _LOG.warning("final transcription failed: %s", e)
                        if not ws.closed:
                            await ws.send_json(
                                {"error": f"transcription failed: {e}"})
                    break
            elif msg.type in (web.WSMsgType.ERROR, web.WSMsgType.CLOSE):
                break
        await ws.close()
        return ws

    async def handle_speech(self, request: web.Request) -> web.Response:
        """{"text": ...} -> WAV bytes (audio/wav)."""
        if self.tts is None:
            return web.json_response(
                {"detail": "no TTS endpoint configured "
                           "(set APP_VOICE_TTSSERVERURL)"}, status=501)
        from generativeaiexamples_tpu_torch.streaming.asr import (
            pcm_to_wav_bytes)

        try:
            body = await request.json()
            text = (body.get("text") or "").strip()
            rate = int(body.get("sample_rate", self.voice_sample_rate))
        except (json.JSONDecodeError, AttributeError, TypeError, ValueError):
            return web.json_response({"detail": "expected JSON object with "
                                                "text and optional numeric "
                                                "sample_rate"}, status=422)
        if not text:
            return web.json_response({"detail": "text required"}, status=422)
        pcm = await asyncio.to_thread(self.tts.synthesize, text, rate)
        return web.Response(body=pcm_to_wav_bytes(pcm, rate),
                            content_type="audio/wav")

    # -- feedback ------------------------------------------------------------

    async def handle_feedback(self, request: web.Request) -> web.Response:
        """{"rating": 1|-1, "query": ..., "response": ..., "comment"?}
        appended to the feedback JSONL for offline analysis."""
        import time as _time

        try:
            body = await request.json()
            rating = int(body.get("rating"))
        except (json.JSONDecodeError, AttributeError, TypeError, ValueError):
            return web.json_response(
                {"detail": "expected JSON object with integer rating"},
                status=422)
        if rating not in (-1, 1):
            return web.json_response({"detail": "rating must be 1 or -1"},
                                     status=422)
        row = {"ts": _time.time(), "rating": rating,
               "query": str(body.get("query", ""))[:4096],
               "response": str(body.get("response", ""))[:16384],
               "comment": str(body.get("comment", ""))[:4096],
               "use_knowledge_base": bool(body.get("use_knowledge_base",
                                                   False))}
        async with self._feedback_lock:
            def append():
                os.makedirs(os.path.dirname(self.feedback_path) or ".",
                            exist_ok=True)
                with open(self.feedback_path, "a") as fh:
                    fh.write(json.dumps(row) + "\n")
            await asyncio.to_thread(append)
        return web.json_response({"message": "feedback recorded"})


def run_server(server: PlaygroundServer, host: str, port: int) -> None:
    web.run_app(server.app, host=host, port=port, print=None)
