"""SSE bridge for blocking token iterators (aiohttp).

Counterpart of generativeaiexamples_tpu/utils/sse.py: a pump thread runs
the blocking generator and hands its items through an asyncio queue to
`data: <json>` frames. A client that disconnects mid-generation sets the
cancel flag: the pump stops at the next item and close()s the generator,
so an abandoned chat releases its executor thread instead of streaming
the whole generation into an unbounded queue. The playground server
(ui/server.py) streams /api/chat through it.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from typing import Callable, Iterable, Optional

from aiohttp import web

_LOG = logging.getLogger(__name__)


def _pump(loop, queue: asyncio.Queue, make_iter: Callable[[], Iterable],
          cancel: threading.Event) -> None:
    gen = None
    try:
        gen = make_iter()
        for item in gen:
            if cancel.is_set():
                break
            loop.call_soon_threadsafe(queue.put_nowait, ("item", item))
    except Exception as e:  # surface, don't hang the stream
        _LOG.exception("SSE pump failed")
        loop.call_soon_threadsafe(queue.put_nowait, ("error", str(e)))
    finally:
        if gen is not None and hasattr(gen, "close"):
            try:
                gen.close()  # GeneratorExit unwinds e.g. HTTP streams
            except Exception:
                pass
        loop.call_soon_threadsafe(queue.put_nowait, ("end", None))


async def stream_sse(
    request: web.Request,
    make_iter: Callable[[], Iterable],
    *,
    map_item: Callable[[object], Optional[dict]] = lambda x: {"content": x},
    final_payload: Optional[Callable[[], dict]] = None,
) -> web.StreamResponse:
    """Run `make_iter()` (a blocking generator) in an executor thread and
    re-emit its items as `data: <json>` SSE frames. `map_item` returning
    None skips a frame; `final_payload()` is emitted after a complete
    (non-cancelled) stream."""
    resp = web.StreamResponse(headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
    })
    await resp.prepare(request)

    loop = asyncio.get_running_loop()
    queue: asyncio.Queue = asyncio.Queue()
    cancel = threading.Event()
    task = loop.run_in_executor(None, _pump, loop, queue, make_iter, cancel)
    try:
        while True:
            kind, item = await queue.get()
            if kind == "end":
                break
            payload = (map_item(item) if kind == "item"
                       else {"content": f"[error] {item}"})
            if payload is None:
                continue
            if cancel.is_set():
                continue  # drain without writing until the pump stops
            try:
                await resp.write(b"data: " + json.dumps(payload).encode()
                                 + b"\n\n")
            except (ConnectionResetError, ConnectionError):
                cancel.set()  # client went away; stop generating
        if not cancel.is_set() and final_payload is not None:
            try:
                await resp.write(b"data: "
                                 + json.dumps(final_payload()).encode()
                                 + b"\n\n")
            except (ConnectionResetError, ConnectionError):
                pass
    finally:
        cancel.set()
        await task
    return resp
