"""Serving fleet: N data-parallel engine replicas behind one router.

The port's own copy of generativeaiexamples_tpu/serving/fleet.py, over
the port's engines, router and KV transfer. `build_fleet` attaches the
elastic autoscaler (serving/autoscaler.py, `fleet.autoscale`) with its
spawn lane, an in-process engine over the served weights or an
engine-server process, and an armed chaos monkey (serving/chaos.py,
`fleet.chaos`).

The production topology for heavy traffic: one `LLMEngine` saturates
one card; the fleet runs N of them data-parallel and places requests by
prefix-cache locality, queue depth and session affinity
(serving/router.py). Two replica flavors:

- `LocalReplica`: an in-process engine (its own scheduler thread, page
  pool and prefix cache). Replicas built by the launcher share ONE
  weight tree on the card; each owns its pool. Their scheduler threads
  launch on the same (default) stream of the card, so their kernels
  serialize there.
- `HttpReplica`: a separate engine-server PROCESS reached over the
  OpenAI surface (each replica runs `python -m
  generativeaiexamples_tpu_torch.serving` on its own card or host). The
  router process runs with `fleet.replica_urls` set and no local
  engine; streams are SSE-proxied through unchanged.

`EngineFleet` exposes the SAME surface the OpenAI server consumes from
a single engine (`submit` / `tokenizer` / `metrics.snapshot()` /
`stop`), so `serving/openai_server.py` serves a fleet with zero
handler changes and SSE streaming is untouched: `submit()` places the
request on a replica and events flow through `req.stream` exactly as
before. With `fleet.replicas = 1` (the default) no fleet object is
built at all — the single-engine path is byte-identical.

Request tracking: `submit()` swaps `req.stream` for a `_TrackedStream`
whose `put` observes every event, so the fleet knows per-replica queue
depth and in-flight token load without touching engine internals, can
requeue not-yet-started requests when a replica is evicted, and can
wait for in-flight streams during graceful drain.

Lifecycle:

- drain(rid): replica stops admitting, in-flight streams finish,
  router drops its shadow tree (rebalance). restore(rid) re-admits.
- health: a daemon probe thread checks each replica every
  `fleet.health_interval_s` (engine threads alive for local replicas,
  GET /health with a SHORT dedicated timeout for remote ones); a
  replica is EVICTED only after `fleet.health_fail_threshold`
  CONSECUTIVE failed probes (one slow poll must not kill a loaded
  replica) — removed from placement, not-yet-started requests
  requeued onto the survivors KEEPING their QoS tier/tenant and
  re-pinning their session affinity, mid-stream requests terminated
  with an error event (their tokens are on the dead replica;
  replaying a half-delivered stream would duplicate output).
- elastic control plane: `add_replica` / `park` / `restore` give an
  autoscaler runtime topology changes: a "warm" replica is
  started+warmed but not admitting (instant scale-up), a "parked" one
  is cold-stopped (scale-to-zero); with an autoscaler attached, a
  submit against a fully parked fleet wakes one replica instead of
  503ing.
  `rolling_upgrade(new_factory)` swaps every local replica's engine
  one at a time (drain -> steal un-admitted -> swap -> re-warm ->
  restore) with the invariant of zero failed streams and zero
  dropped requests; control-plane decisions land in their own
  flight-recorder lanes (`extra_flight_lanes`) on /debug/timeline.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional

from generativeaiexamples_tpu_torch.serving import flight as flight_mod
from generativeaiexamples_tpu_torch.serving.flight import (
    EV_UPGRADE, FlightRecorder)
from generativeaiexamples_tpu_torch.serving.qos import request_tier
from generativeaiexamples_tpu_torch.serving.router import (
    PrefixLocalityRouter)

_LOG = logging.getLogger(__name__)

_COUNTER_KEYS = (
    "tokens_generated", "decode_steps", "prefill_tokens", "fused_steps",
    "fused_prefill_tokens", "prefill_stall_beats",
    "fused_sample_dispatches", "prefix_hits",
    "prefix_miss", "prefix_evictions", "prefix_hit_tokens",
    "plan_variants_compiled", "spec_fallback_steps",
    "admission_failures", "qos_preemptions",
    # Disagg KV transfer counters (serving/disagg.py): pages a decode
    # replica imported from a prefill-role replica, and the wall ms
    # those imports cost — summed fleet-wide, zeros when disagg is off.
    # device_pages arrived as device tensors over the device path
    # (zero host serialization); chunks counts import control ops
    # (each window of a chunked/pipelined transfer is one).
    "kv_transfer_pages", "kv_transfer_ms",
    "kv_transfer_device_pages", "kv_transfer_chunks",
    # KV-pager counters and tier gauges (serving/kv_pager.py) sum
    # across replicas: fleet-wide parked-session pages per tier.
    "kv_demotions", "kv_promotions", "kv_promote_tokens",
    "kv_host_pages", "kv_spill_pages", "kv_host_bytes", "kv_spill_bytes",
    "kv_spill_writes", "kv_spill_compactions", "kv_forced_drops",
    "kv_pager_errors",
    # Flight-recorder counters (serving/flight.py) sum across
    # replicas; the per-lane rings themselves are served by
    # /debug/timeline (one Perfetto lane per local replica).
    "flight_beats", "flight_events",
    # stop()-path joins that timed out (engine.py stop); the fleet
    # adds its own control-thread stuck joins on top of this sum.
    "stuck_thread_joins",
)

# Fleet control-plane counters (FleetOps below): always present in
# /metrics — 0, never absent — whether served by a fleet or a single
# engine (EngineMetrics.snapshot zero-fills the same lists).
FLEET_OPS_KEYS = (
    "autoscale_ups", "autoscale_downs", "autoscale_wakes",
    "upgrade_rolls", "upgrade_replicas_rolled",
    # Disagg control plane (serving/disagg.py): two-stage plans the
    # fleet ran, and stages that fell back to colocated serving on the
    # same stream (prefill failure, transfer failure, empty export).
    "disagg_requests", "disagg_fallbacks",
    # Pipelined-transfer plane (fleet.disagg_pipeline): wall ms of
    # transfer windows that shipped UNDER the prefill tail (hidden
    # from TTFT), total transfer-window wall ms (the overlap pct's
    # denominator), decode admissions that proceeded with the final
    # chunk still in flight, and device-path windows that fell back
    # to the GKVT host bounce. Zeros when the knobs are off.
    "disagg_overlap_ms", "disagg_transfer_ms",
    "disagg_early_admits", "disagg_device_fallbacks",
)

# Chaos-injection counters (the JAX package's serving/chaos.py; ROADMAP
# A.16 in the port): zeros unless a chaos monkey is attached.
CHAOS_KEYS = (
    "chaos_injected_kills", "chaos_injected_blackholes",
    "chaos_injected_slow_beats", "chaos_injected_submit_errors",
)


class FleetOps:
    """Fleet control-plane counters: autoscaler decisions, rolling
    upgrades, disagg stages, and the fleet's own stuck thread joins (the
    per-engine stop-path joins live on EngineMetrics and sum
    separately). Every key is always present in snapshot()."""

    def __init__(self):
        self._lock = threading.Lock()
        self.autoscale_ups = 0
        self.autoscale_downs = 0
        self.autoscale_wakes = 0
        self.upgrade_rolls = 0
        self.upgrade_replicas_rolled = 0
        self.disagg_requests = 0
        self.disagg_fallbacks = 0
        self.disagg_overlap_ms = 0.0
        self.disagg_transfer_ms = 0.0
        self.disagg_early_admits = 0
        self.disagg_device_fallbacks = 0
        self.stuck_thread_joins = 0

    def note_scale_up(self) -> None:
        with self._lock:
            self.autoscale_ups += 1

    def note_scale_down(self) -> None:
        with self._lock:
            self.autoscale_downs += 1

    def note_wake(self) -> None:
        with self._lock:
            self.autoscale_wakes += 1

    def note_upgrade_roll(self, replicas: int) -> None:
        with self._lock:
            self.upgrade_rolls += 1
            self.upgrade_replicas_rolled += replicas

    def note_disagg(self) -> None:
        with self._lock:
            self.disagg_requests += 1

    def note_disagg_fallback(self) -> None:
        with self._lock:
            self.disagg_fallbacks += 1

    def note_disagg_transfer(self, wall_ms: float,
                             overlap_ms: float = 0.0) -> None:
        with self._lock:
            self.disagg_transfer_ms += wall_ms
            self.disagg_overlap_ms += overlap_ms

    def note_disagg_early_admit(self) -> None:
        with self._lock:
            self.disagg_early_admits += 1

    def note_disagg_device_fallback(self) -> None:
        with self._lock:
            self.disagg_device_fallbacks += 1

    def note_stuck_join(self, n: int = 1) -> None:
        with self._lock:
            self.stuck_thread_joins += n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            out = {k: getattr(self, k) for k in FLEET_OPS_KEYS}
            out["stuck_thread_joins"] = self.stuck_thread_joins
            return out


class FleetUnavailableError(RuntimeError):
    """No replica admits requests (all draining/evicted) — the server
    maps this to 503, not 422: the request is fine, the fleet isn't."""


def _error_event():
    """Terminal error event in the engine's stream-event schema (made in
    one place: the server reads exactly these keys)."""
    return {"text": "", "token_id": -1, "finished": True,
            "finish_reason": "error"}


def sse_json_events(lines):
    """Decode an SSE byte-line iterable into JSON payloads, stopping at
    the [DONE] sentinel. Shared by HttpReplica's stream proxy and its
    tests (no network needed to cover the parser)."""
    for raw in lines:
        line = raw.decode("utf-8", "replace").strip()
        if not line.startswith("data:"):
            continue
        data = line[len("data:"):].strip()
        if data == "[DONE]":
            return
        yield json.loads(data)


class LocalReplica:
    """One in-process LLMEngine as a fleet replica."""

    # Eviction may requeue this replica's untouched requests: stop()
    # JOINS the engine threads, so after it returns nothing can emit
    # into a stream the fleet re-places.
    supports_requeue = True

    def __init__(self, rid: str, engine, role: str = "mixed"):
        self.rid = rid
        self.engine = engine
        # Disagg role (router.REPLICA_ROLES): "prefill" replicas only
        # ever see prefill stages, never decode placements.
        self.role = role
        # Fleet-owned state machine: active | draining | drained |
        # evicted | warm (started+warmed, not admitting — the
        # autoscaler's instant-scale-up pool) | parked (cold-stopped —
        # scale-to-zero) | upgrading (engine swap in flight).
        self.state = "active"

    @property
    def has_prefix_cache(self) -> bool:
        return getattr(self.engine, "prefix_cache", None) is not None

    def set_reporter(self, fn) -> None:
        if self.has_prefix_cache:
            self.engine.prefix_cache.reporter = fn

    def submit(self, req):
        # Returns the engine the request landed on: rolling_upgrade
        # swaps `self.engine` under live traffic, and the fleet's
        # submit path compares this against the current engine to
        # rescue a request that raced onto the discarded one.
        eng = self.engine
        eng.submit(req)
        return eng

    def steal_waiting(self) -> List:
        """Atomically remove every NOT-YET-ADMITTED request from the
        engine's waiting deque (the rolling-upgrade drain tail).
        Admission runs under the same engine lock, so a stolen request
        can never reach a slot afterwards — its stream stays silent
        and is safe to re-place on a survivor."""
        with self.engine._lock:
            stolen = list(self.engine.waiting)
            self.engine.waiting.clear()
            for req in stolen:
                self.engine._tier_depth(req, -1)
        return stolen

    def healthy(self) -> bool:
        t = getattr(self.engine, "_thread", None)
        return bool(getattr(self.engine, "_running", False)
                    and t is not None and t.is_alive())

    def start(self) -> None:
        # Keyed on _running, not _thread: stop() leaves the joined
        # thread object behind, and restore() after an eviction must
        # actually restart the scheduler (the engine parks between
        # iterations, so its slot/page state survives a stop/start).
        if not getattr(self.engine, "_running", False):
            self.engine.start()

    def stop(self) -> None:
        self.engine.stop()

    def purge_waiting(self) -> None:
        """Forget requests still queued on a stopped engine: eviction
        moved (or error-terminated) every one of them, so restore()
        must revive an EMPTY scheduler — a surviving deque entry would
        replay into a stream another replica now owns."""
        with self.engine._lock:
            self.engine.waiting.clear()
            # The purged requests leave the queue without being
            # admitted: zero the per-tier depth gauge with them.
            for t in self.engine.metrics.qos_queue_depth:
                self.engine.metrics.qos_queue_depth[t] = 0

    def warmup(self, **kw) -> None:
        self.engine.warmup(**kw)

    def metrics_snapshot(self) -> Dict[str, Any]:
        return self.engine.metrics.snapshot()

    # -- disagg KV page transfer (serving/disagg.py) -----------------------

    # graftlint: hot-path
    def export_kv_pages(self, ids, timeout_s: float = 60.0,
                        start_page: int = 0, max_pages: int = 0):
        """Cached full-page prefix of `ids` (or the
        start_page/max_pages window of it) as host bytes, gathered on
        the engine's scheduler thread (control op). None when nothing
        is cached."""
        eng = self.engine
        return eng.run_control_op(
            lambda: eng.export_prefix_pages(ids, start_page, max_pages),
            timeout_s=timeout_s)

    # graftlint: hot-path
    def import_kv_pages(self, ids, codes, scales,
                        timeout_s: float = 60.0,
                        first_page: int = 0) -> int:
        """Seat transferred pages into the engine's pool + radix tree
        (control op). Returns pages imported."""
        eng = self.engine
        return eng.run_control_op(
            lambda: eng.import_prefix_pages(ids, codes, scales,
                                            first_page),
            timeout_s=timeout_s)

    # graftlint: hot-path
    def publish_kv_pages(self, ids, timeout_s: float = 60.0) -> int:
        """Make an in-flight chunked prefill's completed pages
        exportable now (control op) — the pipelined-transfer probe.
        Returns covered full pages."""
        eng = self.engine
        return eng.run_control_op(
            lambda: eng.publish_prefill_pages(ids), timeout_s=timeout_s)

    # graftlint: hot-path
    def export_kv_pages_device(self, ids, timeout_s: float = 60.0,
                               start_page: int = 0, max_pages: int = 0):
        """Device-path export: the window's device-resident pages as
        device tensors, no host copy (control op). None when the window
        holds none."""
        eng = self.engine
        return eng.run_control_op(
            lambda: eng.export_prefix_pages_device(ids, start_page,
                                                   max_pages),
            timeout_s=timeout_s)

    # graftlint: hot-path
    def import_kv_pages_device(self, ids, codes, scales,
                               timeout_s: float = 60.0,
                               first_page: int = 0) -> int:
        """Device-path import: scatter the device tensors into this
        engine's pool (control op; import_prefix_pages' copy_ into the
        pool's device is the peer copy when they lie on another card).
        Returns pages imported."""
        eng = self.engine
        return eng.run_control_op(
            lambda: eng.import_prefix_pages(ids, codes, scales,
                                            first_page, on_device=True),
            timeout_s=timeout_s)

    def transfer_page_size(self) -> int:
        return self.engine.pool.page_size

    def transfer_device_set(self):
        """Devices holding this engine's KV pool: the device path's
        colocation check's input (parallel/mesh.py devices_colocated)."""
        pool = self.engine.pool
        arr = pool.kv if getattr(pool, "quantized", False) else pool.k
        return {arr.device}


class HttpReplica:
    """One remote engine-server process as a fleet replica (the
    process-per-replica topology). Streams proxy over the replica's
    /v1/completions SSE surface; prompts travel pre-tokenized (the
    completions endpoint accepts token-id lists), so router and
    replica must share one tokenizer. Proxied events carry token_id 0
    per text chunk (the remote stream is text-granular), so fleet
    token accounting counts chunks for remote replicas — a load
    signal, not an exact token count."""

    # Eviction must NOT requeue this replica's requests: the proxy
    # thread may be parked in urlopen for up to timeout_s and stop()
    # cannot join it, so a zombie proxy could later inject events into
    # a stream a survivor now owns. Untouched requests end with an
    # error event instead (the client retries).
    supports_requeue = False

    def __init__(self, rid: str, base_url: str, timeout_s: float = 300.0,
                 probe_timeout_s: float = 2.0, role: str = "mixed"):
        self.rid = rid
        self.role = role
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        # Health probes get their OWN short connect/read timeout — a
        # probe riding the 300 s stream timeout would park the probe
        # loop for 5 minutes per sick replica and starve every other
        # replica's health check.
        self.probe_timeout_s = max(0.1, float(probe_timeout_s))
        # Consecutive failed probes (written by the probe loop only):
        # backs off the probe deadline below.
        self._probe_fails = 0
        self.state = "active"
        self.has_prefix_cache = False  # reports can't cross processes

    def set_reporter(self, fn) -> None:
        """Remote caches report nothing; the router self-feeds this
        replica's shadow tree at placement time instead."""

    def submit(self, req) -> None:
        threading.Thread(target=self._proxy, args=(req,), daemon=True,
                         name=f"fleet-proxy-{self.rid}").start()

    def _proxy(self, req) -> None:
        body = json.dumps({
            "prompt": list(req.prompt_ids),
            "max_tokens": req.max_new_tokens,
            "temperature": req.temperature, "top_p": req.top_p,
            "top_k": req.top_k, "stream": True,
        }).encode()
        http_req = urllib.request.Request(
            self.base_url + "/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        finished = False
        try:
            with urllib.request.urlopen(http_req,
                                        timeout=self.timeout_s) as resp:
                for ev in sse_json_events(resp):
                    if req.cancelled:
                        # Client disconnect / stop-string cut: breaking
                        # out closes the response, which cancels decode
                        # on the remote replica (its server sees the
                        # reset); the terminal event below still closes
                        # the fleet's tracking record, mirroring the
                        # local engine's _finish(..., "cancelled").
                        req.stream.put({"text": "", "token_id": -1,
                                        "finished": True,
                                        "finish_reason": "cancelled"})
                        return
                    ch = (ev.get("choices") or [{}])[0]
                    text = ch.get("text", "")
                    if text:
                        req.stream.put({"text": text, "token_id": 0,
                                        "finished": False,
                                        "finish_reason": None})
                    if ch.get("finish_reason"):
                        req.stream.put({"text": "", "token_id": -1,
                                        "finished": True,
                                        "finish_reason":
                                            ch["finish_reason"]})
                        finished = True
                        break
        except Exception as e:
            _LOG.warning("fleet replica %s stream proxy failed: %s",
                         self.rid, e)
        if not finished:
            req.stream.put(_error_event())

    def healthy(self) -> bool:
        # Deadline backoff: each consecutive failure grants the next
        # probe progressively more time (capped at 3x) — a replica
        # that is merely LOADED gets leniency on the road to the
        # fleet's K-consecutive-failure eviction threshold, while a
        # dead one still fails K short probes quickly.
        timeout = self.probe_timeout_s * min(self._probe_fails + 1, 3)
        try:
            with urllib.request.urlopen(self.base_url + "/health",
                                        timeout=timeout) as resp:
                ok = json.load(resp).get("status") == "healthy"
        except Exception:
            ok = False
        self._probe_fails = 0 if ok else self._probe_fails + 1
        return ok

    def start(self) -> None:
        """Remote process owns its own lifecycle."""

    def stop(self) -> None:
        """Remote process owns its own lifecycle."""

    def warmup(self, **kw) -> None:
        """Remote process warms itself at boot."""

    def metrics_snapshot(self) -> Dict[str, Any]:
        try:
            with urllib.request.urlopen(self.base_url + "/metrics",
                                        timeout=5.0) as resp:
                return json.load(resp)
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    # -- disagg KV page transfer (serving/disagg.py over HTTP) -------------

    # graftlint: hot-path
    def export_kv_pages(self, ids, timeout_s: float = 60.0,
                        start_page: int = 0, max_pages: int = 0):
        """Fetch the remote replica's cached prefix for `ids` (or the
        start_page/max_pages window of it) over its /v1/kv/export
        endpoint. None when it holds nothing (204). The returned
        n_tokens covers the prefix through the window's END — the ids
        the export payload carries — matching the engine-side export
        contract."""
        from generativeaiexamples_tpu_torch.serving.disagg import (
            deserialize_kv_transfer)

        body = {"prompt": list(ids)}
        if start_page:
            body["start_page"] = int(start_page)
        if max_pages:
            body["max_pages"] = int(max_pages)
        http_req = urllib.request.Request(
            self.base_url + "/v1/kv/export",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(http_req, timeout=timeout_s) as resp:
            payload = resp.read()
        if not payload:
            return None
        got_ids, codes, scales = deserialize_kv_transfer(payload)
        return codes, scales, len(got_ids)

    # graftlint: hot-path
    def import_kv_pages(self, ids, codes, scales,
                        timeout_s: float = 60.0,
                        first_page: int = 0) -> int:
        """Ship pages to the remote replica's /v1/kv/import endpoint.
        The window offset travels in the X-KV-First-Page header — the
        GKVT payload itself is unchanged, so old and new servers
        interoperate (an old server ignores the header, which only
        matters for chunked transfers it would never be asked to
        receive). Returns pages the remote engine imported."""
        from generativeaiexamples_tpu_torch.serving.disagg import (
            serialize_kv_transfer)

        headers = {"Content-Type": "application/octet-stream"}
        if first_page:
            headers["X-KV-First-Page"] = str(int(first_page))
        http_req = urllib.request.Request(
            self.base_url + "/v1/kv/import",
            data=serialize_kv_transfer(list(ids), codes, scales),
            headers=headers)
        with urllib.request.urlopen(http_req, timeout=timeout_s) as resp:
            return int(json.load(resp).get("pages", 0))

    # graftlint: hot-path
    def publish_kv_pages(self, ids, timeout_s: float = 60.0) -> int:
        """Probe/advance the remote prefill's exportable coverage via
        /v1/kv/export {"publish": true, "probe": true} — pages only,
        no payload. Returns covered full pages."""
        body = json.dumps({"prompt": list(ids), "publish": True,
                           "probe": True}).encode()
        http_req = urllib.request.Request(
            self.base_url + "/v1/kv/export", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(http_req, timeout=timeout_s) as resp:
            return int(json.load(resp).get("pages", 0))


class ProcessReplica(HttpReplica):
    """An HttpReplica whose engine-server process THIS fleet owns: the
    process-per-replica spawn lane. Same
    wire surface as any remote replica — SSE proxy, /health probes,
    the /v1/kv wire for transfers (never the device path: the engine
    lives in another address space) — plus lifecycle: stop() and
    eviction terminate the subprocess, healthy() also fails when the
    process died (no point probing a socket whose owner is gone)."""

    def __init__(self, rid: str, base_url: str, proc,
                 timeout_s: float = 300.0, probe_timeout_s: float = 2.0,
                 role: str = "mixed"):
        super().__init__(rid, base_url, timeout_s=timeout_s,
                         probe_timeout_s=probe_timeout_s, role=role)
        self.proc = proc

    def healthy(self) -> bool:
        if self.proc.poll() is not None:
            self._probe_fails += 1
            return False
        return super().healthy()

    def stop(self) -> None:
        """Terminate the worker process (SIGTERM, then SIGKILL after a
        grace period). Idempotent — park(cold)/evict/fleet.stop all
        land here."""
        if self.proc.poll() is not None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10.0)
        except Exception:
            _LOG.warning("process replica %s ignored SIGTERM; killing",
                         self.rid)
            self.proc.kill()
            try:
                self.proc.wait(timeout=5.0)
            except Exception:
                pass


def _free_port(host: str = "127.0.0.1") -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def spawn_process_replica(rid: str, *, host: str = "127.0.0.1",
                          port: int = 0, model_size: str = "tiny",
                          config_path: str = "", device: str = "",
                          ready_timeout_s: float = 120.0,
                          probe_timeout_s: float = 2.0,
                          role: str = "mixed",
                          env: Optional[Dict[str, str]] = None,
                          warm: bool = True) -> ProcessReplica:
    """Launch one engine-server subprocess (``python -m
    generativeaiexamples_tpu_torch.serving``) and block until its
    /health probe answers. The server warms at boot unless warm=False
    (ENGINE_WARMUP=0), so the replica joins the fleet ready to serve.
    `config_path` becomes the child's APP_CONFIG_FILE and `device` its
    --device (default: the card). On timeout or early exit the process
    is killed and RuntimeError raised. The child inherits this process's
    environment (APP_* overrides) plus `env`."""
    import os
    import subprocess
    import sys

    if port <= 0:
        port = _free_port(host)
    cmd = [sys.executable, "-m", "generativeaiexamples_tpu_torch.serving",
           "--host", host, "--port", str(port),
           "--model-size", model_size]
    if device:
        cmd += ["--device", device]
    penv = dict(os.environ)
    if config_path:
        penv["APP_CONFIG_FILE"] = config_path
    penv.update(env or {})
    if not warm:
        penv["ENGINE_WARMUP"] = "0"
    proc = subprocess.Popen(cmd, env=penv,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    base_url = f"http://{host}:{port}"
    deadline = time.monotonic() + ready_timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"process replica {rid} exited with code "
                f"{proc.returncode} before becoming ready")
        try:
            with urllib.request.urlopen(base_url + "/health",
                                        timeout=probe_timeout_s) as resp:
                if json.load(resp).get("status") == "healthy":
                    return ProcessReplica(
                        rid, base_url, proc,
                        probe_timeout_s=probe_timeout_s, role=role)
        except Exception:
            pass
        time.sleep(0.25)
    proc.kill()
    proc.wait(timeout=10)
    raise RuntimeError(f"process replica {rid} not ready within "
                       f"{ready_timeout_s}s")


class _ReqRecord:
    __slots__ = ("req", "rid", "est", "emitted", "started", "done",
                 "submitted", "tier")

    def __init__(self, req, rid: str):
        self.req = req
        self.rid = rid
        self.est = max(1, int(getattr(req, "max_new_tokens", 1) or 1))
        self.tier = request_tier(req)  # router tier-pressure accounting
        self.emitted = 0      # tokens delivered so far
        self.started = False  # any event delivered (requeue gate)
        self.done = False
        # replica.submit() returned: evict() may take this record over;
        # until then a racing evict leaves it for submit() to rescue.
        self.submitted = False


class _TrackedStream(queue.Queue):
    """Drop-in for GenRequest.stream that lets the fleet observe every
    event (queue depth, in-flight tokens, drain completion) without
    touching engine internals. put() is called by engine scheduler/
    pacer threads; the hook must stay cheap."""

    def __init__(self, fleet: "EngineFleet", rec: _ReqRecord):
        super().__init__()
        self._fleet = fleet
        self._rec = rec

    def put(self, item, *a, **kw):
        if isinstance(item, dict):
            self._fleet._on_event(self._rec, item)
        super().put(item, *a, **kw)


class _FleetPrefixCacheView:
    """Aggregate `prefix_cache` facade for /health (n_cached_pages
    summed over local replicas that run a real cache)."""

    def __init__(self, engines: List):
        self._engines = engines

    @property
    def n_cached_pages(self) -> int:
        return sum(e.prefix_cache.n_cached_pages for e in self._engines)


class _FleetKVPagerView:
    """Aggregate `kv_pager` facade for /health: stats() sums each
    local replica's pager counters/gauges, so a fleet whose replicas
    page KV reports enabled with fleet-wide tiers instead of
    contradicting /metrics (which sums the same kv_* keys)."""

    def __init__(self, pagers: List):
        self._pagers = pagers

    def stats(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for p in self._pagers:
            for k, v in p.stats().items():
                out[k] = out.get(k, 0) + v
        return out


class FleetMetrics:
    """Engine-shaped metrics facade over the whole fleet: snapshot()
    aggregates replica counters and merges the router's own, and the
    attribute surface /health reads (prefix_*, fused_*) sums across
    local replicas."""

    def __init__(self, fleet: "EngineFleet"):
        self._fleet = fleet

    def _sum(self, attr: str) -> int:
        return sum(getattr(r.engine.metrics, attr)
                   for r in self._fleet.local_replicas())

    prefix_hits = property(lambda self: self._sum("prefix_hits"))
    prefix_miss = property(lambda self: self._sum("prefix_miss"))
    prefix_evictions = property(lambda self: self._sum("prefix_evictions"))
    prefix_hit_tokens = property(
        lambda self: self._sum("prefix_hit_tokens"))
    fused_steps = property(lambda self: self._sum("fused_steps"))
    fused_prefill_tokens = property(
        lambda self: self._sum("fused_prefill_tokens"))
    prefill_stall_beats = property(
        lambda self: self._sum("prefill_stall_beats"))
    admission_failures = property(
        lambda self: self._sum("admission_failures"))
    qos_preemptions = property(lambda self: self._sum("qos_preemptions"))

    def snapshot(self) -> Dict[str, Any]:
        reps = self._fleet.replicas
        if any(not isinstance(r, LocalReplica) for r in reps):
            # Remote snapshots are HTTP round trips (5 s timeout each):
            # fetch them concurrently so one dead replica costs one
            # timeout per scrape, not one per replica, serially.
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(8, len(reps))) as ex:
                snaps = list(ex.map(lambda r: r.metrics_snapshot(), reps))
        else:
            snaps = [r.metrics_snapshot() for r in reps]
        per_replica = {r.rid: s for r, s in zip(reps, snaps)}
        out: Dict[str, Any] = {k: 0 for k in _COUNTER_KEYS}
        occ_num = occ_den = 0.0
        tps = 0.0
        spec_num = spec_den = 0.0
        for snap in per_replica.values():
            for k in _COUNTER_KEYS:
                out[k] += snap.get(k) or 0
            steps = snap.get("decode_steps") or 0
            occ_num += (snap.get("mean_batch_occupancy") or 0.0) * steps
            occ_den += steps
            tps += snap.get("tokens_per_sec") or 0.0
            spec_num += (snap.get("spec_tokens_per_step") or 0.0) * steps
            spec_den += steps
        out["mean_batch_occupancy"] = occ_num / occ_den if occ_den else 0.0
        out["tokens_per_sec"] = tps
        out["spec_tokens_per_step"] = (spec_num / spec_den
                                       if spec_den else 0.0)
        # Fleet-wide per-tier waiting depth: tier-wise sum over replica
        # snapshots (same always-present contract as the scalars).
        qd: Dict[str, int] = {"latency": 0, "standard": 0, "batch": 0}
        for snap in per_replica.values():
            for t, v in (snap.get("qos_queue_depth") or {}).items():
                qd[t] = qd.get(t, 0) + (v or 0)
        out["qos_queue_depth"] = qd
        # Latency histograms merge element-wise across ALL replicas
        # (local and remote — the snapshots are JSON-shaped either
        # way; one fixed bucket scheme makes the merge a sum), and the
        # fleet TTFT percentiles come from the merged histogram — the
        # always-present contract holds fleet-wide.
        from generativeaiexamples_tpu_torch.obs.tracing import (
            trace_export_errors)

        for k in flight_mod.HIST_KEYS:
            out[k] = flight_mod.merge_hist_snapshots(
                [s.get(k) for s in per_replica.values()])
        out["ttft_p50_ms"] = out["hist_ttft_ms"]["p50"]
        out["ttft_p95_ms"] = out["hist_ttft_ms"]["p95"]
        out["flight_enabled"] = max(
            (int(s.get("flight_enabled") or 0)
             for s in per_replica.values()), default=0)
        out["trace_export_errors"] = trace_export_errors()
        out.update(self._fleet.router.snapshot())
        # Control-plane counters: the fleet's own ops (autoscaler
        # decisions, upgrade rolls, fleet-thread stuck joins — added
        # ON TOP of the per-engine stop-path sum) and chaos stats
        # when a monkey is attached (zeros otherwise; the keys never
        # flicker with deployment topology).
        ops = self._fleet.ops.snapshot()
        out["stuck_thread_joins"] = ((out.get("stuck_thread_joins") or 0)
                                     + ops.pop("stuck_thread_joins"))
        out.update(ops)
        cs = self._fleet.chaos_stats
        out.update(cs.snapshot() if cs is not None
                   else dict.fromkeys(CHAOS_KEYS, 0))
        out["per_replica"] = per_replica
        return out


class EngineFleet:
    """N engine replicas + the prefix-locality router, presented to the
    OpenAI server as ONE engine-shaped object."""

    def __init__(self, replicas: List, tokenizer, page_size: int,
                 router_policy: str = "prefix",
                 affinity_ttl_s: float = 300.0,
                 load_penalty_tokens: int = 256,
                 shadow_capacity_pages: int = 4096,
                 health_interval_s: float = 0.0,
                 health_fail_threshold: int = 3,
                 replica_roles: Optional[Dict[str, str]] = None,
                 disagg: bool = False,
                 disagg_min_prompt_tokens: int = 0,
                 disagg_prefill_timeout_s: float = 120.0,
                 disagg_transfer_timeout_s: float = 60.0,
                 disagg_pipeline: bool = False,
                 disagg_device_path: bool = False,
                 disagg_transfer_chunk_pages: int = 0):
        if not replicas:
            raise ValueError("EngineFleet needs at least one replica")
        self.replicas = list(replicas)
        self.tokenizer = tokenizer
        # Disagg (serving/disagg.py): role map overrides replica-object
        # roles; with disagg on, submit() runs the two-stage plan when
        # a prefill-role replica admits, colocated otherwise.
        for r in self.replicas:
            role = (replica_roles or {}).get(r.rid)
            if role is not None:
                r.role = role
        self.disagg = bool(disagg)
        self._disagg_min_prompt_tokens = max(0,
                                             int(disagg_min_prompt_tokens))
        self._disagg_prefill_timeout_s = float(disagg_prefill_timeout_s)
        # Pipelined transfer: ship completed prefill chunks while later
        # chunks compute, the final window from a background thread so
        # decode admission beats the last chunk. Off (the default) is
        # the serialized shape.
        self._disagg_pipeline = bool(disagg_pipeline)
        # Constructed before the transfer mover so it can count device
        # fallbacks (FleetOps is self-contained — no fleet back-refs).
        self.ops = FleetOps()
        self._disagg_transfer = None
        if self.disagg:
            from generativeaiexamples_tpu_torch.serving.disagg import (
                KVPageTransfer)

            self._disagg_transfer = KVPageTransfer(
                timeout_s=disagg_transfer_timeout_s,
                chunk_pages=disagg_transfer_chunk_pages,
                device_path=disagg_device_path,
                ops=self.ops)
        self.router = PrefixLocalityRouter(
            page_size, policy=router_policy, affinity_ttl_s=affinity_ttl_s,
            load_penalty_tokens=load_penalty_tokens,
            shadow_capacity_pages=shadow_capacity_pages)
        self.metrics = FleetMetrics(self)
        # Chaos stats and an autoscaler attach here (attach_chaos /
        # attach_autoscaler); None keeps the /metrics keys zero-filled and
        # the control paths inert. build_fleet keeps an armed monkey in
        # chaos_monkey.
        self.chaos_stats = None
        self.autoscaler = None
        self.chaos_monkey = None
        # Control-plane flight lanes merged into /debug/timeline next
        # to the replica lanes: the fleet's own upgrade lane, plus
        # whatever the autoscaler/chaos controllers register. Each
        # lane has exactly ONE writer thread (the recorder contract).
        self.control_flight = FlightRecorder(ring_size=64)
        self.extra_flight_lanes: Dict[str, FlightRecorder] = {
            "fleet": self.control_flight}
        self._by_rid = {r.rid: r for r in self.replicas}
        if len(self._by_rid) != len(self.replicas):
            raise ValueError("duplicate replica ids")
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # Serializes rolling_upgrade callers (and makes the upgrade
        # lane single-writer).
        self._upgrade_lock = threading.Lock()
        # rid -> {id(req): _ReqRecord} live requests per replica.
        self._records: Dict[str, Dict[int, _ReqRecord]] = {
            r.rid: {} for r in self.replicas}
        self._health_interval_s = health_interval_s
        # Consecutive failed probes per rid: eviction fires only at
        # the threshold (one slow poll must not kill a loaded
        # replica); any success resets the count.
        self._health_fail_threshold = max(1, int(health_fail_threshold))
        self._health_fails: Dict[str, int] = {}
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_stop = threading.Event()
        self._probe_errors = 0
        for r in self.replicas:
            self.router.add_replica(
                r.rid, self_feed=not getattr(r, "has_prefix_cache", False),
                role=getattr(r, "role", "mixed"))
            r.set_reporter(self.router.reporter_for(r.rid))

    # -- engine-shaped surface (what OpenAIServer consumes) ----------------

    @property
    def ecfg(self):
        for r in self.local_replicas():
            return r.engine.ecfg
        return None

    @property
    def device(self):
        """The local replicas' device (None for a router-only fleet)."""
        for r in self.local_replicas():
            return r.engine.device
        return None

    @property
    def prefix_cache(self):
        engines = [r.engine for r in self.local_replicas()
                   if r.has_prefix_cache]
        return _FleetPrefixCacheView(engines) if engines else None

    @property
    def kv_pager(self):
        pagers = [r.engine.kv_pager for r in self.local_replicas()
                  if getattr(r.engine, "kv_pager", None) is not None]
        return _FleetKVPagerView(pagers) if pagers else None

    def local_replicas(self) -> List[LocalReplica]:
        return [r for r in self.replicas if isinstance(r, LocalReplica)]

    def flight_recorders(self) -> Dict[str, Any]:
        """rid -> FlightRecorder for every local replica — the
        /debug/timeline lanes (remote replicas serve their own
        /debug/timeline; their rings cannot cross processes) — plus
        the control-plane lanes (fleet upgrades, autoscaler, chaos)
        so TTFT spikes line up with the scale/kill events that
        caused them."""
        out = {r.rid: r.engine.flight for r in self.local_replicas()
               if getattr(r.engine, "flight", None) is not None}
        out.update(self.extra_flight_lanes)
        return out

    def attach_autoscaler(self, autoscaler) -> None:
        """Register an elastic controller (serving/autoscaler.py, which
        calls this itself): enables the scale-to-zero wake path in
        submit() and the autoscaler lifecycle under start()/stop()."""
        self.autoscaler = autoscaler

    def attach_chaos(self, stats) -> None:
        """Register a chaos monkey's counters (serving/chaos.py, which
        calls this itself) so /metrics surfaces live chaos_injected_*
        values."""
        self.chaos_stats = stats

    def submit(self, req):
        """Place and dispatch one request. Raises FleetUnavailableError
        when no replica admits; replica submit errors (e.g.
        PromptTooLongError) propagate after the tracking is unwound.
        With fleet.disagg on, the router may emit a two-stage plan:
        prefill on a prefill-role replica, KV pages transferred, then
        the decode dispatch below resumes from the transferred prefix
        via the normal prefix-cache hit path."""
        if self.disagg and \
                len(req.prompt_ids) >= self._disagg_min_prompt_tokens:
            plan = self.router.place_disagg(req.prompt_ids,
                                            getattr(req, "session_id",
                                                    ""))
            if plan is not None:
                prid, drid = plan
                if prid:
                    # Reserve the decode replica's load for the stage
                    # window: prefill + transfer take seconds, and
                    # without the reservation concurrent disagg
                    # placements would all score the same "idle"
                    # decode replica (the non-disagg path's
                    # place->note_submitted gap is microseconds).
                    est = max(1, int(getattr(req, "max_new_tokens", 1)
                                     or 1))
                    tier = request_tier(req)
                    self.router.note_submitted(drid, est, tier)
                    try:
                        # Any failure already fell back (counted) —
                        # the decode dispatch serves the stream either
                        # way, colocated at worst.
                        self._run_disagg_stages(prid, drid, req)
                    finally:
                        self.router.note_finished(drid, est, tier)
                return self._dispatch_to(drid, req)
        try:
            rid = self.router.place(req.prompt_ids,
                                    getattr(req, "session_id", ""))
        except LookupError as e:
            # Scale-to-zero wake: with an autoscaler attached, demand
            # against a fully parked fleet restores one replica and
            # retries the placement once instead of 503ing.
            scaler = self.autoscaler
            if scaler is None or not scaler.wake_for_submit():
                raise FleetUnavailableError(str(e)) from e
            try:
                rid = self.router.place(req.prompt_ids,
                                        getattr(req, "session_id", ""))
            except LookupError as e2:
                raise FleetUnavailableError(str(e2)) from e2
        return self._dispatch_to(rid, req)

    # graftlint: hot-path
    def _dispatch_to(self, rid: str, req):
        """Track + dispatch one placed request onto replica `rid`
        (the post-placement half of submit(), shared with the disagg
        decode stage)."""
        rec = _ReqRecord(req, rid)
        req.stream = _TrackedStream(self, rec)
        with self._lock:
            self._records[rid][id(req)] = rec
        self.router.note_submitted(rid, rec.est, rec.tier)
        replica = self._by_rid[rid]
        try:
            used_engine = replica.submit(req)
        except Exception:
            with self._lock:
                self._records[rid].pop(id(req), None)
            self.router.note_finished(rid, rec.est, rec.tier)
            raise
        with self._lock:
            rec.submitted = True
            # Eviction raced this submit: evict() saw an unsubmitted
            # record and left it in place for us (its takeover set only
            # contains submitted records, so exactly one side handles
            # it). The engine we just submitted to is stopped/stopping
            # — move the request to a survivor.
            raced_evict = (replica.state == "evicted"
                           and self._records[rid].pop(id(req), None)
                           is not None)
            # A rolling upgrade swapped the replica's engine while
            # this submit was in flight: the request may sit on the
            # DISCARDED old engine's queue (frozen — its threads were
            # joined before the swap), where it would never serve.
            # The swap sweep only takes records already marked
            # submitted at sweep time, and we pop under the same
            # lock, so exactly one side handles each record.
            raced_swap = (not raced_evict
                          and used_engine is not None
                          and used_engine
                          is not getattr(replica, "engine", None)
                          and self._records[rid].pop(id(req), None)
                          is not None)
        if raced_evict and not rec.done:
            try:
                # Idempotent: joins the already-stopping engine threads
                # so it can no longer emit into the stream we re-place.
                replica.stop()
            except Exception as e:
                _LOG.warning("raced-evict stop of %s failed: %s", rid, e)
            # This submit's deque entry must not survive into a
            # restore() of the evicted replica.
            self._purge(replica)
            # Same guards as evict(): a stream with delivered tokens
            # (the engine emitted before the stop joined) or an
            # un-joinable source must terminate, not replay.
            if rec.started or not getattr(replica, "supports_requeue",
                                          True):
                if not rec.done:
                    req.cancelled = True
                    req.stream.put(_error_event())
            else:
                self._requeue(rec)
        elif raced_swap and not rec.done:
            # The old engine was stopped and joined before the swap:
            # nothing can emit into this stream, so an untouched
            # request re-places cleanly; anything already delivered
            # must terminate, not replay.
            if rec.started or not getattr(replica, "supports_requeue",
                                          True):
                req.cancelled = True
                req.stream.put(_error_event())
            else:
                self._requeue(rec)
        return req

    # -- disaggregated prefill/decode (serving/disagg.py) ------------------

    # graftlint: hot-path
    def _run_disagg_stages(self, prid: str, drid: str, req) -> bool:
        """Prefill `req`'s prompt on the prefill-role replica `prid`,
        then ship the KV pages to the decode replica `drid` via
        KVPageTransfer: serialized after the whole prefill, or
        overlapped with it when disagg_pipeline is on. Returns True when the decode replica holds (at least a
        prefix of) the pages afterwards; False means the caller's
        decode dispatch serves COLOCATED on the same stream (counted
        in disagg_fallbacks) — disagg never fails a request that
        colocated serving would have carried."""
        self.ops.note_disagg()
        ok = False
        try:
            if self._disagg_pipeline:
                ok = self._run_disagg_pipelined(prid, drid, req)
            elif self._disagg_prefill(prid, req):
                pages, ms = self._disagg_transfer.transfer(
                    self._by_rid[prid], self._by_rid[drid],
                    list(req.prompt_ids),
                    page_size=self.router.page_size)
                self.ops.note_disagg_transfer(ms)
                # 0 pages without an exception: the source cached
                # nothing (falls back) — import returning 0 because
                # the target already holds the prefix was filtered by
                # place_disagg's shadow check.
                ok = pages > 0
        except Exception as e:
            _LOG.warning("disagg transfer %s->%s failed; serving "
                         "colocated: %s", prid, drid, e)
        if not ok:
            self.ops.note_disagg_fallback()
        return ok

    # graftlint: hot-path
    def _run_disagg_pipelined(self, prid: str, drid: str, req) -> bool:
        """Pipelined two-stage run: submit the prefill stage
        NON-blocking, then poll its stream while publishing the
        source's completed chunks (publish_kv_pages) and shipping
        each newly covered window to the decode replica — the
        transfer rides UNDER the prefill tail (its wall ms feeds the
        disagg_overlap_ms counter, the numerator of the
        overlap pct). After the stage finishes, the remainder ships
        in chunk windows with the FINAL window on a background
        thread (KVPageTransfer.ship_async) so the caller's decode
        admission takes its prefix-cache hit before the last chunk
        lands (disagg_early_admits); import dedup makes the late
        chunk harmless. True when at least a prefix shipped."""
        from generativeaiexamples_tpu_torch.serving.engine import GenRequest

        src = self._by_rid[prid]
        dst = self._by_rid[drid]
        mover = self._disagg_transfer
        ids = list(req.prompt_ids)
        ps = self.router.page_size
        n_full = len(ids) // ps
        if n_full <= 0:
            return False
        chunk = mover.chunk_pages or n_full
        stage = GenRequest(
            prompt_ids=ids, max_new_tokens=1, temperature=0.0,
            priority=getattr(req, "priority", "standard"),
            tenant_id=getattr(req, "tenant_id", ""),
            request_id=(req.request_id + "-prefill"
                        if getattr(req, "request_id", "") else ""))
        tier = request_tier(stage)
        self.router.note_submitted(prid, 1, tier)
        shipped = 0
        overlap_ms = transfer_ms = 0.0
        stage_ok = None
        try:
            src.submit(stage)
            deadline = time.monotonic() + self._disagg_prefill_timeout_s
            while stage_ok is None:
                left = deadline - time.monotonic()
                if left <= 0 or src.state in ("evicted", "parked"):
                    stage.cancelled = True
                    return False
                try:
                    ev = stage.stream.get(timeout=min(left, 0.05))
                    if ev.get("finished"):
                        stage_ok = ev.get("finish_reason") != "error"
                        continue
                except queue.Empty:
                    pass
                # Publish is cheap when no new chunk completed (one
                # no-op control op); each newly covered window ships
                # while the NEXT chunk computes on the source.
                covered = min(src.publish_kv_pages(ids), n_full)
                while shipped < covered:
                    t0 = time.perf_counter()
                    _, end_tokens = mover.transfer_window(
                        src, dst, ids, shipped, min(
                            chunk, covered - shipped))
                    dt = (time.perf_counter() - t0) * 1e3
                    transfer_ms += dt
                    overlap_ms += dt
                    if end_tokens // ps <= shipped:
                        break  # nothing exportable yet; next poll
                    shipped = end_tokens // ps
            if not stage_ok:
                stage.cancelled = True
                return False
            # Stage done: ship the remainder; all but the last window
            # synchronously, the last one in the background.
            while n_full - shipped > chunk:
                t0 = time.perf_counter()
                _, end_tokens = mover.transfer_window(src, dst, ids,
                                                      shipped, chunk)
                transfer_ms += (time.perf_counter() - t0) * 1e3
                if end_tokens // ps <= shipped:
                    break
                shipped = end_tokens // ps
            if shipped < n_full:
                if shipped > 0:
                    mover.ship_async(src, dst, ids, shipped)
                    self.ops.note_disagg_early_admit()
                else:
                    # Prefill beat the first poll (short prompt):
                    # degenerate to the serialized shape.
                    t0 = time.perf_counter()
                    _, end_tokens = mover.transfer_window(src, dst,
                                                          ids, 0, 0)
                    transfer_ms += (time.perf_counter() - t0) * 1e3
                    shipped = end_tokens // ps
            return shipped > 0
        except BaseException:
            stage.cancelled = True
            raise
        finally:
            self.ops.note_disagg_transfer(transfer_ms, overlap_ms)
            self.router.note_finished(prid, 1, tier)

    # graftlint: hot-path
    def _disagg_prefill(self, prid: str, req) -> bool:
        """Run the prefill stage: an internal single-token greedy
        request on the prefill replica populates its radix prefix
        cache with the prompt's full pages (the normal completed-
        prefill insert path). Blocks until the stage finishes or the
        timeout; the stage's one sampled token is discarded — the
        client's first token comes from the decode replica's suffix
        prefill, so streams stay byte-identical to colocated greedy."""
        from generativeaiexamples_tpu_torch.serving.engine import GenRequest

        stage = GenRequest(
            prompt_ids=list(req.prompt_ids), max_new_tokens=1,
            temperature=0.0,
            priority=getattr(req, "priority", "standard"),
            tenant_id=getattr(req, "tenant_id", ""),
            request_id=(req.request_id + "-prefill"
                        if getattr(req, "request_id", "") else ""))
        tier = request_tier(stage)
        replica = self._by_rid[prid]
        self.router.note_submitted(prid, 1, tier)
        try:
            replica.submit(stage)
            deadline = time.monotonic() + self._disagg_prefill_timeout_s
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    # Abandoned: cancel so the prefill engine retires
                    # the stage instead of decoding for nobody.
                    stage.cancelled = True
                    return False
                if replica.state in ("evicted", "parked"):
                    # The stage request is fleet-internal (no
                    # _ReqRecord), so evict()/park() deliver it no
                    # terminal event — bail out NOW instead of
                    # spinning out the full prefill timeout.
                    stage.cancelled = True
                    return False
                try:
                    ev = stage.stream.get(timeout=min(left, 0.25))
                except queue.Empty:
                    continue
                if ev.get("finished"):
                    return ev.get("finish_reason") != "error"
        except Exception as e:
            _LOG.warning("disagg prefill stage on %s failed: %s",
                         prid, e)
            return False
        finally:
            self.router.note_finished(prid, 1, tier)

    def set_replica_role(self, rid: str, role: str) -> None:
        """Flip one replica's disagg role at runtime (autoscaler: a
        spawned replica joins the pool that is under pressure)."""
        with self._lock:
            self._by_rid[rid].role = role
        self.router.set_role(rid, role)

    def start(self) -> "EngineFleet":
        for r in self.replicas:
            if r.state == "parked":
                continue  # cold-parked by the autoscaler: stays down
            r.start()
        if self._health_interval_s > 0:
            self._probe_thread = threading.Thread(
                target=self._probe_loop, daemon=True, name="fleet-probe")
            self._probe_thread.start()
        if self.autoscaler is not None:
            self.autoscaler.start()
        return self

    def warmup(self, **kw) -> "EngineFleet":
        for r in self.replicas:
            r.warmup(**kw)
        return self

    def stop(self) -> None:
        # Controller first: a scale decision racing the teardown would
        # restart replicas the loop below is stopping.
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=10)
            if self._probe_thread.is_alive():
                # Same contract as engine.stop(): a timed-out join is
                # logged and counted, never silently dropped.
                _LOG.warning("fleet probe thread still alive after "
                             "join timeout")
                self.ops.note_stuck_join()
            self._probe_thread = None
        # Background tail ships land before their engines stop — a
        # timed-out drain is counted like any other stuck join (the
        # tail thread is daemon; a stopped engine runs its control op
        # inline, so even a late tail cannot wedge).
        if self._disagg_transfer is not None:
            if not self._disagg_transfer.drain(timeout_s=30.0):
                _LOG.warning("KV tail ships still in flight after "
                             "drain timeout")
                self.ops.note_stuck_join()
        for r in self.replicas:
            r.stop()

    # -- stream hook (engine scheduler/pacer threads) ----------------------

    # Rides every engine scheduler/pacer emission via _TrackedStream.put.
    # graftlint: hot-path
    def _on_event(self, rec: _ReqRecord, ev: Dict[str, Any]) -> None:
        rec.started = True
        if ev.get("token_id", -1) >= 0:
            rec.emitted += 1
            self.router.note_progress(rec.rid, 1)
        if ev.get("finished") and not rec.done:
            rec.done = True
            self.router.note_finished(rec.rid,
                                      max(0, rec.est - rec.emitted),
                                      rec.tier)
            with self._cond:
                self._records.get(rec.rid, {}).pop(id(rec.req), None)
                self._cond.notify_all()

    # -- fleet operations --------------------------------------------------

    def drain(self, rid: str, timeout_s: float = 60.0) -> bool:
        """Graceful drain: stop admitting, let in-flight streams finish,
        drop the shadow tree (rebalance). The engine keeps running —
        restore(rid) re-admits it (restart story: drain, restart the
        process/engine, restore). Returns True when the replica emptied
        within the timeout."""
        replica = self._by_rid[rid]
        with self._lock:
            replica.state = "draining"
        self.router.set_admitting(rid, False)
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._records[rid]:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(left)
            emptied = not self._records[rid]
            replica.state = "drained" if emptied else "draining"
        self.router.drop_shadow(rid)
        return emptied

    def restore(self, rid: str) -> None:
        """Re-admit a drained/evicted/parked replica (its cache starts
        cold — the shadow was dropped at drain/evict/park time)."""
        replica = self._by_rid[rid]
        replica.start()
        with self._lock:
            replica.state = "active"
            self._health_fails.pop(rid, None)
        self.router.set_admitting(rid, True)

    def add_replica(self, replica, admitting: bool = True,
                    role: Optional[str] = None) -> None:
        """Register a replica at RUNTIME (the autoscaler's spawn
        path): joins the router with a fresh shadow; admitting=False
        parks it straight into the warm pool. `role` assigns a disagg
        role (default: whatever the replica object carries, "mixed"
        otherwise)."""
        if role is not None:
            replica.role = role
        with self._lock:
            if replica.rid in self._by_rid:
                raise ValueError(f"duplicate replica id {replica.rid!r}")
            self.replicas.append(replica)
            self._by_rid[replica.rid] = replica
            self._records[replica.rid] = {}
            replica.state = "active" if admitting else "warm"
        self.router.add_replica(
            replica.rid,
            self_feed=not getattr(replica, "has_prefix_cache", False),
            role=getattr(replica, "role", "mixed"))
        replica.set_reporter(self.router.reporter_for(replica.rid))
        if not admitting:
            self.router.set_admitting(replica.rid, False)

    def park(self, rid: str, timeout_s: float = 30.0,
             cold: bool = False) -> bool:
        """Scale-down: drain, then hold the replica OUT of placement —
        "warm" keeps the engine running (pre-warmed pool; restore()
        re-admits it instantly), cold=True stops it entirely (the
        scale-to-zero state). Returns False — and re-admits — when
        the drain did not empty in time: a loaded replica is never
        parked out from under its streams."""
        if not self.drain(rid, timeout_s=timeout_s):
            self.restore(rid)
            return False
        replica = self._by_rid[rid]
        if cold:
            try:
                replica.stop()
            except Exception as e:
                _LOG.warning("park stop of %s failed: %s", rid, e)
            self._purge(replica)
        with self._lock:
            replica.state = "parked" if cold else "warm"
        return True

    def rolling_upgrade(self, new_factory, drain_timeout_s: float = 60.0,
                        warmup: bool = False,
                        warmup_kw: Optional[Dict] = None) -> Dict[str, Any]:
        """Zero-loss rolling engine swap: one local replica at a time,
        drain -> steal un-admitted requests back to survivors (they
        keep their QoS tier/tenant and re-pin session affinity) ->
        swap the engine via ``new_factory(old_engine)`` -> re-warm ->
        restore. The invariant is zero failed streams and zero
        dropped requests: in-flight streams finish on the old engine
        before the swap, and a submit racing the swap is rescued by
        the engine-identity handshake in submit(). Only streams that
        outlive two drain timeouts are error-terminated (reported in
        ``failed_streams``, which should stay 0).

        Replicas in the warm/parked pool are swapped without a drain
        and return to their pool state; evicted replicas are skipped.
        Returns {replicas_rolled, requeued, failed_streams, wall_s}.
        """
        t_start = time.monotonic()
        rolled = requeued = failed = 0
        with self._upgrade_lock:
            for replica in [r for r in self.replicas
                            if isinstance(r, LocalReplica)]:
                rid = replica.rid
                prev = replica.state
                if prev == "evicted":
                    continue
                t0 = time.monotonic()
                if not self.drain(rid, timeout_s=drain_timeout_s):
                    # Shorten the tail: whatever never reached a slot
                    # re-places NOW; admitted streams keep decoding on
                    # the old engine until they finish.
                    for req in replica.steal_waiting():
                        with self._lock:
                            rec = self._records[rid].pop(id(req), None)
                        if rec is None or rec.done:
                            continue
                        if self._requeue(rec):
                            requeued += 1
                        else:
                            failed += 1
                    deadline = time.monotonic() + drain_timeout_s
                    with self._cond:
                        while self._records[rid]:
                            left = deadline - time.monotonic()
                            if left <= 0:
                                break
                            self._cond.wait(left)
                # Mark the swap BEFORE stopping the old engine: the
                # probe loop skips "upgrading" replicas, so the
                # planned stop can never count toward eviction (a
                # fast prober would otherwise evict mid-swap and
                # error-terminate the very streams this path
                # preserves); the autoscaler's wake paths only touch
                # warm/parked replicas, so nothing restarts the old
                # engine either.
                with self._lock:
                    replica.state = "upgrading"
                old = replica.engine
                try:
                    old.stop()  # joins: the old engine can never emit again
                except Exception as e:
                    _LOG.warning("upgrade stop of %s failed: %s", rid, e)
                new_engine = new_factory(old)
                with self._lock:
                    replica.engine = new_engine
                    # Sweep the stragglers (streams that outlived both
                    # waits, plus anything evict()-style racing): only
                    # records marked submitted — an in-flight submit
                    # that hasn't set the flag detects the swap itself
                    # (engine-identity check) and handles its own
                    # record.
                    recs = self._records[rid]
                    takeover = [r_ for r_ in recs.values() if r_.submitted]
                    self._records[rid] = {id(r_.req): r_
                                          for r_ in recs.values()
                                          if not r_.submitted}
                for rec in takeover:
                    if rec.done:
                        continue
                    if rec.started:
                        # Tokens already delivered: replaying on the
                        # new engine would duplicate output.
                        rec.req.cancelled = True
                        rec.req.stream.put(_error_event())
                        failed += 1
                    elif self._requeue(rec):
                        requeued += 1
                    else:
                        failed += 1
                replica.set_reporter(self.router.reporter_for(rid))
                if warmup:
                    try:
                        replica.warmup(**(warmup_kw or {}))
                    except Exception:
                        # A half-warmed engine (some lattice points
                        # captured, the rest not) never serves: the
                        # replica leaves placement unstarted and the
                        # failure reaches the caller.
                        _LOG.exception("upgrade warmup of %s failed; "
                                       "evicting it", rid)
                        self.evict(rid)
                        raise
                if prev == "parked":
                    with self._lock:
                        replica.state = "parked"
                else:
                    replica.start()
                    if prev == "warm":
                        with self._lock:
                            replica.state = "warm"
                    else:
                        self.restore(rid)
                rolled += 1
                self.control_flight.record_event(
                    EV_UPGRADE, time.perf_counter(), aux=rid,
                    a=float(len(self.replicas)),
                    b=(time.monotonic() - t0) * 1e3)
            self.ops.note_upgrade_roll(rolled)
        return {"replicas_rolled": rolled, "requeued": requeued,
                "failed_streams": failed,
                "wall_s": round(time.monotonic() - t_start, 3)}

    def evict(self, rid: str) -> int:
        """Remove a failed replica from placement: requeue its
        not-yet-started requests onto the survivors, terminate its
        mid-stream requests with an error event (their KV died with
        the replica; replaying a half-delivered stream would duplicate
        output). Returns the number of requests requeued."""
        replica = self._by_rid[rid]
        self.router.set_admitting(rid, False)
        with self._lock:
            replica.state = "evicted"
            recs = self._records[rid]
            takeover = [r for r in recs.values() if r.submitted]
            # Records whose submit() is still in flight stay behind:
            # that submit observes the evicted state under this lock
            # and rescues its own request (exactly one side handles
            # each record).
            self._records[rid] = {id(r.req): r for r in recs.values()
                                  if not r.submitted}
        self.router.note_evicted(rid)
        self.router.drop_shadow(rid)
        # Stop the dead engine BEFORE touching its requests' streams:
        # once its scheduler/reader threads are joined, nothing can
        # emit into a stream that is about to be re-placed (a requeue
        # racing a half-alive scheduler would duplicate output).
        try:
            replica.stop()
        except Exception as e:
            _LOG.warning("evicted replica %s stop failed: %s", rid, e)
        self._purge(replica)
        requeued = 0
        can_requeue = getattr(replica, "supports_requeue", True)
        for rec in takeover:
            if rec.done:
                continue
            if rec.started or not can_requeue:
                # Tokens already delivered (replay would duplicate
                # output), or the replica type can't guarantee its
                # stream source is dead (HttpReplica zombie proxy).
                # cancelled also pins any slot still parked on the
                # stopped engine: a later restore() finishes it
                # instantly instead of resuming a terminated stream.
                # (Requeued requests must NOT be cancelled — the
                # survivor serves them; purge_waiting above already
                # removed their deque entries.)
                rec.req.cancelled = True
                rec.req.stream.put(_error_event())
                continue
            if self._requeue(rec):
                requeued += 1
        return requeued

    @staticmethod
    def _purge(replica) -> None:
        """Drop a stopped replica's queued requests so restore() can't
        replay them (local replicas only; remote processes own their
        own queues)."""
        purge = getattr(replica, "purge_waiting", None)
        if purge is not None:
            try:
                purge()
            except Exception as e:
                _LOG.warning("purge of %s failed: %s", replica.rid, e)

    def _requeue(self, rec: _ReqRecord) -> bool:
        """Re-place one untouched request from an evicted replica. Its
        tracked stream is kept — no events were delivered."""
        self.router.note_finished(rec.rid, rec.est, rec.tier)
        try:
            rid = self.router.place(rec.req.prompt_ids,
                                    getattr(rec.req, "session_id", ""))
        except LookupError:
            # The old rid's accounting was settled above; mark the
            # record done BEFORE the terminal event so _on_event
            # doesn't note_finished a second time.
            rec.done = True
            rec.req.stream.put(_error_event())
            return False
        rec.rid = rid
        with self._lock:
            self._records[rid][id(rec.req)] = rec
        self.router.note_submitted(rid, rec.est, rec.tier)
        try:
            self._by_rid[rid].submit(rec.req)
        except Exception as e:
            _LOG.warning("requeue to %s failed: %s", rid, e)
            with self._lock:
                self._records[rid].pop(id(rec.req), None)
            self.router.note_finished(rid, rec.est, rec.tier)
            rec.done = True  # settled here; _on_event must not repeat it
            rec.req.stream.put(_error_event())
            return False
        self.router.note_requeued()
        return True

    def check_health(self) -> Dict[str, bool]:
        """Probe every non-evicted replica; evict a replica only after
        `health_fail_threshold` CONSECUTIVE failed probes (any success
        resets the count) — one slow poll must not kill a loaded
        replica. HttpReplica probes additionally use their own short
        deadline, backed off with consecutive failures. Returns
        rid -> this round's probe result."""
        out = {}
        for r in self.replicas:
            if r.state == "evicted":
                out[r.rid] = False
                continue
            if r.state in ("parked", "upgrading"):
                # Intentionally down: cold-parked by the autoscaler
                # (scale-to-zero) or mid-engine-swap in a rolling
                # upgrade — probing now would count a planned stop
                # toward eviction.
                out[r.rid] = True
                continue
            try:
                ok = bool(r.healthy())
            except Exception as e:
                _LOG.warning("health probe of %s raised: %s", r.rid, e)
                ok = False
            out[r.rid] = ok
            if ok:
                with self._lock:
                    self._health_fails.pop(r.rid, None)
                continue
            with self._lock:
                fails = self._health_fails.get(r.rid, 0) + 1
                self._health_fails[r.rid] = fails
            if fails >= self._health_fail_threshold:
                _LOG.warning("fleet replica %s failed %d consecutive "
                             "health probes; evicting", r.rid, fails)
                self.evict(r.rid)
                with self._lock:
                    self._health_fails.pop(r.rid, None)
            else:
                _LOG.warning("fleet replica %s failed health probe "
                             "(%d/%d)", r.rid, fails,
                             self._health_fail_threshold)
        return out

    def _probe_loop(self) -> None:
        while not self._probe_stop.wait(self._health_interval_s):
            try:
                self.check_health()
            except Exception:
                # Counted and logged, never silent: a sick
                # probe loop must show up in /health, not vanish.
                _LOG.exception("fleet health probe failed")
                with self._lock:
                    self._probe_errors += 1

    def fleet_health(self) -> Dict[str, Any]:
        """/health "fleet" section: replica states + drain flags +
        consecutive probe failures, plus the elastic control plane
        (autoscaler/chaos) — always-present subsections, enabled
        false when nothing is attached."""
        depths = self.router.queue_depths()
        with self._lock:
            replicas = {
                r.rid: {
                    "state": r.state,
                    "role": getattr(r, "role", "mixed"),
                    "draining": r.state == "draining",
                    "queue_depth": depths.get(r.rid, 0),
                    "probe_fails": self._health_fails.get(r.rid, 0),
                } for r in self.replicas}
            probe_errors = self._probe_errors
        scaler = self.autoscaler
        ops = self.ops.snapshot()
        return {"enabled": True, "replicas": replicas,
                "router_policy": self.router.policy,
                "probe_errors": probe_errors,
                "health_fail_threshold": self._health_fail_threshold,
                # Always-present disagg subsection (enabled false,
                # zeros, when fleet.disagg is off — the counter
                # convention): plans emitted, two-stage runs, and
                # colocated fallbacks.
                "disagg": {
                    "enabled": self.disagg,
                    "plans": self.router.router_disagg_plans,
                    "requests": ops["disagg_requests"],
                    "fallbacks": ops["disagg_fallbacks"],
                },
                "autoscale": (scaler.health() if scaler is not None
                              else {"enabled": False}),
                "chaos": {"enabled": self.chaos_stats is not None}}


def build_fleet(cfg, engines: Optional[List] = None, tokenizer=None,
                engine_factory=None, spawn_kw: Optional[Dict] = None):
    """Wire an EngineFleet from the [fleet] config section.

    `engines`: local LLMEngines (r0..rN). With `cfg.fleet.replica_urls`
    set, the fleet also (or, with no engines, only) fronts remote
    engine-server processes (h0..hM), and `tokenizer` must be given when
    there is no local engine. With `fleet.autoscale` an autoscaler
    attaches: `engine_factory` (zero arguments -> LLMEngine) is its spawn
    lane, or with `fleet.autoscale_spawn` "process" an engine-server
    subprocess a spawn (`spawn_kw`: spawn_process_replica's model_size
    and device); without either it can still park and wake the existing
    replicas. With `fleet.chaos` the fleet carries an armed, idle
    ChaosMonkey in `chaos_monkey`."""
    fcfg = cfg.fleet
    replicas: List = []
    if engines:
        tokenizer = tokenizer or engines[0].tokenizer
        replicas += [LocalReplica(f"r{i}", e) for i, e in enumerate(engines)]
    for i, url in enumerate(u for u in
                            (fcfg.replica_urls or "").split(",") if u.strip()):
        replicas.append(HttpReplica(f"h{i}", url.strip(),
                                    probe_timeout_s=fcfg.probe_timeout_s))
    if tokenizer is None:
        raise ValueError("remote-only fleet needs an explicit tokenizer")
    # Positional role list ("prefill,decode,..."): entry i tags replica i
    # (locals first, then remotes); unlisted replicas stay "mixed". The
    # router rejects unknown role names at add time.
    roles = [x.strip() for x in (fcfg.replica_roles or "").split(",")
             if x.strip()]
    role_map = {r.rid: roles[i] for i, r in enumerate(replicas)
                if i < len(roles)}
    page_size = engines[0].ecfg.page_size if engines else \
        cfg.engine.page_size
    fleet = EngineFleet(
        replicas, tokenizer, page_size,
        router_policy=fcfg.router_policy,
        affinity_ttl_s=fcfg.affinity_ttl_s,
        load_penalty_tokens=fcfg.load_penalty_tokens,
        shadow_capacity_pages=fcfg.shadow_capacity_pages,
        health_interval_s=fcfg.health_interval_s,
        health_fail_threshold=fcfg.health_fail_threshold,
        replica_roles=role_map,
        disagg=fcfg.disagg,
        disagg_min_prompt_tokens=fcfg.disagg_min_prompt_tokens,
        disagg_prefill_timeout_s=fcfg.disagg_prefill_timeout_s,
        disagg_transfer_timeout_s=fcfg.disagg_transfer_timeout_s,
        disagg_pipeline=fcfg.disagg_pipeline,
        disagg_device_path=fcfg.disagg_device_path,
        disagg_transfer_chunk_pages=fcfg.disagg_transfer_chunk_pages)
    if fcfg.autoscale:
        from generativeaiexamples_tpu_torch.serving.autoscaler import (
            FleetAutoscaler)

        replica_factory = None
        if fcfg.autoscale_spawn == "process":
            # Each scale-up launches an engine-server subprocess and joins
            # it as a ProcessReplica once its /health answers. The child
            # reads this process's APP_CONFIG_FILE and APP_* env, with the
            # fleet turned off: it serves one engine, and never spawns.
            child_env = {"APP_FLEET_REPLICAS": "1",
                         "APP_FLEET_REPLICAURLS": "",
                         "APP_FLEET_AUTOSCALE": "false",
                         "APP_FLEET_CHAOS": "false"}

            def replica_factory(rid: str, role: str) -> ProcessReplica:
                return spawn_process_replica(
                    rid, role=role, env=child_env,
                    ready_timeout_s=fcfg.autoscale_spawn_ready_timeout_s,
                    probe_timeout_s=fcfg.probe_timeout_s,
                    **(spawn_kw or {}))

        FleetAutoscaler(
            fleet, engine_factory=engine_factory,
            replica_factory=replica_factory,
            min_replicas=fcfg.autoscale_min_replicas,
            max_replicas=fcfg.autoscale_max_replicas,
            warm_pool=fcfg.autoscale_warm_pool,
            interval_s=fcfg.autoscale_interval_s,
            up_depth=fcfg.autoscale_up_depth,
            down_depth=fcfg.autoscale_down_depth,
            up_ticks=fcfg.autoscale_up_ticks,
            down_ticks=fcfg.autoscale_down_ticks,
            cooldown_s=fcfg.autoscale_cooldown_s,
            scale_to_zero=fcfg.autoscale_scale_to_zero,
            up_queue_wait_p95_ms=fcfg.autoscale_up_queue_wait_p95_ms,
            up_ttft_p95_ms=fcfg.autoscale_up_ttft_p95_ms)
    if fcfg.chaos:
        from generativeaiexamples_tpu_torch.serving.chaos import ChaosMonkey

        # Armed but idle: live counters and a timeline lane; faults fire
        # only when a drill runs a schedule.
        fleet.chaos_monkey = ChaosMonkey(fleet, seed=fcfg.chaos_seed)
    return fleet
