"""Continuous-batching LLM engine over one CUDA device (or the CPU).

Counterpart of the core scheduler of
generativeaiexamples_tpu/serving/engine.py: paged KV cache, batched
bucketed prefill, slot-based continuous batching, per-request sampling
parameters and token streams for SSE.

Scheduling model (one scheduler thread, the only writer of slot, page
and device state):

  submit() -> waiting deque
  loop:  admit waiting requests (same-bucket admissions prefill in ONE
         batched dispatch, first tokens sampled on the device; a prompt
         longer than the largest bucket starts a chunked prefill);
         advance chunked prefills (at most prefill_chunks_per_block
         chunks per landed decode block while streams decode, one per
         iteration when idle); keep up
         to pipeline_depth K-step decode blocks in flight over all
         active slots (fixed batch shape, inactive slots masked to the
         page-0 sink, sampling on the device, tokens chained on the
         device); land the OLDEST block: wait for its CUDA event, then
         emit / retire from the host copy.

Every device result the host reads (a decode block, a prefill group's
first tokens) is copied to pinned host memory with a non-blocking copy
and a CUDA event recorded behind it; the host reads it only once the
event has completed, admitting new arrivals while it waits.

Chunked prefill: a long prompt's chunks run through a contiguous
scratch KVCache (the first rows of the engine's static scratch) with
offset queries, and ONE scatter (the commit) moves the cache into the
sequence's pages. The chunk that completes the prompt
samples the first token inside the same dispatch; a finish whose last
chunk did not sample samples from its logits at the commit
(`sample_token_into`, or with `fused_sampling` off the unfused
`sample_token` + `set_last_token` pair).

Fused prefill rider (`fused_prefill`): while streams decode, the next
chunk (`_fused_width` tokens, at most `fused_token_budget`) of an
in-progress long prefill rides inside the decode dispatch
(`engine_model.fused_decode_prefill_step`) instead of going out as a
standalone chunk forward ahead of the decode blocks; the chunked lane
above is then the fallback (an idle engine, a scratch cache narrower
than the rider, a speculative engine without `step_plans`). With
`step_plans` a speculative engine's rider rides inside its verify
blocks (`engine_model.fused_spec_prefill_step`). Every dispatch, decode
block or chunk, is an `engine_model.StepPlan` lowered by
`engine_model.plan_step`. `prefill_stall_beats` counts landed blocks
over which a live prefill fed no token.

int8 serving (`kv_dtype="int8"`, `quantize_weights="int8"`): the pool is
the fused `QuantPagePool` (decode attention through K4) and the params
must come quantized (`ops.quant.quantize_llama_params`; every projection
through K6); the chunked lane's scratch cache stays in the model dtype
and is quantized as it is scattered into the pool.

Greedy self-speculation (`speculative_k > 0`, tree verify with
`speculative_tree_branches > 1`): decode blocks become verify blocks
(`engine_model.decode_spec_multi_step`) that draft from a device token
history (`_history`, seeded at admission) and commit a variable number
of tokens per step, so lengths are device-authoritative
(`_dev_lengths`). The host reserves pages for the worst case
(`_Slot.kv_len + kv_worst`) and reconciles when a block lands. While a
sampled request is live, dispatches fall back to the plain block over
the same device state (`decode_plain_spec_state_multi_step`), which
never carries a rider.

Prefix cache (`prefix_cache`, serving/prefix_cache.py): admission looks
the prompt up in a radix tree of cached full pages, adopts the longest
cached prefix (shared pages read-only, a partial tail page copy-on-
write), seeds a scratch cache from those pages (`pool_to_cache`) and
runs only the suffix through the chunked lane with its queries offset by
the cached length. The finish scatter points the shared pages' rows at
the sink, so they are never rewritten; completed prefills insert their
full pages. The allocator's reclaim hook evicts cold cached pages when
live traffic runs short. With `kv_pager` (serving/kv_pager.py) eviction
demotes pages to host RAM and a disk spill instead, and a match promotes
them back with one scatter.

Tracing (obs/tracing.py): each request gets an `engine.generate` span,
opened at its prefill commit and parented onto `GenRequest.trace_context`
(the caller's context: the scheduler thread is another thread), with a
`first_token` event carrying the TTFT and, at retire, the tokens
generated and the device memory counters. With tracing off every site is
a no-op.

Flight recorder (serving/flight.py, `flight_recorder`, on by default):
every landed block writes one beat record (dispatch and host-ready
stamps, the block's StepPlan, busy slots, queue depth, tokens emitted,
pager pages moved) and each request its lifecycle events (submit,
admit, prefill dispatch or chunks, first token, retire), into
preallocated rings served as Chrome trace JSON at /debug/timeline. The
latency histograms (TTFT, e2e, queue wait per tier, beat gap, promote
and transfer ms a page) are always live; `ttft_p50_ms` / `ttft_p95_ms`
are read from the TTFT histogram, as in the JAX engine.

QoS (`qos`, serving/qos.py): requests carry a tier (`priority`) and a
tenant; admission pops the TierScheduler's weighted-fair pick instead
of the queue's head, and while an admitted latency-tier request is
prefilling or awaiting its first token, lower-tier long prefills pause
at the beat boundary (no chunk, no rider) and resume where they stood.
Off, admission is FIFO.

KV page transfer (serving/disagg.py, the fleet's disaggregated
prefill/decode): `run_control_op` runs a closure on the scheduler
thread, the single owner of the tree, the allocator and the pool;
`export_prefix_pages` / `export_prefix_pages_device` gather a cached
prefix's pages (to host memory, or as device tensors),
`publish_prefill_pages` makes an in-flight chunked prefill's completed
pages exportable, and `import_prefix_pages` seats transferred pages with
one scatter and inserts them into the radix tree, so the next admission
of that prompt takes the normal hit path.

Emission pacer (`pace_emission_max_streams`, 16 by default as in the
JAX engine): while few streams decode, a landed block's K-token bursts
are handed to a pacer thread that spreads them over the observed block
interval (at most 100 ms a token). A slot's first token is never paced,
and a terminal event or the slot's next burst flushes whatever the pacer
still holds first, so every stream stays in order. Unlike the JAX pacer,
the fast path that delivers a burst directly (blocks landing less than
4 ms a token apart) also flushes the slot's pending entry first.

Memory planner (`auto_pool_pages`, serving/memory_plan.py): with no
`n_pages` given, the pool holds the pages the plan fits beside the
weights, the scratch and activation estimates and the headroom;
`memory_plan` keeps the plan and `/metrics` its headroom.

Warmup (`warmup`, the JAX engine's lattice): prefill per bucket, group
size and sampling flags, the decode / verify / sampled-fallback blocks
per K, with `long_prompts` the chunked lane's shapes and the rider's;
the warmed points are recorded (`_warm_*`; `plan_variants_compiled`)
and from then on the dispatcher picks only warmed block lengths, chunk
widths and rider shapes, as the JAX engine does (an engine never warmed
picks any). On one CUDA device the whole lattice is captured as CUDA
graphs (serving/step_graphs.py): decode blocks, prefill groups, chunks
and the hit chain's gather, scatter and finish sampler; a rider or a
composed plan replays a chunk's graph and a block's. What stays eager,
and why, is listed there; `metrics.eager_prefill_dispatches` and
`eager_chunk_dispatches` count a warmed engine's eager ones. The first
time a long prompt or a hit arrives at a scratch length the warmup did
not capture, its chunk, seed and commit graphs are captured at
admission (`_capture_first_sight`), as the JAX engine compiles a cold
shape once on first sight; the dispatcher's warmed sets do not change.

Chunked prompts and prefix hits share ONE static scratch cache of page
capacity's rows plus one sink row (`_scratch`, the memory planner's
long_prefill_scratch line); a prompt of scratch length S_total uses its
first S_total rows. Chunks and riders dispatch the JAX engine's widths:
a padded chunk that passes S_total (a hit's suffix) writes its rows past
the end to the sink, where JAX's scatter drops them.

Chaos (serving/chaos.py): `chaos_beat_delay_s` sleeps at the top of each
scheduler iteration (a slow replica); 0.0 costs one float compare.

Tensor parallelism over rank processes (`mesh`, `engine.multihost`;
serving/sharding.py, serving/multihost.py): each rank process builds an
engine over its shard of the params, with the rank's local head counts
(`sharding.local_config`) and a pool of its kv heads. Rank 0 runs this
scheduler and publishes a record of every device dispatch before
launching it; the follower ranks replay the records through the same
executors (`_exec_prefill`, `_exec_plan`, `_exec_seed`, `_exec_commit`,
`_exec_pages_out`, `_exec_pages_in`, `_exec_publish_pages`, and the
pager's `_exec_pager_out` / `_exec_pager_in`; `_mh_replay_table`), so the
model's collectives pair up by launch order. Each executor builds its
device inputs from the record alone. Sampling runs on the gathered
logits with the same generator seed on every rank, so every rank draws
the same token. Every StepPlan replays: verify blocks (linear and tree),
the sampled request's plain fallback, composed plans and the fused
rider, whose scratch cache each rank makes at the record's `fresh` mark
with its own kv heads; the history rows a speculative engine keeps are
set by the `prefill` and `commit` records on every rank alike.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch import kernels
from generativeaiexamples_tpu_torch.config.schema import EngineConfig
from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.models.llama import KVCache, LlamaConfig
from generativeaiexamples_tpu_torch.obs import tracing
from generativeaiexamples_tpu_torch.ops.quant import is_quantized
from generativeaiexamples_tpu_torch.parallel import mesh as mesh_lib
from generativeaiexamples_tpu_torch.serving import engine_model
from generativeaiexamples_tpu_torch.serving import sharding as shd
from generativeaiexamples_tpu_torch.serving import step_graphs
from generativeaiexamples_tpu_torch.serving.disagg import page_geometry
from generativeaiexamples_tpu_torch.serving.fleet import (
    CHAOS_KEYS, FLEET_OPS_KEYS)
from generativeaiexamples_tpu_torch.serving.flight import (
    EV_ADMIT, EV_ADMIT_RETRY, EV_FIRST_TOKEN, EV_KV_DEMOTE, EV_KV_PROMOTE,
    EV_KV_TRANSFER, EV_PREFILL_CHUNK, EV_PREFILL_DISPATCH, EV_QOS_PAUSE,
    EV_QOS_PICK, EV_QOS_RESUME, EV_RETIRE, EV_SUBMIT, FLIGHT_KEYS, HIST_KEYS,
    RETIRE_CODES, ExpHistogram, FlightRecorder)
from generativeaiexamples_tpu_torch.serving.kv_cache import (
    PageAllocator, PagePool, SequencePages)
from generativeaiexamples_tpu_torch.serving.kv_pager import (
    _RAW_DTYPES, KV_PAGER_KEYS, KVPager, PagedPrefixCache, gather_spans)
from generativeaiexamples_tpu_torch.serving.prefix_cache import (
    TIER_DEVICE, TIER_DISK, TIER_HOST, RadixPrefixCache)
from generativeaiexamples_tpu_torch.serving.qos import (
    TierScheduler, request_tier, tier_id)
from generativeaiexamples_tpu_torch.serving.router import ROUTER_COUNTER_KEYS
from generativeaiexamples_tpu_torch.utils.tokenizer import StreamDetokenizer

_LOG = logging.getLogger(__name__)

# The device memory counters that decorate a retired request's span are
# read at the first retirement and then every Nth (the spans between
# carry the cached reading), as the JAX engine does.
MEMSTATS_SAMPLE_EVERY = 32

# Failed admissions (page exhaustion) a request may retry while nothing
# in flight could free pages, before it is failed with an error event.
MAX_ADMISSION_RETRIES = 64

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


def _pow2_floor(n: int) -> int:
    """Largest power of two <= max(n, 1): decode block lengths."""
    return 1 << (max(n, 1).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= max(n, 1): page gather/scatter widths."""
    return 1 << (max(n, 1) - 1).bit_length()


_GREEDY, _SAMPLED = step_graphs.GREEDY, step_graphs.SAMPLED


def _sampling_flags(all_greedy: bool):
    """sample()'s (all_greedy, any_top_k, any_top_p) for a batch: an
    all-greedy batch skips the sorts and the draw."""
    return _GREEDY if all_greedy else _SAMPLED


class PromptTooLongError(ValueError):
    """Prompt longer than the engine's page capacity minus one generated
    token; refused at submit() so callers reject it at the API boundary.
    Prompts beyond the largest prefill bucket but within that capacity
    go through chunked prefill."""


@dataclasses.dataclass
class GenRequest:
    prompt_ids: List[int]
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    stop_ids: Sequence[int] = ()
    stream: "queue.Queue[Dict[str, Any]]" = dataclasses.field(
        default_factory=queue.Queue)
    submit_time: float = dataclasses.field(default_factory=time.perf_counter)
    request_id: str = ""
    # Session identity for fleet routing (OpenAI `user` field /
    # x-session-id header): the router pins a session to the replica
    # holding its conversation KV. Unused by a single engine.
    session_id: str = ""
    # QoS tier (serving/qos.py: latency | standard | batch; anything else
    # counts as standard) and tenant (`user` / x-tenant-id). Inert with
    # engine.qos off.
    priority: str = "standard"
    tenant_id: str = ""
    admission_attempts: int = 0
    cancelled: bool = False  # set by the server on disconnect / stop string
    truncate_prompt: bool = False  # opt-in: keep the tail instead of refusing
    trace_context: Any = None  # the caller's trace context (obs/tracing.py)
    # The flight recorder logs the submit at the first admission pop
    # (scheduler thread); a requeued request is not logged again.
    flight_seen: bool = False


class _Slot:
    def __init__(self, req: GenRequest, seq: SequencePages, detok,
                 span=None):
        self.req = req
        self.seq = seq
        self.detok = detok
        self.span = span  # tracing.ManualSpan, or None for a placeholder
        self.generated = 0
        # Tokens DISPATCHED (prefill token + K per decode block joined),
        # in flight included: caps K so no block runs past max_new_tokens.
        self.scheduled = 1
        self.prompt_len = len(req.prompt_ids)
        self.awaiting_first = True   # until the slot joins a decode block
        self.first_emitted = False   # first token reached the stream
        self.no_capacity = False     # starved; finished after the drain
        self.prefilling = False      # placeholder of a chunked prefill
        # Emission pacer: this block's held-back token events, and when
        # the slot's previous block landed (the pacing interval).
        self.pace_buf: List[Dict[str, Any]] = []
        self.pace_last_land = 0.0
        # Speculative engines: tokens whose KV is known stored (moved at
        # landing) and the worst-case tokens of blocks still in flight;
        # pages must cover kv_len + kv_worst.
        self.kv_len = self.prompt_len
        self.kv_worst = 0


class _LongPrefill:
    """In-progress chunked prefill for one long prompt. While other
    streams are decoding, its chunks ride inside the decode dispatches
    (fused_prefill), or the chunked lane advances it at most
    prefill_chunks_per_block chunks per LANDED decode block (the `beat`
    counter), so chunk dispatches interleave with decode blocks on the
    device queue; with no live decode traffic chunks run at full
    dispatch speed. The scratch cache lives in
    engine._scratch_caches[slot_idx] from the first chunk on."""

    __slots__ = ("req", "slot_idx", "seq", "ids", "s_total", "pos", "slot",
                 "beat", "chunk", "stall_pos", "tier", "paused", "published")

    def __init__(self, req, slot_idx, seq, ids, s_total, slot, chunk):
        self.req = req
        self.slot_idx = slot_idx
        self.seq = seq
        self.ids = ids
        self.s_total = s_total  # scratch-cache length (chunk multiple)
        self.pos = 0            # next prompt offset to feed
        self.slot = slot        # the placeholder occupying slots[slot_idx]
        self.beat = -1          # beat at which the last chunk dispatched
        self.chunk = chunk      # chunk width: the largest bucket
        self.stall_pos = -1     # pos at the last beat (prefill_stall_beats)
        # QoS: the request's tier, and whether a latency-tier TTFT phase
        # holds this prefill paused (pos and the scratch cache are its
        # whole state, so a resume is byte-identical).
        self.tier = request_tier(req)
        self.paused = False
        # Full pages already scattered into the pool and inserted into
        # the tree by publish_prefill_pages; the finish sinks their rows.
        self.published = 0


class HostCopy:
    """A device tensor on its way to pinned host memory: the copy and an
    event recorded behind it are queued on the current stream. On the
    CPU the tensor is already there."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _InFlight:
    """One dispatched-but-unprocessed decode block."""

    __slots__ = ("copy", "metas", "K", "releases", "spec_worst",
                 "t_dispatch", "plan")

    def __init__(self, block: torch.Tensor, metas, K: int,
                 plan: "engine_model.StepPlan", t_dispatch: float,
                 spec_worst: int = 0):
        # Plain blocks: [B, K + 1] tokens. Speculative blocks: [B, K,
        # k + 2], the targets of each step with its count appended.
        self.copy = HostCopy(block)
        self.metas = metas             # [(slot_idx, slot, first_col | base)]
        self.K = K
        # > 0 marks a speculative block: the worst-case tokens per slot
        # (K * (k + 1)), refunded down to the accepted ones at landing.
        self.spec_worst = spec_worst
        self.releases: List[SequencePages] = []  # freed once this lands
        # plan_step's dispatch-return stamp and the block's StepPlan (the
        # flight recorder's beat record).
        self.t_dispatch = t_dispatch
        self.plan = plan


class EngineMetrics:
    """Serving metrics: TTFT, tokens/s, batch occupancy, kernel launches.
    Written by the scheduler thread; read by scrapes."""

    RATE_WINDOW_S = 30.0

    def __init__(self):
        # Exponential-bucket latency histograms (serving/flight.py), one
        # per HIST_KEYS key without its "hist_" prefix; single writer
        # (the scheduler thread observes, scrapes copy).
        self.hists = {k[len("hist_"):]: ExpHistogram() for k in HIST_KEYS}
        self.tokens_out = 0
        self.decode_steps = 0
        self.busy_slots_acc = 0
        self.prefill_tokens = 0
        # Fused prefill rider: decode dispatches that carried a prompt
        # chunk, the prompt tokens they fed, and landed blocks (beats)
        # over which a live chunked prefill fed no token. Always present,
        # 0 when the rider is off.
        self.fused_steps = 0
        self.fused_prefill_tokens = 0
        self.prefill_stall_beats = 0
        # Prefill finishes whose first-token sample rode one call: the
        # prompt-completing chunk's tail or sample_token_into at the
        # commit (0 with fused_sampling off, and on bucketed-only
        # traffic, whose groups always sample in their dispatch).
        self.fused_sample_dispatches = 0
        self.admission_failures = 0
        self.stuck_thread_joins = 0
        # Speculation: committed tokens over slot-steps (the tokens-per-
        # step gauge: 1.0 = no draft accepted, k + 1 = all), and plain
        # fallback dispatches while a sampled request was live.
        self.spec_committed = 0
        self.spec_slot_steps = 0
        self.spec_fallback_steps = 0
        # Prefix cache: lookups that adopted cached pages / found
        # nothing, pages evicted (demoted with the pager), prompt tokens
        # whose prefill the cache skipped; and the host time the pager's
        # promotions took. Always present, 0 when the cache is off.
        self.prefix_hits = 0
        self.prefix_miss = 0
        self.prefix_evictions = 0
        self.prefix_hit_tokens = 0
        self.kv_promote_ms = 0.0
        # Disaggregated prefill/decode: pages this engine imported, the
        # host ms those imports took, pages that came over the device
        # path, and import control ops (one per transfer window).
        self.kv_transfer_pages = 0
        self.kv_transfer_ms = 0.0
        self.kv_transfer_device_pages = 0
        self.kv_transfer_chunks = 0
        # QoS: lower-tier long prefills paused for a latency-tier TTFT
        # phase, and the waiting requests per tier (maintained with QoS
        # off too). Always present.
        self.qos_preemptions = 0
        self.qos_queue_depth = {"latency": 0, "standard": 0, "batch": 0}
        # Per-device bytes the memory planner left unallocated (0 without
        # a plan). Always present.
        self.planner_headroom_bytes = 0
        # Tensor-parallel replay (serving/multihost.py; always present, 0
        # on one process): the rank processes the engine spans, records
        # rank 0 published (digests and stop included), and divergences
        # the replay detector raised on this rank.
        self.multihost_processes = 0
        self.replay_records_published = 0
        self.replay_divergence = 0
        # Plan variants compiled at warmup (JAX's jitted step lattice).
        # Always present, 0: an eager engine compiles none.
        self.plan_variants_compiled = 0
        # Prefill groups and chunk dispatches a warmed CUDA engine ran op
        # by op rather than as a CUDA graph (serving/step_graphs.py): a
        # shape outside the warmed lattice, or an engine without graphs.
        # Always present, 0 on the CPU and on a never-warmed engine.
        self.eager_prefill_dispatches = 0
        self.eager_chunk_dispatches = 0
        # The pager's stats() (KV_PAGER_KEYS); None when it is off.
        self.kv_pager_stats = None
        # The flight recorder's stats() (FLIGHT_KEYS); None emits zeros.
        self.flight_stats = None
        # The most recent request's time to first token (None before any).
        self.last_ttft_ms: Optional[float] = None
        self._token_events: deque = deque(maxlen=8192)
        self._lock = threading.Lock()

    def record_ttft(self, ms: float) -> None:
        # Scheduler thread only (single writer, like every histogram).
        self.hists["ttft_ms"].observe(ms)
        self.last_ttft_ms = ms

    def record_tokens(self, n: int) -> None:
        if n > 0:
            with self._lock:
                self._token_events.append((time.perf_counter(), n))

    def reset_window(self) -> None:
        """Clear the sliding-rate event buffer, so the next
        tokens_per_sec() covers only traffic from now on: benchmarks and
        the attribution scripts call it at phase boundaries, so an idle
        gap before a measured phase cannot stretch the window's span."""
        with self._lock:
            self._token_events.clear()

    def tokens_per_sec(self, window_s: Optional[float] = None) -> float:
        """Tokens emitted per second over a sliding window (default 30 s),
        from the oldest in-window emission to now."""
        now = time.perf_counter()
        cutoff = now - (window_s or self.RATE_WINDOW_S)
        with self._lock:
            events = [(t, n) for t, n in self._token_events if t >= cutoff]
        if not events:
            return 0.0
        return sum(n for _, n in events) / max(now - events[0][0], 1e-3)

    def snapshot(self) -> Dict[str, Any]:
        hist_snaps = {f"hist_{k}": h.snapshot()
                      for k, h in self.hists.items()}
        ttft = hist_snaps["hist_ttft_ms"]
        out = {
            # Estimated from the TTFT histogram, as the JAX engine does
            # (None until a first token).
            "ttft_p50_ms": ttft["p50"], "ttft_p95_ms": ttft["p95"],
            "tokens_generated": self.tokens_out,
            "decode_steps": self.decode_steps,
            "mean_batch_occupancy": (self.busy_slots_acc / self.decode_steps
                                     if self.decode_steps else 0.0),
            "tokens_per_sec": self.tokens_per_sec(),
            "prefill_tokens": self.prefill_tokens,
            "fused_steps": self.fused_steps,
            "fused_prefill_tokens": self.fused_prefill_tokens,
            "prefill_stall_beats": self.prefill_stall_beats,
            "fused_sample_dispatches": self.fused_sample_dispatches,
            "admission_failures": self.admission_failures,
            "stuck_thread_joins": self.stuck_thread_joins,
            # Always present, 0 when speculation is off.
            "spec_tokens_per_step": (self.spec_committed
                                     / self.spec_slot_steps
                                     if self.spec_slot_steps else 0.0),
            "spec_fallback_steps": self.spec_fallback_steps,
            "spec_committed": self.spec_committed,
            "spec_slot_steps": self.spec_slot_steps,
            "prefix_hits": self.prefix_hits,
            "prefix_miss": self.prefix_miss,
            "prefix_evictions": self.prefix_evictions,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "kv_promote_ms": self.kv_promote_ms,
            "kv_transfer_pages": self.kv_transfer_pages,
            "kv_transfer_ms": round(self.kv_transfer_ms, 3),
            "kv_transfer_device_pages": self.kv_transfer_device_pages,
            "kv_transfer_chunks": self.kv_transfer_chunks,
            "qos_preemptions": self.qos_preemptions,
            "qos_queue_depth": dict(self.qos_queue_depth),
            "planner_headroom_bytes": self.planner_headroom_bytes,
            "multihost_processes": self.multihost_processes,
            "replay_records_published": self.replay_records_published,
            "replay_divergence": self.replay_divergence,
            "plan_variants_compiled": self.plan_variants_compiled,
            "eager_prefill_dispatches": self.eager_prefill_dispatches,
            "eager_chunk_dispatches": self.eager_chunk_dispatches,
        }
        # The router's and the fleet's keys, zeros for one engine, so
        # /metrics has one schema whether an engine or a fleet serves it.
        out.update(dict.fromkeys(ROUTER_COUNTER_KEYS, 0))
        out["router_queue_depth"] = {}
        out["router_tier_depth"] = {}
        out.update(dict.fromkeys(FLEET_OPS_KEYS, 0))
        out.update(dict.fromkeys(CHAOS_KEYS, 0))
        out.update(self.kv_pager_stats() if self.kv_pager_stats is not None
                   else dict.fromkeys(KV_PAGER_KEYS, 0))
        out.update(self.flight_stats() if self.flight_stats is not None
                   else dict.fromkeys(FLIGHT_KEYS, 0))
        out.update(hist_snaps)
        out.update({f"kernel_launches_{k}": n
                    for k, n in kernels.LAUNCHES.items()})
        # Span export / attribute failures (counted, never swallowed).
        out["trace_export_errors"] = tracing.trace_export_errors()
        return out


class LLMEngine:
    """The engine on one device, or one rank's engine of a tensor-parallel
    mesh. `params` must already live on `device` (CUDA unless the caller
    passes device="cpu"; with a mesh, default the rank's device); with a
    `mesh` of more than one rank they are this rank's shard
    (`sharding.shard_llama_params`) and `cfg` the whole model's."""

    def __init__(self, params, cfg: LlamaConfig, tokenizer,
                 engine_cfg: Any = None, n_pages: Optional[int] = None,
                 device: DeviceLike = None, mesh=None):
        self.mesh = mesh if shd.is_sharded(mesh) else None
        if device is None and self.mesh is not None:
            device = self.mesh.device
        self.device = resolve_device(device)
        if params["tok_emb"].device.type != self.device.type:
            raise ValueError(f"params on {params['tok_emb'].device}, engine "
                             f"on {self.device}")
        self.params = params
        self.tokenizer = tokenizer
        self.ecfg = EngineConfig.coerce(engine_cfg)
        # Tensor-parallel replay: rank 0 runs the scheduler and publishes
        # each device dispatch as a record; follower ranks replay them so
        # the collectives pair up by launch order. Validated first, so an
        # unsupported config fails before any allocation.
        self._mh_log = None
        self._mh_leader = True
        if self.ecfg.multihost:
            from generativeaiexamples_tpu_torch.serving import multihost as mh

            if not mesh_lib.is_multihost():
                raise mh.MultihostError(
                    "engine.multihost=true but the process group spans 1 "
                    "process; start the rank processes "
                    "(mesh.coordinator_address/num_processes/process_id, "
                    "JAX_COORDINATOR_ADDRESS, or the launcher's local "
                    "ranks) before building the engine, or turn the knob "
                    "off")
            mh.validate_multihost_profile(self.ecfg, self.mesh)
            self._mh_log = mh.DispatchLog(namespace=mh.next_namespace())
            self._mh_leader = torch.distributed.get_rank() == 0
        elif self.mesh is not None:
            raise ValueError(
                f"a tensor-parallel mesh of {self.mesh.size} ranks needs "
                f"engine.multihost=true: rank 0 publishes the dispatch "
                f"records the follower ranks replay (serving/multihost.py)")
        self._mh_stop_sent = False
        # The whole model's config; the engine computes on the rank's
        # local head counts (the same config on one device).
        self.model_cfg = cfg
        if self.mesh is not None:
            cfg = shd.local_config(cfg, self.mesh)
            mesh_lib.activate(self.mesh)
        self.cfg = cfg
        ps = self.ecfg.page_size
        kv_int8 = self.ecfg.kv_dtype == "int8"
        if self.device.type == "cuda" and (
                cfg.dtype != torch.bfloat16
                or self.ecfg.kv_dtype not in ("bfloat16", "int8")
                or ps % (16 if kv_int8 else 8) or ps > 128):
            raise ValueError(
                f"on CUDA the K1/K2/K4 kernels take bf16 and pages of a "
                f"multiple of 8 (int8 pool: 16) up to 128 tokens: model "
                f"dtype {cfg.dtype}, engine.kv_dtype "
                f"{self.ecfg.kv_dtype!r}, page_size {ps}")
        if is_quantized(params) != (self.ecfg.quantize_weights == "int8"):
            raise ValueError(
                f"engine.quantize_weights={self.ecfg.quantize_weights!r} "
                f"but the params are "
                f"{'' if is_quantized(params) else 'not '}quantized "
                f"(ops.quant.quantize_llama_params)")
        if self.ecfg.max_seq_len < ps:
            raise ValueError(f"engine.max_seq_len {self.ecfg.max_seq_len} "
                             f"< page_size {ps}")
        self.max_pages = self.ecfg.max_seq_len // ps
        # Memory planner: with auto_pool_pages and no explicit n_pages,
        # the pool is sized from the device's memory (a plan that cannot
        # fit raises MemoryPlanError with its breakdown).
        self.memory_plan = None
        if n_pages is None and self.ecfg.auto_pool_pages:
            from generativeaiexamples_tpu_torch.serving.memory_plan import (
                plan_rank_memory)

            self.memory_plan = plan_rank_memory(self.model_cfg, self.ecfg,
                                                self.mesh, self.device)
            n_pages = self.memory_plan.pool_pages
            _LOG.info("auto_pool_pages: %d pages\n%s", n_pages,
                      self.memory_plan.breakdown())
        if n_pages is None:
            # An int8 pool gets one sequence of slack, as the JAX engine
            # gives it: retired slots free their pages only when their
            # parked in-flight block lands.
            slack = self.max_pages if kv_int8 else 0
            n_pages = self.ecfg.max_batch_size * self.max_pages + slack + 1
        self.pool = PagePool.zeros(cfg, n_pages, ps,
                                   dtype=_DTYPES[self.ecfg.kv_dtype],
                                   device=self.device)
        self.allocator = PageAllocator(n_pages)
        # Cross-request prefix KV reuse, owned by the scheduler thread
        # like the allocator; with the pager, eviction demotes pages to
        # host RAM and disk instead of dropping them.
        self.prefix_cache = None
        self.kv_pager = None
        if self.ecfg.kv_pager and not self.ecfg.prefix_cache:
            raise ValueError("engine.kv_pager requires engine.prefix_cache "
                             "(the radix tree is the pager's index)")
        if self.ecfg.prefix_cache:
            cap = int(max(0.0, self.ecfg.prefix_cache_capacity) * n_pages)
            if self.ecfg.kv_pager:
                self.kv_pager = KVPager(
                    self.pool, host_budget_mb=self.ecfg.kv_host_budget_mb,
                    spill_dir=self.ecfg.kv_spill_dir,
                    max_batch_pages=self.max_pages, mesh=self.mesh)
                # Under replay the leader's pager publishes its demote
                # gathers and promote scatters (pager_out / pager_in)
                # before launching them; followers replay them from their
                # own cold store (_exec_pager_*).
                self.kv_pager.mh_log = (self._mh_log if self._mh_leader
                                        else None)
                self.prefix_cache = PagedPrefixCache(
                    self.allocator, ps, cap, self.kv_pager,
                    lambda: self.pool)
            else:
                self.prefix_cache = RadixPrefixCache(self.allocator, ps,
                                                     cap)
            self.allocator.reclaim = self._reclaim_cached_pages
        self.slots: List[Optional[_Slot]] = [None] * self.ecfg.max_batch_size
        self.waiting: deque = deque()
        self.metrics = EngineMetrics()
        if self.memory_plan is not None:
            self.metrics.planner_headroom_bytes = (
                self.memory_plan.headroom_bytes)
        if self.kv_pager is not None:
            self.metrics.kv_pager_stats = self.kv_pager.stats
        if self._mh_log is not None:
            self.metrics.multihost_processes = \
                torch.distributed.get_world_size()
            if self._mh_leader:
                m = self.metrics

                def _on_publish(kind: str) -> None:
                    m.replay_records_published += 1

                self._mh_log.on_publish = _on_publish
        # Flight recorder: always constructed (its stats and the timeline
        # exist either way); flight_recorder=False makes every append one
        # branch. The beat bookkeeping: the previous beat's host-ready
        # stamp (the beat-gap histogram) and the pager's page moves since
        # the last beat record.
        self.flight = FlightRecorder(ring_size=self.ecfg.flight_ring_size,
                                     enabled=self.ecfg.flight_recorder)
        self.metrics.flight_stats = self.flight.stats
        self._last_beat_ready = 0.0
        self._beat_kv_demote = 0
        self._beat_kv_promote = 0
        # QoS: None is the FIFO admission path; on, the weighted-fair
        # TierScheduler picks each admission.
        self.qos = None
        if self.ecfg.qos:
            self.qos = TierScheduler({
                "latency": self.ecfg.qos_weight_latency,
                "standard": self.ecfg.qos_weight_standard,
                "batch": self.ecfg.qos_weight_batch})
        # Control ops (the fleet's KV page transfer): closures queued by
        # other threads through run_control_op() and run at the top of
        # the scheduler loop, so the tree, the allocator and the pool stay
        # scheduler-owned. Each entry is (fn, result box, done event).
        self._control_ops: deque = deque()
        # Chaos slow-replica injection (serving/chaos.py): seconds slept at
        # the top of every scheduler iteration. Written by the chaos
        # thread (a float store), read by the scheduler; 0.0 in service.
        self.chaos_beat_delay_s = 0.0
        # Emission pacer: entries keyed by id(slot), {"slot", "buf"
        # (deque), "next_t", "spacing"}; the scheduler adds and flushes
        # them under _pace_lock, the pacer thread delivers what is due.
        self._pace_lock = threading.Lock()
        self._pace_entries: Dict[int, Dict[str, Any]] = {}
        self._pace_wake = threading.Event()
        self._pace_thread: Optional[threading.Thread] = None
        # True only while a landed block's tokens are emitted with pacing
        # engaged (scheduler thread; _stream_put reads it).
        self._pace_engaged = False
        # Buckets are positive multiples of page_size within max_seq_len.
        max_bucket = self.max_pages * ps
        rounded = {min(-(-b // ps) * ps, max_bucket)
                   for b in self.ecfg.prefill_buckets if b > 0}
        self.buckets = sorted(rounded) or [min(-(-512 // ps) * ps,
                                               max_bucket)]
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        # Device-resident current token per slot (decode blocks chain
        # through it; the host reads tokens only when a block lands).
        self._last_tokens = torch.zeros((self.ecfg.max_batch_size,),
                                        dtype=torch.int32, device=self.device)
        self._inflight: deque = deque()
        # Prefill-sampled first tokens on their way to the host:
        # [(HostCopy, [(slot_idx, slot), ...])], emitted once landed.
        self._pending_first: List = []
        self.pipeline_depth = max(1, self.ecfg.pipeline_depth)
        self._admit_debounce_s = 0.008
        # Chunked prefill lane: at most one long prompt in flight (each
        # holds a scratch cache); landed decode blocks count beats.
        self._long_prefills: List[_LongPrefill] = []
        self._max_long_prefills = 1
        # Device memory counters for retired spans (scheduler thread
        # only; MEMSTATS_SAMPLE_EVERY).
        self._memstats_cache: Optional[Dict[str, int]] = None
        self._memstats_tick = 0
        # slot -> the scratch cache of its long prefill: a view of the
        # engine's one static scratch (_scratch_store, made at first use;
        # _scratch_view).
        self._scratch_caches: Dict[int, KVCache] = {}
        self._scratch_store: Optional[KVCache] = None
        # slot -> (last chunk's logits [V] or None, tok0 or None): what
        # the commit samples from, or the token the last chunk sampled.
        self._chunk_res: Dict[int, Any] = {}
        # Host staging buffer of each chunk width, reused.
        self._chunk_staging: Dict[int, np.ndarray] = {}
        self._fused_sampling = self.ecfg.fused_sampling
        self._beat = 0
        # The chunked lane's scratch cache: the pool dtype, or the model
        # dtype for an int8 pool (cache_to_pool quantizes it), as the JAX
        # engine does.
        self._scratch_dtype = (cfg.dtype if kv_int8
                               else _DTYPES[self.ecfg.kv_dtype])
        # Speculation. A verify step commits at most _spec_r = k + 1
        # tokens but writes k/v for every packed tree node, so pages are
        # reserved at _spec_tree_nodes a step (== _spec_r for linear).
        self._spec_k = max(0, self.ecfg.speculative_k)
        self._tree_branches = (max(0, self.ecfg.speculative_tree_branches)
                               if self._spec_k else 0)
        self._spec_r = self._spec_k + 1
        self._spec_tree_nodes = (1 + max(1, self._tree_branches)
                                 * self._spec_k if self._spec_k else 1)
        if self._spec_k:
            B = self.ecfg.max_batch_size
            self._history = torch.zeros((B, self.ecfg.max_seq_len),
                                        dtype=torch.int32, device=self.device)
            self._dev_lengths = torch.ones((B,), dtype=torch.int32,
                                           device=self.device)
        # The fused rider's chunk width: the largest power of two within
        # both the largest bucket and the token budget; 0 (no rider) when
        # the knob is off, the budget is <= 0, or the engine speculates
        # without step_plans (composed plans are what put a rider beside
        # verify steps).
        self._fused_width = 0
        if (self.ecfg.fused_prefill
                and (not self._spec_k or self.ecfg.step_plans)
                and self.ecfg.fused_token_budget > 0):
            self._fused_width = _pow2_floor(
                min(self.buckets[-1], self.ecfg.fused_token_budget))
        # The lattice warmup() warmed, as in the JAX engine: block lengths
        # (_warm_ks), rider shapes (S_total, K) of the fused and composed
        # plans, the chunked lane's (S_total, width) shapes and those
        # whose first-token tail was warmed, and every StepPlan (their
        # count is plan_variants_compiled). Empty (never warmed): any
        # shape dispatches. _graphs holds the decode lattice's CUDA
        # graphs on a warmed single-device CUDA engine.
        self._warm_ks: set = set()
        self._warm_fused: set = set()
        self._warm_spec_fused: set = set()
        self._warm_chunk_widths: set = set()
        self._warm_sample_chunks: set = set()
        self._warm_plans: set = set()
        self._graphs: Optional[step_graphs.StepGraphs] = None

    # -- lifecycle ---------------------------------------------------------

    def warmup(self, buckets=None, group_sizes=None, ks=None,
               sampled: Optional[bool] = None, long_prompts: bool = False,
               long_prompt_lengths=None) -> "LLMEngine":
        """Run the JAX engine's warmup lattice (its `warmup`, whose
        signature, defaults and lattice this keeps) before serving, all
        against the page-0 sink: prefill for each (bucket, group size,
        sampling flags); on a speculative engine a verify block per K,
        and with `sampled` (default: speculative engines) the sampled
        fallback's plain block per K; else a plain decode block per (K,
        flags), where `ks` defaults to {1, 2, decode_steps_per_dispatch
        rounded down to a power of two} and always holds 1; with
        `long_prompts`, the chunked lane's (scratch length, chunk width)
        shapes (restricted to `long_prompt_lengths` when given), their
        first-token tails and the fused rider variants; the prefix-cache
        hit chain per bucket and the pager's page moves.

        Each warmed point is recorded (`_warm_ks`, `_warm_plans`,
        `_warm_fused`, `_warm_spec_fused`, `_warm_chunk_widths`,
        `_warm_sample_chunks`; `plan_variants_compiled` counts
        `_warm_plans`), and from then on the dispatcher picks only warmed
        block lengths, chunk widths and rider shapes, as the JAX engine
        does; an engine never warmed keeps any shape. On one CUDA device
        (no mesh) every lattice point is captured as a CUDA graph
        (serving/step_graphs.py): the decode blocks, the prefill groups,
        the chunks and their first-token tails, and the hit chain's
        gather, finish scatter and finish sampler; riders and composed
        plans replay a chunk's graph and a block's. Elsewhere each point
        runs once eagerly, which pays its first-call costs (kernel
        builds, cuBLAS heuristics, allocator growth). A capture that
        fails raises. Call before start().

        What the lattice leaves out is captured later, on first sight:
        a long prompt's or a hit's scratch length that was not warmed
        (the default server warms no long prompts) gets its chunk at the
        largest bucket's width, its seed (with a prefix cache) and its
        commit captured when the prompt is admitted
        (`_capture_first_sight`), where the JAX engine compiles them
        cold on the scheduler thread. The `_warm_*` sets stay as
        warmed, so plans stay the JAX engine's."""
        if self._running:
            raise RuntimeError("warmup() must run before start()")
        if sampled is None:
            # As in the JAX engine: any temperature > 0 request demotes a
            # speculative engine's dispatch to the sampled fallback.
            sampled = self._spec_k > 0
        ps = self.pool.page_size
        if group_sizes is None:
            group_sizes, n = [], 1
            bound = min(self.ecfg.max_batch_size, self._prefill_cap)
            while n < bound:
                group_sizes.append(n)
                n *= 2
            group_sizes.append(n)
        if ks is None:
            ks = {1, 2, _pow2_floor(self.ecfg.decode_steps_per_dispatch)}
        # K = 1 is always warm, so a warmed block length exists under any
        # page-capacity bound.
        ks = sorted(set(ks) | {1})
        self._warm_ks = set(ks)
        flag_sets = [_GREEDY] + ([_SAMPLED] if sampled else [])
        if (self.device.type == "cuda" and self.mesh is None
                and self._graphs is None):
            # Blocks other work left cached go back before the graphs'
            # pools grow.
            torch.cuda.empty_cache()
            self._graphs = step_graphs.StepGraphs(
                self.params, self.cfg, self.pool, self._generator,
                self.ecfg.max_batch_size, self.max_pages, self._last_tokens,
                self._history if self._spec_k else None,
                self._dev_lengths if self._spec_k else None,
                scratch=self._scratch(), max_chunk=self.buckets[-1])
            # The graphs' static state is the engine's from now on.
            self._last_tokens = self._graphs.last_tokens
            if self._spec_k:
                self._dev_lengths = self._graphs.dev_lengths
        graphs = self._graphs
        # A graphs engine captures each family from its largest shape
        # down (step_graphs: a smaller graph reuses a larger one's
        # memory); elsewhere the points run in the JAX warmup's order.
        order = ((lambda xs: sorted(xs, reverse=True)) if graphs is not None
                 else list)
        Plan = engine_model.StepPlan
        if self._spec_k:
            for steps in order(ks):
                plan = Plan(decode_k=steps, spec_k=self._spec_k,
                            tree_branches=self._tree_branches)
                self._warm_block(plan, _GREEDY)
                self._warm_plans.add(plan)
            if sampled:
                # The fallback always runs the general-sampling variant
                # (_dispatch_decode), so that is the one to warm.
                for steps in order(ks):
                    plan = Plan(decode_k=steps, spec_state=True)
                    self._warm_block(plan, _SAMPLED)
                    self._warm_plans.add(plan)
        else:
            for k in order(ks):
                self._warm_plans.add(Plan(decode_k=k))
                for flags in flag_sets:
                    self._warm_block(Plan(decode_k=k), flags)
        # The prefill lattice after the blocks (a capture that fails
        # raises before any prefill group is captured).
        B = len(self.slots)
        for bucket in order(buckets or self.buckets):
            for n in order(group_sizes):
                for flags in flag_sets:
                    if graphs is not None:
                        graphs.capture_prefill(bucket, n, flags)
                        continue
                    toks = engine_model.prefill_batch_step(
                        self.params, self.cfg, self.pool,
                        self._put(np.zeros((n, bucket), np.int32)),
                        self._put(np.ones((n,), np.int32)),
                        self._put(np.zeros((n, bucket // ps), np.int32)),
                        self._put(np.zeros((n,), np.float32)),
                        self._put(np.ones((n,), np.float32)),
                        self._put(np.zeros((n,), np.int32)),
                        self._generator, sampling_flags=flags)
                    engine_model.set_last_tokens(
                        self._last_tokens,
                        self._put(np.full((n,), B, np.int32)), toks)
        if long_prompts:
            self._warm_long_prompts(ks, flag_sets, long_prompt_lengths)
        if self.prefix_cache is not None:
            # A hit's chain per bucket: the gather into a bucket-sized
            # scratch, a suffix chunk at every bucket width that fits,
            # each with its first-token tail, the finish scatter.
            bset = sorted(buckets or self.buckets)
            logits = None
            for s_tot in order(bset):
                sink_row = self._put(np.zeros((s_tot // ps,), np.int32))
                for chunk in order([b for b in bset if b <= s_tot]):
                    if graphs is not None:
                        graphs.capture_seed(s_tot)
                        graphs.capture_chunk(s_tot, chunk)
                        logits = graphs.chunk_logits
                    else:
                        # Seeded at 1 cached token, as in the JAX warmup
                        # (a full-width chunk's last row lands in the
                        # scratch's sink).
                        cache = engine_model.pool_to_cache(
                            self.pool, self.cfg, sink_row, 1,
                            out=self._scratch_view(s_tot, reset=False))
                        logits, cache = engine_model.prefill_chunk_step(
                            self.params, self.cfg, cache,
                            self._put(np.zeros((1, chunk), np.int32)), 1)
                    self._warm_chunk_widths.add((s_tot, chunk))
                    self._warm_sample_chunk(s_tot, chunk, flag_sets)
                self._warm_commit(s_tot, sink_row)
            self._warm_finish(logits, flag_sets)
        if self.kv_pager is not None:
            w = 1
            while True:
                row = self._put(np.zeros((w,), np.int64))
                codes, scales = engine_model.pool_to_pages(self.pool, row)
                engine_model.pages_to_pool(self.pool, codes, scales, row)
                if w >= self.max_pages:
                    break
                w *= 2
        # The chunked lane's chunk-only plans, one per warmed chunk shape.
        for s_tot, w in self._warm_chunk_widths:
            self._warm_plans.add(Plan(rider_width=w, rider_s_total=s_tot))
        self.metrics.plan_variants_compiled = len(self._warm_plans)
        if graphs is not None:
            # Eager warm steps above may have rebound the device state.
            self._adopt_graph_state(graphs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._release_scratch()
        if graphs is not None:
            # The captures' eager runs left their transients cached for
            # the capture stream, which runs nothing more; the graphs
            # hold pools of their own.
            torch.cuda.empty_cache()
        return self

    def _adopt_graph_state(self, graphs: "step_graphs.StepGraphs") -> None:
        """Make the graphs' static token (and device length) buffers the
        engine's state again where an eager step rebound it, copying the
        current values in: every replay reads and writes those buffers."""
        if self._last_tokens is not graphs.last_tokens:
            graphs.last_tokens.copy_(self._last_tokens)
            self._last_tokens = graphs.last_tokens
        if self._spec_k and self._dev_lengths is not graphs.dev_lengths:
            graphs.dev_lengths.copy_(self._dev_lengths)
            self._dev_lengths = graphs.dev_lengths

    def _warm_block(self, plan: "engine_model.StepPlan", flags) -> None:
        """One decode lattice point over inactive rows (every write lands
        in the sink): captured as a CUDA graph on a single CUDA device,
        else run once eagerly."""
        if self._graphs is not None:
            self._graphs.capture(plan, flags)
            return
        kw = dict(self._idle_batch(), pool=self.pool,
                  last_tokens=self._last_tokens, generator=self._generator,
                  sampling_flags=flags)
        if self._spec_k:
            kw.update(history=self._history, dev_lengths=self._dev_lengths)
        res = engine_model.plan_step(self.params, self.cfg, plan, **kw)
        self._last_tokens = res["last_tokens"]
        if "dev_lengths" in res:
            self._dev_lengths = res["dev_lengths"]

    def _idle_batch(self) -> Dict[str, torch.Tensor]:
        """A decode batch of inactive rows on sink page 0 (lengths 1,
        greedy sampling parameters): the warmup's dummy inputs."""
        B = self.ecfg.max_batch_size
        return {"page_tables": self._put(np.zeros((B, self.max_pages),
                                                  np.int32)),
                "active": self._put(np.zeros((B,), bool)),
                "lengths": self._put(np.ones((B,), np.int32)),
                "temperature": self._put(np.zeros((B,), np.float32)),
                "top_p": self._put(np.ones((B,), np.float32)),
                "top_k": self._put(np.zeros((B,), np.int32))}

    def _scratch(self) -> KVCache:
        """The engine's one static scratch cache, made at first use with
        page capacity's rows (max_pages x page_size: the memory planner's
        long_prefill_scratch line) plus the sink row a chunk's rows past
        its scratch length land in (`engine_model.scratch_view`), in the
        scratch dtype."""
        if self._scratch_store is None:
            self._scratch_store = KVCache.zeros(
                self.cfg, 1,
                max_len=self.max_pages * self.pool.page_size + 1,
                dtype=self._scratch_dtype, device=self.device)
        return self._scratch_store

    def _scratch_view(self, s_total: int, reset: bool = True) -> KVCache:
        """The first s_total rows of the static scratch (`_scratch`), its
        lengths zeroed unless `reset` is False: the scratch of a long
        prompt or a prefix hit. At most one prefill holds it
        (_max_long_prefills)."""
        view = engine_model.scratch_view(self._scratch(), s_total)
        if reset:
            view.lengths.zero_()
        return view

    def _warm_long_prompts(self, ks, flag_sets, long_prompt_lengths) -> None:
        """The JAX warmup's long_prompts part: one scratch shape per chunk
        multiple up to page capacity (or the shapes `long_prompt_lengths`
        need), a full chunk and each tail width at each (the power-of-two
        ladder from page_size up, or the tails those lengths leave), each
        with its first-token tail, and the finish scatter; the fused
        rider at every K the prefill_decode_k_cap lets through (the
        composed verify + rider plan on a speculative engine). Every
        shape runs in the first S_total rows of the engine's one static
        scratch (`_scratch_view`), from length 0, so its rows fit; with
        graphs each chunk shape is captured there, and a rider is the
        rider-width chunk's graph and the block's."""
        ps = self.pool.page_size
        chunk = self.buckets[-1]
        cap_tokens = self.max_pages * ps
        if long_prompt_lengths is not None:
            s_tots = sorted({min(-(-int(s) // chunk) * chunk, cap_tokens)
                             for s in long_prompt_lengths})
        else:
            s_tots = list(range(chunk, cap_tokens + 1, chunk))
        tail_widths: Dict[int, set] = {s: set() for s in s_tots}
        if long_prompt_lengths is not None:
            for s in long_prompt_lengths:
                p = min(int(s), cap_tokens)
                s_tot = min(-(-p // chunk) * chunk, cap_tokens)
                r = p % chunk
                if r and _pow2_ceil(r) < chunk:
                    tail_widths[s_tot].add(_pow2_ceil(r))
        else:
            ladder, w = set(), _pow2_ceil(min(ps, chunk))
            while w < chunk:
                ladder.add(w)
                w *= 2
            for s_tot in s_tots:
                tail_widths[s_tot] = set(ladder)
        graphs = self._graphs
        Plan = engine_model.StepPlan
        logits = None
        for s_tot in s_tots:
            row = self._put(np.zeros((s_tot // ps,), np.int32))
            if self.prefix_cache is not None:
                # A long prompt's prefix hit seeds its scratch from the
                # pool at this shape.
                if graphs is not None:
                    graphs.capture_seed(s_tot)
                else:
                    engine_model.pool_to_cache(
                        self.pool, self.cfg, row, 1,
                        out=self._scratch_view(s_tot, reset=False))
            for w in [chunk] + sorted(tail_widths[s_tot],
                                      reverse=graphs is not None):
                if graphs is not None:
                    graphs.capture_chunk(s_tot, w)
                    logits = graphs.chunk_logits
                else:
                    logits, _ = engine_model.prefill_chunk_step(
                        self.params, self.cfg, self._scratch_view(s_tot),
                        self._put(np.zeros((1, w), np.int32)), 1)
                self._warm_chunk_widths.add((s_tot, w))
                self._warm_sample_chunk(s_tot, w, flag_sets)
            self._warm_commit(s_tot, row)
            if not (self._fused_width and s_tot >= self._fused_width):
                continue
            cap = self.ecfg.prefill_decode_k_cap
            fks = sorted({k for k in ks if cap <= 0 or k <= cap} | {1})
            if graphs is not None:
                # The rider's chunk; its blocks are the decode lattice's.
                graphs.capture_chunk(s_tot, self._fused_width)
            idle = self._idle_batch()
            rider = self._put(np.zeros((1, self._fused_width), np.int32))
            for kf in fks:
                if self._spec_k:
                    if graphs is None:
                        (_, _, self._last_tokens, self._dev_lengths, _, _,
                         _) = engine_model.fused_spec_prefill_step(
                            self.params, self.cfg, self.pool, self._history,
                            self._last_tokens, self._dev_lengths,
                            idle["page_tables"], idle["active"],
                            self._scratch_view(s_tot), rider, 1, kf,
                            self._spec_k, self._tree_branches)
                    self._warm_spec_fused.add((s_tot, kf))
                    self._warm_plans.add(Plan(
                        decode_k=kf, spec_k=self._spec_k,
                        tree_branches=self._tree_branches,
                        rider_width=self._fused_width, rider_s_total=s_tot))
                    continue
                for flags in flag_sets:
                    if graphs is None:
                        _, self._last_tokens, _, _ = \
                            engine_model.fused_decode_prefill_step(
                                self.params, self.cfg, self.pool,
                                self._last_tokens, idle["page_tables"],
                                idle["lengths"], idle["active"],
                                idle["temperature"], idle["top_p"],
                                idle["top_k"], self._generator,
                                self._scratch_view(s_tot), rider, 1, kf,
                                sampling_flags=flags)
                    self._warm_fused.add((s_tot, kf))
                    self._warm_plans.add(Plan(
                        decode_k=kf, rider_width=self._fused_width,
                        rider_s_total=s_tot))
        self._warm_finish(logits, flag_sets)

    def _warm_commit(self, s_tot: int, row: torch.Tensor) -> None:
        """The finish scatter of an s_tot-row scratch into the sink
        pages: captured as a graph on a graphs engine (with, on a
        speculative one, the finish's history row), else run once."""
        if self._graphs is not None:
            self._graphs.capture_commit(s_tot)
            self._graphs.capture_history()
            return
        engine_model.cache_to_pool(self.pool,
                                   self._scratch_view(s_tot, reset=False),
                                   self.cfg, row)

    def _warm_finish(self, logits, flag_sets) -> None:
        """The chunked finish's samplers on warmup logits (slot 0 of the
        idle engine): sample_token + set_last_token, and with
        fused_sampling sample_token_into, per flag set; on a graphs
        engine the finish sampler's graph per flag set, which both
        finishes replay."""
        if logits is None:
            return
        if self._graphs is not None:
            for flags in flag_sets:
                self._graphs.capture_finish(flags)
            return
        tok0 = None
        for flags in flag_sets:
            tok0 = engine_model.sample_token(logits, 0.0, 1.0, 0,
                                             self._generator, *flags)
        engine_model.set_last_token(self._last_tokens, 0, tok0)
        if self._fused_sampling:
            for flags in flag_sets:
                engine_model.sample_token_into(self._last_tokens, 0, logits,
                                               0.0, 1.0, 0, self._generator,
                                               *flags)

    def _warm_sample_chunk(self, s_tot: int, width: int, flag_sets) -> None:
        """With fused_sampling, the prompt-completing chunk's first-token
        tail at (s_tot, width) per flag set (into slot 0 of the idle
        engine; a graph on a graphs engine), recorded in
        _warm_sample_chunks, so a warmed engine lets that chunk sample in
        its own dispatch."""
        if not self._fused_sampling:
            return
        for flags in flag_sets:
            if self._graphs is not None:
                self._graphs.capture_chunk(s_tot, width, flags)
                continue
            engine_model.prefill_chunk_sample_step(
                self.params, self.cfg, self._scratch_view(s_tot),
                self._put(np.zeros((1, width), np.int32)), 1,
                self._last_tokens, 0, 0.0, 1.0, 0, self._generator,
                sampling_flags=flags)
        self._warm_sample_chunks.add((s_tot, width))
        self._warm_plans.add(engine_model.StepPlan(
            rider_width=width, rider_s_total=s_tot, rider_sample=True))

    def start(self) -> "LLMEngine":
        self._running = True
        if self.ecfg.pace_emission_max_streams > 0:
            self._pace_thread = threading.Thread(
                target=self._pacer_loop, daemon=True, name="llm-engine-pace")
            self._pace_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()
        return self

    def stop(self) -> None:
        # The leader tells the followers to leave their replay loop first
        # (a follower blocked in next_record would otherwise wait), once
        # across repeated stop() calls.
        if (self._mh_log is not None and self._mh_leader
                and not self._mh_stop_sent):
            self._mh_stop_sent = True
            self._mh_log.publish("stop")
        self._running = False
        self._wake.set()
        self._pace_wake.set()
        # Take the thread refs once: a chaos kill can race the health
        # probe's eviction into a second stop().
        threads = [self._thread, self._pace_thread]
        self._thread = self._pace_thread = None
        stuck = []
        for t in threads:
            if t is None:
                continue
            t.join(timeout=10)
            if t.is_alive():
                stuck.append(t.name)
        if stuck:
            _LOG.warning("engine stop: %d thread(s) still alive after the "
                         "join timeout: %s", len(stuck), stuck)
            self.metrics.stuck_thread_joins += len(stuck)
        # Tokens the pacer still holds must reach their consumers.
        with self._pace_lock:
            entries = list(self._pace_entries.values())
            self._pace_entries.clear()
        for entry in entries:
            for ev in entry["buf"]:
                entry["slot"].req.stream.put(ev)
        if self.kv_pager is not None:
            # Drain the spill worker and drop the mapping (a daemon
            # worker mid-write at exit would race the spill-dir cleanup).
            self.kv_pager.close()
        # Pending control ops must not strand their waiters: fail them,
        # so the fleet's transfer falls back to colocated serving.
        while self._control_ops:
            _, box, done = self._control_ops.popleft()
            box["err"] = RuntimeError("engine stopped")
            done.set()

    # -- public API --------------------------------------------------------

    def submit(self, req: GenRequest) -> GenRequest:
        # Prompts beyond the largest bucket go through chunked prefill,
        # so the ceiling is the page capacity minus one generated token.
        max_prompt = self.max_pages * self.ecfg.page_size - 1
        if len(req.prompt_ids) > max_prompt:
            if not req.truncate_prompt:
                raise PromptTooLongError(
                    f"prompt is {len(req.prompt_ids)} tokens; engine max is "
                    f"{max_prompt} (page capacity minus one generated "
                    f"token)")
            req.prompt_ids = req.prompt_ids[-max_prompt:]
        with self._lock:
            self.waiting.append(req)
            self._tier_depth(req, +1)
        self._wake.set()
        return req

    def generate_stream(self, prompt_ids: Sequence[int],
                        **kw) -> Iterator[Dict]:
        """Blocking iterator of {text, token_id, finished, ...} events."""
        req = GenRequest(prompt_ids=list(prompt_ids), **kw)
        self.submit(req)
        while True:
            ev = req.stream.get()
            yield ev
            if ev["finished"]:
                return

    def generate(self, prompt_ids: Sequence[int], **kw) -> str:
        return "".join(ev["text"] for ev in self.generate_stream(prompt_ids,
                                                                 **kw))

    # -- control ops / disagg KV page transfer (serving/disagg.py) ---------

    def run_control_op(self, fn, timeout_s: float = 60.0):
        """Run `fn()` on the scheduler thread (the single owner of slot,
        page, allocator and radix-tree state) and return its result: the
        fleet's KV page transfer rides this seam so an export or import
        never races the scheduler's own tree mutations. Runs inline when
        the scheduler is not live or the caller is the scheduler."""
        t = self._thread
        if (not self._running or t is None or not t.is_alive()
                or threading.current_thread() is t):
            return fn()
        box: Dict[str, Any] = {}
        done = threading.Event()
        self._control_ops.append((fn, box, done))
        self._wake.set()
        if not done.wait(timeout_s):
            raise TimeoutError("engine control op timed out "
                               f"after {timeout_s}s")
        if "err" in box:
            raise box["err"]
        return box.get("out")

    def _drain_control_ops(self) -> None:
        """Scheduler thread, loop top: run the queued control closures.
        Errors are boxed back to the waiter, never kill the loop."""
        while self._control_ops:
            fn, box, done = self._control_ops.popleft()
            try:
                box["out"] = fn()
            except BaseException as e:  # the waiter re-raises
                box["err"] = e
            finally:
                done.set()

    def _cached_page_runs(self, ids: Sequence[int]):
        """Longest exportable cached prefix of `ids` as two node runs:
        the device-resident lead (the resident set is closed under
        ancestors) and, with the pager, the demoted tail readable from
        its cold tier. A pending node ends the run (its bytes are on
        their way to the host)."""
        nodes = self.prefix_cache.match_nodes(list(ids))
        dev: List = []
        for n in nodes:
            if n.tier != TIER_DEVICE:
                break
            dev.append(n)
        cold: List = []
        if self.kv_pager is not None:
            for n in nodes[len(dev):]:
                if n.tier not in (TIER_HOST, TIER_DISK):
                    break
                cold.append(n)
        return dev, cold

    def _host_buffer(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """A zeroed host tensor for moving pages; pinned when the pool
        is on the card, so the copies run at the bus rate."""
        return torch.zeros(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def export_prefix_pages(self, ids: Sequence[int],
                            start_page: int = 0, max_pages: int = 0):
        """Longest cached full-page prefix of `ids` as HOST tensors: the
        disagg transfer's source half. Batched pool_to_pages gathers for
        the device-resident run, at most max_pages pages each, and, with
        the pager, a read of any demoted tail from its cold tier; codes
        and int8 scales VERBATIM, so a round trip is bit-identical to
        never having left this pool. `start_page` / `max_pages` pick a
        page window of the cached prefix (default: all of it). Returns
        (codes [n, 2, L, KH, ps, Hd] in the pool dtype, scales [n, 2, L,
        KH, ps] f32 or None, n_tokens), n_tokens covering the prefix
        through the window's END (so ids[:n_tokens] with
        first_page=start_page is the matching import), or None when the
        window is empty. Scheduler thread only (run_control_op); the
        blocking copy to the host is the transfer's cost."""
        if self.prefix_cache is None:
            return None
        dev, cold = self._cached_page_runs(ids)
        n_total = len(dev) + len(cold)
        lo = max(0, int(start_page))
        hi = n_total if max_pages <= 0 else min(n_total,
                                                lo + int(max_pages))
        n_pages = hi - lo
        if n_pages <= 0:
            return None
        codes_shape, codes_dtype, scales_shape = self._page_geometry()
        codes = self._host_buffer((n_pages,) + codes_shape, codes_dtype)
        scales = (self._host_buffer((n_pages,) + scales_shape,
                                    torch.float32)
                  if scales_shape else None)
        dev_w = dev[lo:hi]
        for s_lo, s_hi in gather_spans(len(dev_w), self.max_pages):
            batch = dev_w[s_lo:s_hi]
            row = np.zeros((_pow2_ceil(len(batch)),), np.int64)  # pad: sink
            row[:len(batch)] = [n.page for n in batch]
            got, got_s = self._exec_pages_out({"row": row})
            codes[s_lo:s_hi].copy_(got[:len(batch)])
            if scales is not None:
                scales[s_lo:s_hi].copy_(got_s[:len(batch)])
        cold_w = cold[max(lo - len(dev), 0): max(hi - len(dev), 0)]
        if cold_w and self.mesh is not None:
            got, got_s = self._exec_cold_out({"keys": np.asarray(
                [n.cold_key for n in cold_w], np.int64)}, cold_w)
            codes[len(dev_w):].copy_(got)
            if scales is not None:
                scales[len(dev_w):].copy_(got_s)
        elif cold_w:
            tail = codes[len(dev_w):]
            self.kv_pager.read_pages(
                cold_w, tail.view(self.kv_pager._raw_dtype).numpy(),
                None if scales is None else scales[len(dev_w):].numpy())
        return codes, scales, hi * self.pool.page_size

    # graftlint: hot-path
    def export_prefix_pages_device(self, ids: Sequence[int],
                                   start_page: int = 0,
                                   max_pages: int = 0):
        """Device-path export half: the window's device-RESIDENT pages as
        device tensors straight off one pool_to_pages gather, no host
        copy; the target engine's import_prefix_pages scatters them into
        its own pool (a device-to-device copy; codes and scales
        verbatim, so the route is bit-identical to the host bounce).
        Only the leading device-resident run takes part (a demoted tail
        takes the host path), and each call caps its window at max_pages
        pages; callers loop on the returned n_tokens. Returns (codes,
        scales or None, n_tokens) like export_prefix_pages, or None when
        the window holds no device-resident page. Scheduler thread only
        (run_control_op)."""
        if self.prefix_cache is None:
            return None
        dev, _ = self._cached_page_runs(ids)
        lo = max(0, int(start_page))
        hi = len(dev) if max_pages <= 0 else min(len(dev),
                                                 lo + int(max_pages))
        hi = min(hi, lo + self.max_pages)
        n_pages = hi - lo
        if n_pages <= 0:
            return None
        row = np.zeros((_pow2_ceil(n_pages),), np.int64)  # pad: sink
        row[:n_pages] = [n.page for n in dev[lo:hi]]
        got, got_s = self._exec_pages_out({"row": row})
        return (got[:n_pages], None if got_s is None else got_s[:n_pages],
                hi * self.pool.page_size)

    def publish_prefill_pages(self, ids: Sequence[int]) -> int:
        """Make the COMPLETED chunks of an in-flight chunked prefill of
        `ids` exportable now (the pipelined-disagg seam): scatter the
        newly covered full pages from the scratch cache into the pool
        (cache_to_pool with every other row sunk; an int8 pool quantizes
        page by page, so incremental scatters equal the one-shot) and
        insert the covered prefix into the radix tree. Idempotent and
        monotone; the finish sinks the published rows, so each page is
        written once. With no matching in-flight prefill, returns the
        exportable coverage already in the tree. Returns covered full
        pages. Scheduler thread only (run_control_op)."""
        if self.prefix_cache is None:
            return 0
        ids = list(ids)
        ps = self.pool.page_size
        n_full = len(ids) // ps
        if n_full <= 0:
            return 0
        for lp in self._long_prefills:
            if (lp.ids != ids or self.slots[lp.slot_idx] is not lp.slot
                    or lp.req.cancelled):
                continue
            covered = min(lp.pos // ps, n_full)
            done = max(lp.published, lp.seq.n_shared)
            if covered > done:
                row = np.zeros((lp.s_total // ps,), np.int32)  # sink 0
                row[done:covered] = lp.seq.pages[done:covered]
                self._exec_publish_pages({"slot": np.int32(lp.slot_idx),
                                          "row": row})
            if covered > lp.published:
                self.prefix_cache.insert(ids[: covered * ps],
                                         lp.seq.pages[:covered])
                self._trim_prefix()
                lp.published = covered
            return lp.published
        dev, cold = self._cached_page_runs(ids)
        return min(len(dev) + len(cold), n_full)

    def import_prefix_pages(self, ids: Sequence[int], codes: torch.Tensor,
                            scales: Optional[torch.Tensor],
                            first_page: int = 0,
                            on_device: bool = False) -> int:
        """Seat transferred pages into this engine's pool and radix tree
        (the disagg transfer's target half): allocate pool pages (reclaim
        may evict or demote cold cached pages, as a promote does), ONE
        pages_to_pool scatter, then insert the prefix into the tree so
        the next admission of `ids` takes the normal prefix-cache hit
        path. `codes` / `scales` are host tensors (the GKVT wire) or, with
        `on_device`, device tensors from export_prefix_pages_device, on
        this pool's card or another (the copy_ into this pool's device
        is then the peer copy, ordered against both streams by torch);
        `first_page` says which page of ids' prefix codes[0] covers, so a
        chunked transfer imports window by window, each import deduping
        against what already landed. Returns pages imported (0 when the
        prefix is already resident); raises MemoryError when the
        allocator cannot cover the pages even after reclaim and
        ValueError when the window starts past the resident prefix (a
        gap) or the pages do not fit this pool's geometry. Scheduler
        thread only (run_control_op)."""
        if self.prefix_cache is None:
            raise RuntimeError("KV import needs engine.prefix_cache")
        codes_shape, codes_dtype, scales_shape = self._page_geometry()
        if (tuple(codes.shape[1:]) != codes_shape
                or codes.dtype != codes_dtype
                or (scales is None) != (scales_shape is None)
                or (scales is not None
                    and tuple(scales.shape) != (codes.shape[0],)
                    + scales_shape)):
            raise ValueError(
                f"KV import of pages {tuple(codes.shape[1:])} "
                f"{codes.dtype} into a pool of {codes_shape} {codes_dtype}")
        ps = self.pool.page_size
        first = max(0, int(first_page))
        n = min(first + int(codes.shape[0]), len(ids) // ps)
        if n <= first:
            return 0

        def resident_run(upto_pages: int) -> List:
            out = []
            for node in self.prefix_cache.match_nodes(
                    list(ids[: upto_pages * ps])):
                if node.tier != TIER_DEVICE:
                    break
                out.append(node)
            return out

        # Import only the NON-resident suffix: a growing multi-turn prefix
        # re-ships every turn, and pages for chunks the tree already holds
        # could reclaim hot cache.
        have = len(resident_run(n))
        if have >= n:
            return 0
        if have < first:
            raise ValueError(
                f"import window starts at page {first} but only "
                f"{have} pages of the prefix are resident — a chunk "
                "gap (an earlier window failed or was evicted)")
        t0 = time.perf_counter()
        m = n - have
        pages = self.allocator.alloc(m)
        try:
            if have and len(resident_run(have)) < have:
                # The alloc's reclaim evicted part of the resident prefix:
                # the suffix would link under missing ancestors.
                raise MemoryError(
                    "resident prefix evicted during import alloc")
            w = _pow2_ceil(m)
            row = np.zeros((w,), np.int64)  # pad: sink page 0
            row[:m] = pages
            buf = torch.zeros((w,) + codes_shape, dtype=codes_dtype,
                              device=self.device)
            buf[:m].copy_(codes[have - first: n - first], non_blocking=True)
            sbuf = None
            if scales is not None:
                sbuf = torch.zeros((w,) + scales_shape, dtype=torch.float32,
                                   device=self.device)
                sbuf[:m].copy_(scales[have - first: n - first],
                               non_blocking=True)
            self._exec_pages_in({"row": row}, buf, sbuf)
            # The leading `have` chunks are present (re-verified above,
            # and nothing evicts between here and the insert on this
            # thread), so the insert dedups them: only the fresh suffix
            # pages are adopted.
            lead = [nd.page for nd in resident_run(have)]
            self.prefix_cache.insert(list(ids[: n * ps]),
                                     lead + list(pages))
            self._trim_prefix()
        finally:
            # The tree retained its own references at the insert.
            self.allocator.release(pages)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.kv_transfer_pages += m
        self.metrics.kv_transfer_ms += dt_ms
        self.metrics.kv_transfer_chunks += 1
        if on_device:
            self.metrics.kv_transfer_device_pages += m
        self.metrics.hists["kv_transfer_ms_per_page"].observe(dt_ms / m)
        if self.flight.enabled:
            self.flight.record_event(EV_KV_TRANSFER, t0, a=float(m),
                                     b=dt_ms)
        return m

    # -- scheduler ---------------------------------------------------------

    def _put(self, x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x)).to(self.device)

    @property
    def _prefill_cap(self) -> int:
        cap = self.ecfg.max_prefill_group
        return cap if cap > 0 else self.ecfg.max_batch_size

    def _tier_depth(self, req: GenRequest, delta: int) -> None:
        """Move the per-tier waiting-depth gauge (kept with QoS off too:
        the beat records and the router read it). self._lock held."""
        d = self.metrics.qos_queue_depth
        tier = request_tier(req)
        d[tier] = max(0, d[tier] + delta)

    # graftlint: hot-path
    def _qos_pop_waiting(self) -> GenRequest:
        """Weighted-fair admission pop (QoS on; self._lock held): the
        least-served-per-weight tier, the least-served tenant in it, then
        arrival order."""
        idx = self.qos.pick(self.waiting)
        req = self.waiting[idx]
        del self.waiting[idx]
        return req

    # graftlint: hot-path
    def _qos_refresh_preemption(self) -> None:
        """Pause or resume long prefills at the beat boundary (QoS with
        qos_preempt_prefill): while an admitted latency-tier request is
        in its TTFT phase, lower-tier prefills dispatch no chunk and
        carry no rider. A latency-tier prefill never pauses; transitions
        are counted on their edge."""
        if self.qos is None or not self._long_prefills \
                or not self.ecfg.qos_preempt_prefill:
            return
        pressure = self._qos_latency_pressure()
        now = 0.0
        for lp in self._long_prefills:
            should = pressure and lp.tier != "latency"
            if should != lp.paused and self.flight.enabled:
                now = now or time.perf_counter()  # graftlint: ignore[GL703] timestamp feeds flight-recorder events only; the pause decision itself reads queue state, not the clock
                self.flight.record_event(
                    EV_QOS_PAUSE if should else EV_QOS_RESUME, now,
                    rid=lp.req.request_id, tier=tier_id(lp.tier),
                    a=float(lp.pos))
            if should and not lp.paused:
                self.metrics.qos_preemptions += 1
            lp.paused = should

    # graftlint: hot-path
    def _qos_latency_pressure(self) -> bool:
        """True while an ADMITTED latency-tier request is prefilling or
        awaiting its first token (a merely waiting one does not count:
        pausing for it could deadlock a prefill holding the only slot)."""
        for s in self.slots:
            if s is None or s.req.cancelled:
                continue
            if request_tier(s.req) != "latency":
                continue
            if s.prefilling or not s.first_emitted:
                return True
        return False

    def _free_slot_index(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _loop(self) -> None:
        """Admissions and decode dispatches are asynchronous; the only
        wait is for the OLDEST in-flight block, during which newer blocks
        keep the device busy and new arrivals are admitted."""
        while self._running:
            if self.chaos_beat_delay_s > 0.0:
                # Injected slow-replica latency (chaos drills only).
                time.sleep(self.chaos_beat_delay_s)
            self._drain_control_ops()
            did_work = self._admit_waiting()
            # Chunk forwards interleave with decode dispatches (paced by
            # the landed-block beat) instead of monopolizing the device.
            did_work = self._advance_long_prefills() or did_work
            self._emit_ready_first_tokens()
            while (len(self._inflight) < self.pipeline_depth
                   and any(s is not None for s in self.slots)):
                try:
                    if not self._dispatch_decode():
                        break
                    did_work = True
                except Exception:
                    # A failed decode leaves the pool state unknown: fail
                    # the active slots, keep serving new requests.
                    _LOG.exception("decode dispatch failed; failing batch")
                    self._fail_active()
                    break
            if self._inflight:
                self._land_next_block()
                did_work = True
            elif self._pending_first:
                self._wake.wait(timeout=0.001)
                self._wake.clear()
                continue
            if not did_work:
                self._wake.wait(timeout=0.02)
                self._wake.clear()

    # graftlint: hot-path
    def _land_next_block(self) -> None:
        """Land the oldest in-flight block: wait for it, emit / retire,
        release the pages parked on it, advance the beat and write its
        flight record."""
        fl = self._inflight.popleft()
        tokens_before = self.metrics.tokens_out
        t_ready = 0.0
        try:
            host = self._fetch_block_host(fl)
            t_ready = time.perf_counter()
            self._process_block_host(fl, host)
        except Exception:
            _LOG.exception("decode block failed; failing batch")
            self._fail_active()
        finally:
            for seq in fl.releases:
                seq.release()
            fl.releases = []
        self._reap_starved()
        self._beat += 1
        self._note_prefill_stalls()
        self._record_beat(fl, t_ready, self.metrics.tokens_out - tokens_before)

    # graftlint: hot-path
    def _record_beat(self, fl: _InFlight, t_ready: float,
                     emitted: int) -> None:
        """One beat record (and the beat-gap histogram sample) for a
        just-landed block. The histogram is always live; the ring append
        is one branch with the recorder off."""
        prev = self._last_beat_ready
        if t_ready:
            if prev:
                self.metrics.hists["beat_gap_ms"].observe(
                    (t_ready - prev) * 1e3)
            self._last_beat_ready = t_ready
        if not self.flight.enabled:
            self._beat_kv_demote = self._beat_kv_promote = 0
            return
        busy = [0, 0, 0]
        for s in self.slots:
            if s is not None and not s.req.cancelled:
                busy[tier_id(s.req)] += 1
        d = self.metrics.qos_queue_depth
        plan = fl.plan
        self.flight.record_beat(
            t_dispatch=fl.t_dispatch, t_ready=t_ready or fl.t_dispatch,
            t_prev_ready=prev, decode_k=plan.decode_k,
            spec_k=plan.spec_k, tree_branches=plan.tree_branches,
            rider_width=plan.rider_width, rider_s_total=plan.rider_s_total,
            spec_state=plan.spec_state, fused_rider=bool(plan.rider_width),
            qos_paused=any(lp.paused for lp in self._long_prefills),
            busy=tuple(busy), wait=(d["latency"], d["standard"], d["batch"]),
            tokens_emitted=emitted,
            kv_demote_pages=self._beat_kv_demote,
            kv_promote_pages=self._beat_kv_promote)
        self._beat_kv_demote = self._beat_kv_promote = 0

    def _fetch_block_host(self, fl: _InFlight) -> np.ndarray:
        """Wait for a block's host copy. While the device works, emit
        first tokens that have landed and admit arrivals older than a
        short debounce (a burst batches into few prefill groups)."""
        while not fl.copy.ready():
            self._emit_ready_first_tokens()
            with self._lock:
                oldest = self.waiting[0].submit_time if self.waiting else None
            if oldest is not None and \
                    time.perf_counter() - oldest >= self._admit_debounce_s:
                self._admit_waiting()
            time.sleep(0.0002)
        return fl.copy.numpy()

    def _emit_ready_first_tokens(self) -> None:
        for item in list(self._pending_first):
            copy, metas = item
            if all(slot.first_emitted or self.slots[i] is not slot
                   for i, slot in metas):
                self._pending_first.remove(item)
                continue
            if not copy.ready():
                continue
            self._pending_first.remove(item)
            self._emit_first_values(copy.numpy().reshape(-1), metas)

    def _admit_waiting(self) -> bool:
        """Admit every waiting request with a free slot, grouped by
        prefill bucket into batched prefill dispatches (at most
        max_prefill_group each)."""
        groups: Dict[int, List] = {}
        deferred_long: List[GenRequest] = []
        while True:
            with self._lock:
                if not self.waiting:
                    break
                slot_idx = self._free_slot_index()
                if slot_idx is None:
                    break
                # FIFO by default; with QoS the weighted-fair pick.
                req = (self.waiting.popleft() if self.qos is None
                       else self._qos_pop_waiting())
                self._tier_depth(req, -1)
            self._flight_note_pop(req)
            ids = req.prompt_ids or [0]
            long = len(ids) > self.buckets[-1]
            lane_full = len(self._long_prefills) >= self._max_long_prefills
            if long and lane_full:
                # One scratch cache at a time (a prefix hit takes the same
                # lane): the next long prompt waits at the head of the
                # queue, before any radix lookup.
                deferred_long.append(req)
                continue
            # With the lane full any hit is discarded below: look up
            # without promoting, so it costs no scatter.
            hit = (self._lookup_prefix(ids, promote=not lane_full)
                   if self.prefix_cache is not None else None)
            demoted = False
            if hit is not None and lane_full:
                # A short prompt with the lane busy: the plain batched
                # prefill rather than a wait for the lane.
                self._release_hit_pin(hit)
                hit, demoted = None, True
            seq = SequencePages(self.allocator, self.pool.page_size,
                                self.max_pages)
            try:
                if hit is not None:
                    seq.adopt(*hit)
                seq.ensure(len(ids))
            except MemoryError as e:
                seq.release()
                self._release_hit_pin(hit)
                self.metrics.admission_failures += 1
                if self.flight.enabled:
                    self.flight.record_event(
                        EV_ADMIT_RETRY, time.perf_counter(),
                        rid=req.request_id, tier=tier_id(req),
                        a=float(req.admission_attempts))
                ps = self.pool.page_size
                never_fits = -(-(len(ids) + 1) // ps) \
                    > self.allocator.n_pages - 1
                if not never_fits and not any(
                        s is not None for s in self.slots) \
                        and not self._inflight:
                    req.admission_attempts += 1
                if never_fits \
                        or req.admission_attempts >= MAX_ADMISSION_RETRIES:
                    _LOG.warning("admission failed terminally (%s); failing "
                                 "request", e)
                    req.stream.put({"text": "", "token_id": -1,
                                    "finished": True,
                                    "finish_reason": "error"})
                    continue
                with self._lock:
                    self.waiting.appendleft(req)
                    self._tier_depth(req, +1)
                break
            if self.prefix_cache is not None:
                if hit is not None:
                    self.metrics.prefix_hits += 1
                    self.metrics.prefix_hit_tokens += hit[1]
                elif not demoted:
                    # A hit sent to the batched prefill is not a miss.
                    self.metrics.prefix_miss += 1
            # Reserve the slot; the real _Slot replaces it at dispatch.
            placeholder = _Slot(req, seq, None)
            self.slots[slot_idx] = placeholder
            self._flight_admit(req, slot_idx)
            if self.qos is not None:
                # Only real admissions are charged (deferred and requeued
                # requests go back uncharged).
                self.qos.note_admitted(req)
            if hit is not None:
                try:
                    self._begin_prefix_prefill(req, slot_idx, seq, ids,
                                               *hit, placeholder)
                except Exception:
                    _LOG.exception("prefix-hit prefill setup failed")
                    self._fail_request(req, slot_idx, seq)
                continue
            if long:
                self._begin_long_prefill(req, slot_idx, seq, ids,
                                         placeholder)
                continue
            groups.setdefault(self._bucket_for(len(ids)), []).append(
                (req, slot_idx, seq, ids))
        if deferred_long:
            with self._lock:
                self.waiting.extendleft(reversed(deferred_long))
                for r in deferred_long:
                    self._tier_depth(r, +1)
        did = False
        cap = self._prefill_cap
        for bucket, entries in groups.items():
            for start in range(0, len(entries), cap):
                part = entries[start:start + cap]
                try:
                    self._prefill_group(bucket, part)
                    did = True
                except Exception:
                    _LOG.exception("prefill failed; failing %d requests",
                                   len(part))
                    for req, slot_idx, seq, _ in part:
                        self._fail_request(req, slot_idx, seq)
        return did

    def _begin_long_prefill(self, req: GenRequest, slot_idx: int,
                            seq: SequencePages, ids: List[int],
                            placeholder: _Slot) -> None:
        """Queue a chunked prefill for a prompt beyond the largest bucket:
        chunks of the largest bucket's width run through a contiguous
        scratch KVCache (the static scratch's first rows, from length 0
        at the first chunk) in
        _advance_long_prefills; _finish_long_prefill scatters it into the
        sequence's pages."""
        chunk = self.buckets[-1]
        s_total = -(-len(ids) // chunk) * chunk
        self._capture_first_sight(s_total, chunk)
        placeholder.prefilling = True
        self._long_prefills.append(
            _LongPrefill(req, slot_idx, seq, ids, s_total, placeholder,
                         chunk))

    def _capture_first_sight(self, s_total: int, chunk: int) -> None:
        """The JAX engine's compile-once on first sight: on a graphs
        engine, capture the points of scratch length s_total that the
        warmup left out (`step_graphs.first_sight_keys`: with a prefix
        cache the hit's seed, the chunk at `chunk`, the commit) before the
        prompt's seed or first chunk runs. At admission no prefill holds
        the scratch (one lane, `_max_long_prefills`), which a capture's
        eager run overwrites. A point the device cannot afford beside the
        memory planner's headroom line (the plan's, or the fraction of
        the device it would take) stays eager and is counted
        (`StepGraphs.stats`). A capture that fails raises."""
        graphs = self._graphs
        if graphs is None:
            return
        if self.memory_plan is not None:
            headroom = self.memory_plan.headroom_bytes
        else:
            from generativeaiexamples_tpu_torch.serving.memory_plan import (
                device_hbm_bytes)

            headroom = int(device_hbm_bytes(self.ecfg, self.device)
                           * max(0.0, self.ecfg.planner_headroom_fraction))
        graphs.capture_first_sight(step_graphs.first_sight_keys(
            s_total, chunk, self.prefix_cache is not None), headroom)

    # -- prefix cache ------------------------------------------------------

    def _reclaim_cached_pages(self, n: int) -> None:
        """The allocator's shortfall hook: evict (with the pager, demote)
        cold cached pages, so live traffic always wins over the cache.
        A pager demotion is a page move for the flight recorder."""
        freed = self.prefix_cache.evict(n)
        self.metrics.prefix_evictions += freed
        if freed and self.kv_pager is not None:
            self._beat_kv_demote += freed
            if self.flight.enabled:
                self.flight.record_event(EV_KV_DEMOTE, time.perf_counter(),
                                         a=float(freed))

    # graftlint: hot-path
    def _lookup_prefix(self, ids: List[int], promote: bool = True):
        """Longest cached page-granular prefix of this prompt, capped at
        len(ids) - 1 so at least one suffix token runs through the model
        (its logits sample the first output token). Returns (pages,
        n_tokens) or None. When the cap lands mid-page the last page is
        gather-only (`SequencePages.adopt` makes it a copy-on-write tail)
        and is PINNED here: the adopt/ensure allocations before the
        gather can trigger reclaim eviction of refcount-1 tree pages, and
        the sequence holds no reference of its own to it. Every consumer
        of a hit releases the pin (`_release_hit_pin`).

        With the pager the match may reach demoted nodes: the matched
        path is promoted back into the pool with one scatter. Without
        `promote`, or when the allocator cannot cover the cold pages even
        after reclaim, the hit keeps the leading device-resident run (the
        resident set is closed under ancestors, so that is always a
        prefix of the path)."""
        ps = self.pool.page_size
        if self.kv_pager is None:
            pages = self.prefix_cache.match(ids)
            m = min(len(pages) * ps, len(ids) - 1)
            if m <= 0:
                return None
        else:
            nodes = self.prefix_cache.match_nodes(ids)
            m = min(len(nodes) * ps, len(ids) - 1)
            if m <= 0:
                return None
            nodes = nodes[: -(-m // ps)]
            n_cold = sum(n.tier != TIER_DEVICE for n in nodes)
            promoted = False
            if n_cold and promote:
                t0 = time.perf_counter()  # graftlint: ignore[GL703] times the host-side promote for kv_promote_ms_per_page; the prefix-hit decision is made from tree state above
                try:
                    self.pool = self.prefix_cache.promote(self.pool, nodes)
                    promoted = True
                except MemoryError:
                    pass  # the resident prefix below
                if promoted:
                    # Host time of the promotion: tier reads, staging and
                    # the copy to the card (the scatter is queued).
                    dt_ms = (time.perf_counter() - t0) * 1e3  # graftlint: ignore[GL703] metrics-only read (see t0 above)
                    self.metrics.kv_promote_ms += dt_ms
                    self.metrics.hists["kv_promote_ms_per_page"].observe(
                        dt_ms / n_cold)
                    self._beat_kv_promote += n_cold
                    if self.flight.enabled:
                        self.flight.record_event(EV_KV_PROMOTE, t0,
                                                 a=float(n_cold), b=dt_ms)
            if n_cold and not promoted:
                keep = []
                for n in nodes:
                    if n.tier != TIER_DEVICE:
                        break
                    keep.append(n)
                nodes = keep
                m = min(len(nodes) * ps, len(ids) - 1)
                if m <= 0:
                    return None
            pages = [n.page for n in nodes]
        pages = pages[: -(-m // ps)]
        if m % ps:
            self.allocator.retain([pages[-1]])
        return pages, m

    def _release_hit_pin(self, hit) -> None:
        """Drop _lookup_prefix's pin on the gather-only tail page (a no-op
        for a page-aligned hit or None)."""
        if hit is not None and hit[1] % self.pool.page_size:
            self.allocator.release([hit[0][-1]])

    def _insert_prefix(self, ids: List[int], seq: SequencePages) -> None:
        """Register a completed prefill's FULL prompt pages in the radix
        tree (a partial tail page stays private: decode writes into it).
        The tree retains its own references; where a chunk is already
        cached the existing page wins and the duplicate stays with the
        sequence. The caller trims the tree after (`_trim_prefix`)."""
        n_full = len(ids) // self.pool.page_size
        if self.prefix_cache is not None and n_full > 0:
            self.prefix_cache.insert(list(ids), seq.pages[:n_full])

    def _trim_prefix(self) -> None:
        """Evict (with the pager, demote) the tree down to its capacity."""
        if self.prefix_cache is not None:
            self.metrics.prefix_evictions += self.prefix_cache.trim()

    def _begin_prefix_prefill(self, req: GenRequest, slot_idx: int,
                              seq: SequencePages, ids: List[int],
                              pages: List[int], m: int,
                              placeholder: _Slot) -> None:
        """Admission of a prefix-cache hit: seed a scratch cache with the
        matched pages' k/v (one gather, the values decode attention reads
        for those pages) and run ONLY the suffix ids[m:] through the
        chunked lane, its queries offset by m. The finish scatter points
        the adopted read-only rows at the sink, so shared pages are never
        rewritten; a CoW tail page is rewritten whole (gathered head and
        computed tail). Owns _lookup_prefix's pin on the gather-only tail
        page: released once the gather is issued (any later write to that
        page is queued behind it on the same stream) or on failure."""
        try:
            ps = self.pool.page_size
            plen = len(ids)
            if plen <= self.buckets[-1]:
                chunk = self._bucket_for(plen - m)
                s_total = self._bucket_for(plen)
            else:
                chunk = self.buckets[-1]
                s_total = -(-plen // chunk) * chunk
            self._capture_first_sight(s_total, chunk)
            row = np.zeros((s_total // ps,), np.int32)
            row[:len(pages)] = pages
            self._exec_seed({"slot": np.int32(slot_idx), "row": row,
                             "m": np.int32(m)})
        finally:
            self._release_hit_pin((pages, m))
        placeholder.prefilling = True
        lp = _LongPrefill(req, slot_idx, seq, ids, s_total, placeholder,
                          chunk)
        lp.pos = m
        self._long_prefills.append(lp)

    def _advance_long_prefills(self) -> bool:
        """Dispatch the next chunk(s) of each in-progress long prefill
        (paced by the landed-block beat while decode traffic is live);
        finish those whose prompt is fully fed. With the fused rider this
        is the fallback lane: a prefill whose next chunk the next decode
        dispatch will carry (_fuse_ready) is skipped. Returns True if any
        advanced."""
        did = False
        self._qos_refresh_preemption()
        decoding = any(s is not None and not s.prefilling
                       for s in self.slots)
        for lp in list(self._long_prefills):
            if self.slots[lp.slot_idx] is not lp.slot:
                # Failed or retired while prefilling (_finish released
                # the pages).
                self._long_prefills.remove(lp)
                self._drop_scratch(lp.slot_idx)
                continue
            if lp.req.cancelled:
                self._long_prefills.remove(lp)
                self._drop_scratch(lp.slot_idx)
                self._finish(lp.slot_idx, "cancelled")
                continue
            if lp.paused:
                # QoS: a latency-tier TTFT phase holds the device; this
                # prefill resumes from pos and its scratch cache.
                continue
            if decoding and self._fuse_ready(lp):
                continue  # the next decode dispatch carries the chunk
            if decoding and lp.beat == self._beat:
                continue  # this beat's chunks already went out
            lp.beat = self._beat
            n_chunks = max(1, self.ecfg.prefill_chunks_per_block) \
                if decoding else 1
            try:
                for _ in range(n_chunks):
                    if self._dispatch_chunk(lp):
                        self._long_prefills.remove(lp)
                        self._finish_long_prefill(lp)
                        break
            except Exception:
                _LOG.exception("chunked prefill failed")
                self._long_prefills.remove(lp)
                self._drop_scratch(lp.slot_idx)
                self._fail_request(lp.req, lp.slot_idx, lp.seq)
            did = True
        return did

    def _dispatch_chunk(self, lp: _LongPrefill) -> bool:
        """Dispatch the next chunk of `lp` as a chunk-only plan; True when
        it completed the prompt. Under fused_sampling that chunk samples
        the first token in the same call (rider_sample)."""
        n_part = min(lp.chunk, len(lp.ids) - lp.pos)
        width = self._pick_chunk_width(n_part, lp.chunk, lp.s_total)
        final = lp.pos + n_part >= len(lp.ids)
        # On a warmed engine only where that chunk's tail was warmed.
        fuse_sample = (final and self._fused_sampling
                       and (not self._warm_ks or (lp.s_total, width)
                            in self._warm_sample_chunks))
        self._exec_plan(self._plan_record(engine_model.StepPlan(
            rider_width=width, rider_s_total=lp.s_total,
            rider_sample=fuse_sample), lp, n_part))
        if fuse_sample:
            self.metrics.fused_sample_dispatches += 1
        lp.pos += n_part
        self.metrics.prefill_tokens += n_part
        if self.flight.enabled:
            self.flight.record_event(EV_PREFILL_CHUNK, time.perf_counter(),
                                     rid=lp.req.request_id,
                                     tier=tier_id(lp.tier), a=float(n_part))
        return final

    def _chunk_buf(self, width: int) -> np.ndarray:
        """Zeroed (1, width) int32 staging buffer, one per width for the
        engine's lifetime (_put copies it before the next reuse)."""
        buf = self._chunk_staging.get(width)
        if buf is None:
            buf = self._chunk_staging[width] = np.zeros((1, width), np.int32)
        else:
            buf.fill(0)
        return buf

    def _plan_record(self, plan: "engine_model.StepPlan",
                     lp: Optional[_LongPrefill] = None, n_part: int = 0,
                     **arrays) -> Dict[str, Any]:
        """The `plan` dispatch record of `plan`: its lattice point, the
        decode batch's host arrays (`arrays`), and for a plan with a
        chunk, lp's next n_part prompt tokens padded to rider_width, the
        slot, whether this is the prompt's first chunk (the scratch cache
        is made, zeroed, there) and, for a rider_sample plan, the
        finishing request's sampling scalars."""
        rec = engine_model.plan_to_record(plan)
        rec.update(arrays)
        if plan.rider_width:
            tok = self._chunk_buf(plan.rider_width)
            tok[0, :n_part] = lp.ids[lp.pos:lp.pos + n_part]
            rec.update(slot=np.int32(lp.slot_idx), chunk_tokens=tok,
                       chunk_valid=np.int32(n_part),
                       fresh=np.bool_(lp.pos == 0))
        if plan.rider_sample:
            req = lp.req
            rec.update(r_temp=np.float32(req.temperature),
                       r_top_p=np.float32(req.top_p),
                       r_top_k=np.int32(req.top_k),
                       r_flags=np.asarray(_sampling_flags(
                           req.temperature <= 0.0)))
        return rec

    # -- dispatch-record executors (the replay vocabulary) -----------------
    #
    # Every scheduler-reachable device launch lives in one of the _exec_*
    # methods below (and the pager's demote / promote). Each builds its
    # device inputs FROM THE RECORD alone, publishes the record right
    # before launching (leader only: followers run the same executor via
    # _mh_replay_table with _mh_leader False) and folds the device state
    # back into the engine. Leader-only state (slots, the radix tree, the
    # allocator, QoS) never enters an executor.

    def _publish(self, kind: str, rec: Dict[str, Any]) -> None:
        if self._mh_log is not None and self._mh_leader:
            self._mh_log.publish(kind, **rec)

    def _exec_prefill(self, rec: Dict[str, Any]) -> torch.Tensor:
        """One `prefill` record: the batched prefill forward with its
        first-token sample on the device, the scatter of the first tokens
        into the token buffer (padding rows' indices are dropped on the
        device) and, on a speculative engine, the history rows. A warmed
        (bucket, group, flags) point replays its CUDA graph. Returns the
        tokens (a graph's static buffer: the caller queues its host copy
        before the next dispatch)."""
        self._publish("prefill", rec)
        flags = tuple(bool(f) for f in rec["flags"])
        graphs = self._graphs
        n, bucket = rec["tokens"].shape
        if graphs is not None and graphs.has(("prefill", bucket, n, flags)):
            self._adopt_graph_state(graphs)
            return graphs.replay_prefill(rec, flags)
        if self._warm_ks and self.device.type == "cuda":
            self.metrics.eager_prefill_dispatches += 1
        d_tokens, d_lengths = self._put(rec["tokens"]), self._put(
            rec["lengths"])
        idxs = self._put(rec["idxs"])
        toks = engine_model.prefill_batch_step(
            self.params, self.cfg, self.pool, d_tokens, d_lengths,
            self._put(rec["rows"]), self._put(rec["temps"]),
            self._put(rec["top_ps"]), self._put(rec["top_ks"]),
            self._generator, sampling_flags=flags)
        engine_model.set_last_tokens(self._last_tokens, idxs, toks)
        if self._spec_k:
            engine_model.set_history_rows(self._history, self._dev_lengths,
                                          idxs, d_tokens, d_lengths, toks)
        return toks

    def _exec_plan(self, rec: Dict[str, Any]) -> dict:
        """One `plan` record (`_plan_record`): the StepPlan lowered
        through engine_model.plan_step, with the device state it returns
        folded back into the engine. A plan with a chunk runs it through
        the slot's scratch cache (the first rider_s_total rows of the
        static scratch, from length 0 at the prompt's first chunk) and
        stashes the chunk's logits, or the first token a rider_sample
        plan drew, in _chunk_res for the commit. A plan whose every part
        was warmed replays its graphs (serving/step_graphs.py)."""
        self._publish("plan", rec)
        plan = engine_model.plan_from_record(rec)
        kw: Dict[str, Any] = {}
        flags = (tuple(bool(f) for f in rec["flags"]) if "flags" in rec
                 else _GREEDY)
        r_flags = (tuple(bool(f) for f in rec["r_flags"])
                   if plan.rider_sample else None)
        slot = int(rec["slot"]) if plan.rider_width else -1
        if plan.rider_width:
            if bool(rec["fresh"]) or slot not in self._scratch_caches:
                self._scratch_caches[slot] = self._scratch_view(
                    plan.rider_s_total)
                self._chunk_res.pop(slot, None)
            kw["cache"] = self._scratch_caches[slot]
        graphs = self._graphs
        if graphs is not None and not graphs.covers(plan, flags, r_flags):
            graphs = None
        if graphs is not None:
            # Every part warmed: replayed from the record's host arrays
            # (serving/step_graphs.py).
            kw.update(pool=self.pool, last_tokens=self._last_tokens,
                      arrays=rec, sampling_flags=flags, chunk_flags=r_flags)
            if self._spec_k:
                kw.update(history=self._history,
                          dev_lengths=self._dev_lengths)
        else:
            if plan.rider_width and self._warm_ks \
                    and self.device.type == "cuda":
                self.metrics.eager_chunk_dispatches += 1
            if plan.decode_k:
                kw.update(pool=self.pool, last_tokens=self._last_tokens,
                          page_tables=self._put(rec["tables"]),
                          active=self._put(rec["active_mask"]))
                if self._spec_k:
                    kw.update(history=self._history,
                              dev_lengths=self._dev_lengths)
                if not plan.spec_k:
                    kw.update(lengths=self._put(rec["lengths"]),
                              temperature=self._put(rec["temps"]),
                              top_p=self._put(rec["top_ps"]),
                              top_k=self._put(rec["top_ks"]),
                              generator=self._generator,
                              sampling_flags=flags)
            if plan.rider_width:
                kw.update(chunk_tokens=self._put(rec["chunk_tokens"]),
                          chunk_valid=int(rec["chunk_valid"]))
            if plan.rider_sample:
                kw.update(last_tokens=self._last_tokens, slot_idx=slot,
                          temperature=float(rec["r_temp"]),
                          top_p=float(rec["r_top_p"]),
                          top_k=int(rec["r_top_k"]),
                          generator=self._generator, sampling_flags=r_flags)
        res = engine_model.plan_step(self.params, self.cfg, plan,
                                     graphs=graphs, **kw)
        if "last_tokens" in res:
            self._last_tokens = res["last_tokens"]
        if "dev_lengths" in res:
            self._dev_lengths = res["dev_lengths"]
            self._history = res["history"]
        if plan.rider_width:
            self._scratch_caches[slot] = res["cache"]
            self._chunk_res[slot] = (res.get("chunk_logits"),
                                     res.get("tok0"))
        return res

    def _exec_seed(self, rec: Dict[str, Any]) -> None:
        """One `seed` record: a prefix hit's scratch cache, ONE
        pool_to_cache gather of the matched pages into the first S_total
        rows of the static scratch (the row rides the record, so
        followers launch the same gather without the radix tree); a
        warmed S_total replays its graph."""
        self._publish("seed", rec)
        slot = int(rec["slot"])
        s_total = len(rec["row"]) * self.pool.page_size
        cache = self._scratch_view(s_total, reset=False)
        graphs = self._graphs
        if graphs is not None and graphs.has(("seed", s_total)):
            graphs.replay_point(("seed", s_total), rec)
        else:
            engine_model.pool_to_cache(self.pool, self.cfg,
                                       self._put(rec["row"]), int(rec["m"]),
                                       out=cache)
        self._scratch_caches[slot] = cache
        self._chunk_res.pop(slot, None)

    def _exec_commit(self, rec: Dict[str, Any]) -> torch.Tensor:
        """One `commit` record, the chunked-prefill finish: ONE
        cache_to_pool scatter of the slot's scratch cache (rows the leader
        sank to page 0 are never rewritten), the first-token sample unless
        the last chunk drew it (sample_token_into, or with fused_sampling
        off the sample_token + set_last_token pair) and, on a speculative
        engine, the history row. A warmed scratch length replays the
        scatter's graph, and a sample from a replayed chunk's logits the
        finish sampler's (the same math and draws). Consumes the slot's
        scratch state on every rank. Returns the first token [1]."""
        self._publish("commit", rec)
        slot = int(rec["slot"])
        cache = self._scratch_caches.pop(slot)
        self._release_scratch()
        s_total = cache.k.shape[3]
        graphs = self._graphs
        if graphs is not None and graphs.has(("commit", s_total)):
            graphs.replay_point(("commit", s_total), rec)
        else:
            engine_model.cache_to_pool(self.pool, cache, self.cfg,
                                       self._put(rec["row"]))
        logits, tok0 = self._chunk_res.pop(slot)
        if tok0 is None:
            flags = tuple(bool(f) for f in rec["flags"])
            if (graphs is not None and logits is graphs.chunk_logits
                    and graphs.has(("finish", flags))):
                self._adopt_graph_state(graphs)
                tok0 = graphs.replay_point(("finish", flags), {
                    "slot": rec["slot"], "r_temp": rec["temp"],
                    "r_top_p": rec["top_p"], "r_top_k": rec["top_k"]})["tok0"]
                if self._fused_sampling:
                    self.metrics.fused_sample_dispatches += 1
            else:
                sampling = (float(rec["temp"]), float(rec["top_p"]),
                            int(rec["top_k"]), self._generator, *flags)
                if self._fused_sampling:
                    tok0, self._last_tokens = engine_model.sample_token_into(
                        self._last_tokens, slot, logits, *sampling)
                    self.metrics.fused_sample_dispatches += 1
                else:
                    tok0 = engine_model.sample_token(logits, *sampling)
                    self._last_tokens = engine_model.set_last_token(
                        self._last_tokens, slot, tok0)
        tok0 = tok0.reshape(1)
        if self._spec_k and graphs is not None \
                and graphs.has(("history",)):
            self._adopt_graph_state(graphs)
            ids = rec["h_ids"]
            graphs.replay_point(("history",), {
                "h_ids": ids, "h_len": np.asarray([len(ids)], np.int32),
                "slot": rec["slot"]})
        elif self._spec_k:
            ids = np.asarray(rec["h_ids"], np.int32)
            hist = np.zeros((1, self.ecfg.max_seq_len), np.int32)
            hist[0, :len(ids)] = ids
            engine_model.set_history_rows(
                self._history, self._dev_lengths,
                self._put(np.asarray([slot], np.int32)), self._put(hist),
                self._put(np.asarray([len(ids)], np.int32)), tok0)
        return tok0

    def _exec_pages_out(self, rec: Dict[str, Any]):
        """One `pages_out` record: a batched pool_to_pages gather (the
        page export), its kv-head slices gathered over the tensor axis
        into whole pages. The leader reads the bytes, a follower drops
        them."""
        self._publish("pages_out", rec)
        return self._gather_heads(*engine_model.pool_to_pages(
            self.pool, self._put(rec["row"])))

    def _exec_pages_in(self, rec: Dict[str, Any], buf=None,
                       sbuf=None) -> None:
        """One `pages_in` record: ONE pages_to_pool scatter of imported
        page bytes. The record carries the padded whole pages (raw bytes
        with their dtype's name) and scales, so followers rebuild the
        same device inputs; the leader passes its buffers. Each rank of
        a tensor-parallel mesh scatters its kv heads' slice."""
        if self._mh_log is not None and self._mh_leader:
            from generativeaiexamples_tpu_torch.serving import multihost as mh

            # The leader's import buffers hold the whole pages (each rank
            # slices its heads below): its own tensors, fetched whole.
            rec = {**rec, "codes": mh.fetch_addressable(
                buf.view(_RAW_DTYPES.get(buf.dtype, buf.dtype)),
                "pages_in record (codes)"),
                "codes_dtype": np.asarray(str(buf.dtype))}
            if sbuf is not None:
                rec["scales"] = mh.fetch_addressable(
                    sbuf, "pages_in record (scales)")
            self._publish("pages_in", rec)
        if buf is None:
            dtype = getattr(torch, str(rec["codes_dtype"]).split(".")[-1])
            buf = self._put(rec["codes"]).view(dtype)
            if "scales" in rec:
                sbuf = self._put(rec["scales"])
        if self.mesh is not None:
            heads = shd.pool_shard_heads(buf.shape[3], self.mesh)
            buf = buf[:, :, :, heads].contiguous()
            if sbuf is not None:
                sbuf = sbuf[:, :, :, heads].contiguous()
        self.pool = engine_model.pages_to_pool(self.pool, buf, sbuf,
                                               self._put(rec["row"]))

    def _exec_publish_pages(self, rec: Dict[str, Any]) -> None:
        """One `publish_pages` record: the pipelined export's partial
        cache_to_pool scatter of an in-flight chunked prefill's completed
        pages (the scratch cache stays registered)."""
        self._publish("publish_pages", rec)
        engine_model.cache_to_pool(
            self.pool, self._scratch_caches[int(rec["slot"])], self.cfg,
            self._put(rec["row"]))

    def _exec_pager_out(self, rec: Dict[str, Any]) -> None:
        """Follower half of KVPager.demote (`pager_out`; the leader's
        publish is in the pager, before ITS gather): the record's freed
        keys released, the same pool_to_pages gather, then this rank's
        slices parked in its own pager's tiers under the record's cold
        keys (a rank's pool holds only its kv heads)."""
        from generativeaiexamples_tpu_torch.serving import multihost as mh

        self.kv_pager.release_parked(rec["free"])
        codes, scales = engine_model.pool_to_pages(self.pool,
                                                   self._put(rec["row"]))
        codes = mh.fetch_addressable(codes.view(
            _RAW_DTYPES.get(codes.dtype, codes.dtype)),
            "pager demote gather (codes)")
        if scales is not None:
            scales = mh.fetch_addressable(scales,
                                          "pager demote gather (scales)")
        self.kv_pager.park(rec["keys"][:int(rec["n"])], codes, scales)

    def _read_cold(self, nodes):
        """The pager's bytes of cold `nodes` (tree nodes, or a follower's
        parked pages) as (codes [n, ...] in the pool dtype, scales or
        None) host tensors."""
        codes_shape, codes_dtype, scales_shape = page_geometry(self.pool)
        codes = torch.zeros((len(nodes),) + codes_shape, dtype=codes_dtype)
        scales = (torch.zeros((len(nodes),) + scales_shape,
                              dtype=torch.float32) if scales_shape else None)
        self.kv_pager.read_pages(
            nodes, codes.view(_RAW_DTYPES.get(codes_dtype,
                                              codes_dtype)).numpy(),
            None if scales is None else scales.numpy())
        return codes, scales

    def _read_parked(self, keys, kind: str):
        """This rank's parked slices under `keys` (_read_cold). A cold key
        this rank never parked means the streams diverged: raise by
        name."""
        from generativeaiexamples_tpu_torch.serving import multihost as mh

        nodes = self.kv_pager.parked(keys)
        for key, node in zip(keys, nodes):
            if node is None:
                raise mh.MultihostError(
                    f"{kind} references cold key {int(key)} this rank "
                    "never parked (pager_out) — leader and follower "
                    "replay streams have diverged")
        return self._read_cold(nodes)

    def _exec_pager_in(self, rec: Dict[str, Any]) -> None:
        """Follower half of KVPager.promote_into (`pager_in`): the
        promoted pages rebuilt from this rank's parked slices (released
        after, with the record's freed keys) and the same pages_to_pool
        scatter the leader launched."""
        row = np.asarray(rec["row"])
        n = int(rec["n"])
        keys = rec["keys"][:n]
        got, got_s = self._read_parked(keys, "pager_in")
        codes_shape, codes_dtype, scales_shape = page_geometry(self.pool)
        w = int(row.shape[0])
        codes = torch.zeros((w,) + codes_shape, dtype=codes_dtype)
        codes[:n] = got
        scales = None
        if got_s is not None:
            scales = torch.zeros((w,) + scales_shape, dtype=torch.float32)
            scales[:n] = got_s
        self.kv_pager.release_parked(np.concatenate(
            [np.asarray(keys, np.int64), rec["free"]]))
        self.pool = engine_model.pages_to_pool(
            self.pool, codes.to(self.device),
            None if scales is None else scales.to(self.device),
            self._put(row))

    def _exec_cold_out(self, rec: Dict[str, Any], nodes=None):
        """One `cold_out` record (a tensor-parallel export's demoted
        tail): every rank reads its slices of the named cold pages (the
        leader from its tree's `nodes`, a follower from its parked store)
        and the slices are gathered over the tensor axis. Returns whole
        pages (codes, scales or None) on the device."""
        self._publish("cold_out", rec)
        codes, scales = (self._read_parked(rec["keys"], "cold_out")
                         if nodes is None else self._read_cold(nodes))
        return self._gather_heads(
            codes.to(self.device),
            None if scales is None else scales.to(self.device))

    def _gather_heads(self, codes: torch.Tensor,
                      scales: Optional[torch.Tensor]):
        """Page-major pages ([n, 2, L, KH, ...]) holding this rank's kv
        heads -> whole pages, every rank's heads in order (one all-gather
        of the raw bytes over the tensor axis); as given on one device."""
        if self.mesh is None:
            return codes, scales

        def gather(x):
            return mesh_lib.tensor_all_gather(
                x.contiguous().view(torch.uint8), dim=3).view(x.dtype)

        return gather(codes), None if scales is None else gather(scales)

    def _page_geometry(self):
        """(codes shape, dtype, scales shape or None) of one page as it
        leaves or enters the engine: whole pages with every kv head, also
        under a tensor-parallel mesh, whose ranks' pools hold a slice."""
        codes_shape, codes_dtype, scales_shape = page_geometry(self.pool)
        if self.mesh is None:
            return codes_shape, codes_dtype, scales_shape

        def whole(shape):
            return shape[:2] + (self.model_cfg.n_kv_heads,) + shape[3:]

        return (whole(codes_shape), codes_dtype,
                None if scales_shape is None else whole(scales_shape))

    def _mh_replay_table(self) -> Dict[str, Any]:
        """kind -> executor for multihost.run_follower: the whole launch
        vocabulary a leader publishes. Followers call the executors the
        leader's scheduler calls (with _mh_leader False, so the publish
        inside each is skipped)."""
        return {"prefill": self._exec_prefill,
                "plan": self._exec_plan,
                "seed": self._exec_seed,
                "commit": self._exec_commit,
                "pages_out": self._exec_pages_out,
                "pages_in": self._exec_pages_in,
                "publish_pages": self._exec_publish_pages,
                "pager_out": self._exec_pager_out,
                "pager_in": self._exec_pager_in,
                "cold_out": self._exec_cold_out}

    def _pick_k(self, bound: int) -> int:
        """The largest dispatchable block length <= bound: a power of two
        and, on a warmed engine, a warmed one (K = 1 always is), as the
        JAX engine's _pick_k."""
        k = _pow2_floor(bound)
        if self._warm_ks and k not in self._warm_ks:
            k = max(w for w in self._warm_ks if w <= k)
        return k

    def _pick_chunk_width(self, n: int, chunk: int, s_total: int) -> int:
        """Dispatch width for a chunk of n valid tokens: the smallest
        power of two >= n, capped at the full chunk. On a warmed engine,
        the smallest warmed width for this scratch length that holds n,
        or the full chunk, as the JAX engine's _pick_chunk_width."""
        w = _pow2_ceil(n)
        if w >= chunk:
            return chunk
        if self._warm_ks or self._warm_chunk_widths:
            fits = sorted(x for (s, x) in self._warm_chunk_widths
                          if s == s_total and n <= x < chunk)
            return fits[0] if fits else chunk
        return w

    def _drop_scratch(self, slot_idx: int) -> None:
        """Free the scratch cache of a long prefill that ended without a
        finish (cancel, slot failure)."""
        self._scratch_caches.pop(slot_idx, None)
        self._chunk_res.pop(slot_idx, None)
        self._release_scratch()

    def _release_scratch(self) -> None:
        """An engine without graphs frees its static scratch while no
        prefill holds it, as a scratch made per prompt was freed; a
        graphs engine keeps it (its graphs address it)."""
        if self._graphs is None and not self._scratch_caches:
            self._scratch_store = None

    def _finish_long_prefill(self, lp: _LongPrefill) -> None:
        """Last chunk fed, the commit: scatter the scratch cache into the
        sequence's pages (padding rows and the rows of pages shared with
        the prefix cache to the sink), sample the first token from the
        last chunk's logits unless that chunk sampled it, register the
        full pages in the cache, open the slot for decode and emit the
        first token."""
        ps = self.pool.page_size
        row = np.zeros((lp.s_total // ps,), np.int32)
        row[:len(lp.seq.pages)] = lp.seq.pages
        # Pages adopted read-only from the prefix cache are never
        # rewritten: their rows scatter into the sink. (A CoW tail page
        # is private and is rewritten whole from the scratch cache.)
        # Pages publish_prefill_pages already scattered sink too: each
        # page is written once.
        row[:max(lp.seq.n_shared, lp.published)] = 0
        req = lp.req
        rec = {"slot": np.int32(lp.slot_idx), "row": row,
               "temp": np.float32(req.temperature),
               "top_p": np.float32(req.top_p), "top_k": np.int32(req.top_k),
               "flags": np.asarray(_sampling_flags(req.temperature <= 0.0))}
        if self._spec_k:
            rec["h_ids"] = np.asarray(lp.ids, np.int32)
        tok0 = self._exec_commit(rec)
        self._insert_prefix(lp.ids, lp.seq)
        span = tracing.ManualSpan(
            "engine.generate", context=lp.req.trace_context,
            attributes={"prompt_tokens": len(lp.ids),
                        "chunked_prefill": True,
                        "request_id": lp.req.request_id})
        slot = _Slot(lp.req, lp.seq, StreamDetokenizer(self.tokenizer),
                     span=span)
        self.slots[lp.slot_idx] = slot
        # The first token is only the scatter (and the finish sampler)
        # and a 4-byte copy away: emit it now. Left pending, it would
        # wait behind the next decode dispatches (tens of ms of host
        # launches each). The trim comes after it, as it may demote
        # pages to the host.
        self._emit_first_values(tok0.cpu().numpy(), [(lp.slot_idx, slot)])
        self._trim_prefix()

    def _fail_request(self, req: GenRequest, slot_idx: int,
                      seq: SequencePages) -> None:
        if self.slots[slot_idx] is not None:
            self._flight_retire(self.slots[slot_idx], "error")
        self.slots[slot_idx] = None
        seq.release()
        req.stream.put({"text": "", "token_id": -1, "finished": True,
                        "finish_reason": "error"})

    def _fail_active(self) -> None:
        for fl in self._inflight:
            for seq in fl.releases:
                seq.release()
        self._inflight.clear()
        for i, s in enumerate(self.slots):
            if s is not None:
                self._finish(i, "error")

    def _prefill_group(self, bucket: int, entries: List) -> None:
        """One batched prefill dispatch for a same-bucket group: forward,
        first-token sampling on the device and the scatter into the
        device token buffer. No host wait: the first tokens' host copy is
        emitted when it lands."""
        ps = self.pool.page_size
        n = len(entries)
        N = 1  # pad the group to a power of two
        while N < n:
            N *= 2
        tokens = np.zeros((N, bucket), np.int32)
        lengths = np.ones((N,), np.int32)
        rows = np.zeros((N, bucket // ps), np.int32)
        temps = np.zeros((N,), np.float32)
        top_ps = np.ones((N,), np.float32)
        top_ks = np.zeros((N,), np.int32)
        idxs = np.full((N,), len(self.slots), np.int32)  # padding: dropped
        for j, (req, slot_idx, seq, ids) in enumerate(entries):
            tokens[j, :len(ids)] = ids
            lengths[j] = len(ids)
            rows[j, :len(seq.pages)] = seq.pages
            temps[j] = req.temperature
            top_ps[j] = req.top_p
            top_ks[j] = req.top_k
            idxs[j] = slot_idx
        flags = _sampling_flags(bool(all(temps[:n] <= 0.0)))
        toks = self._exec_prefill({
            "tokens": tokens, "lengths": lengths, "rows": rows,
            "temps": temps, "top_ps": top_ps, "top_ks": top_ks,
            "idxs": idxs, "flags": np.asarray(flags)})
        metas = []
        for req, slot_idx, seq, ids in entries:
            span = tracing.ManualSpan(
                "engine.generate", context=req.trace_context,
                attributes={"prompt_tokens": len(ids),
                            "request_id": req.request_id})
            slot = _Slot(req, seq, StreamDetokenizer(self.tokenizer),
                         span=span)
            self.slots[slot_idx] = slot
            metas.append((slot_idx, slot))
            self.metrics.prefill_tokens += len(ids)
            if self.flight.enabled:
                self.flight.record_event(
                    EV_PREFILL_DISPATCH, time.perf_counter(),
                    rid=req.request_id, tier=tier_id(req), slot=slot_idx,
                    a=float(len(ids)))
            # Its full prompt pages become reusable; a later gather of
            # them is queued behind these writes on the same stream.
            self._insert_prefix(ids, seq)
            self._trim_prefix()
        self._pending_first.append((HostCopy(toks), metas))

    def _slot_used(self, slot: _Slot) -> int:
        """Tokens the slot's pages must already cover: the host-exact
        length on a plain engine; on a speculative one, where lengths are
        device-authoritative, the reconciled length plus the worst case
        of the blocks in flight."""
        return (slot.kv_len + slot.kv_worst) if self._spec_k \
            else slot.seq.length

    def _sampled_live(self) -> bool:
        """A live, dispatchable slot wants sampling (temperature > 0): on
        a speculative engine the next dispatch then runs the plain
        fallback block, since greedy verification cannot honour it. A
        sampled slot without page capacity for one token does not count
        (the live filter starves it anyway)."""
        return any(
            s is not None and not s.prefilling and not s.req.cancelled
            and s.req.temperature > 0.0
            and s.req.max_new_tokens - s.scheduled > 0
            and self._advance_capacity(s, self._slot_used(s))[0] >= 1
            for s in self.slots)

    # graftlint: hot-path
    def _dispatch_decode(self) -> bool:
        """Dispatch ONE K-step block over the slot batch (device sampling
        or verification, device-chained tokens, no host wait): build the
        batch state, choose the StepPlan (_select_plan: a verify block on
        a speculative engine unless a sampled request is live, else a
        plain decode block, with a prefill rider when one can ride) and
        lower it through engine_model.plan_step (_exec_plan)."""
        B = len(self.slots)
        spec_mode = self._spec_k > 0 and not self._sampled_live()
        # Per step: r tokens may commit (the budget and bookkeeping
        # reserve), r_nodes k/v rows are written (tree verify writes one
        # per packed node, accepted or not). Both 1 for a plain block.
        r = self._spec_r if spec_mode else 1
        r_nodes = self._spec_tree_nodes if spec_mode else 1
        K = max(1, self.ecfg.decode_steps_per_dispatch)
        lengths = np.ones((B,), np.int32)
        tables = np.zeros((B, self.max_pages), np.int32)
        temps = np.zeros((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        active_mask = np.zeros((B,), bool)
        live: List[int] = []
        for i, s in enumerate(self.slots):
            if s is None or s.prefilling:
                continue
            if s.req.cancelled:
                self._finish(i, "cancelled")
                continue
            if self._advance_capacity(s, self._slot_used(s))[0] < r_nodes:
                self._starve(i)
                continue
            if s.req.max_new_tokens - s.scheduled <= 0:
                continue  # everything asked for is emitted or in flight
            live.append(i)
        if not live:
            return False
        if len(live) * 4 <= B:
            # Low occupancy: short blocks keep the device queue shallow
            # so an arrival's prefill never waits behind K steps.
            K = min(K, 2)
        if self._long_prefills and self.ecfg.prefill_decode_k_cap > 0:
            # Chunked-prefill priority lane: short decode blocks keep the
            # device queue shallow so prefill chunks interleave at a fine
            # grain.
            K = min(K, self.ecfg.prefill_decode_k_cap)
        # Page capacity is a hard cap (steps past it would write out of
        # bounds): round down. The token budget is soft (steps past the
        # last requested token are dropped at emission): round up, to the
        # nearest warmed K on a warmed engine, as the JAX engine does.
        cap_min = min(self._advance_capacity(
            self.slots[i], self._slot_used(self.slots[i]))[0] for i in live)
        max_rem = max(self.slots[i].req.max_new_tokens
                      - self.slots[i].scheduled for i in live)
        K = self._pick_k(min(K, max(1, (cap_min - (r_nodes - r)) // r)))
        if max_rem < K:
            if self._warm_ks:
                fits = sorted(k for k in self._warm_ks if max_rem <= k <= K)
                K = fits[0] if fits else K
            else:
                # The smallest power of two that finishes every live slot
                # in this block (overshoot is discarded on the host).
                K = min(K, 1 << (max_rem - 1).bit_length())
        K = _pow2_floor(K)
        worst = K * r                    # commit / token-budget bound
        alloc = (K - 1) * r + r_nodes    # page-write bound
        # ensure() moves seq.length, so take each base once: a shrink
        # pass re-ensures from the same starting point.
        base_lens = {i: self._slot_used(self.slots[i]) for i in live}
        while True:
            shrink_to = None
            active: List[int] = []
            metas: List = []
            active_mask[:] = False
            for i in live:
                s = self.slots[i]
                if s is None:
                    continue
                base = base_lens[i]
                try:
                    s.seq.ensure(base + alloc)
                except MemoryError:
                    # The pool cannot cover K steps: shrink K to what this
                    # slot's pages plus the free pages hold; starve only
                    # when not even one step fits.
                    _, avail = self._advance_capacity(s, base)
                    if avail >= r_nodes and K > 1:
                        shrink_to = max(1, (avail - (r_nodes - r)) // r)
                        break
                    if avail < r_nodes:
                        self._starve(i)
                    continue
                active.append(i)
                active_mask[i] = True
                s.no_capacity = False
                tables[i] = s.seq.table_row()
                if spec_mode:
                    metas.append((i, s, base))
                else:
                    lengths[i] = base + 1  # incl. the incoming token
                    temps[i] = s.req.temperature
                    top_ps[i] = s.req.top_p
                    top_ks[i] = s.req.top_k
            if shrink_to is None:
                break
            K = self._pick_k(shrink_to)
            worst = K * r
            alloc = (K - 1) * r + r_nodes
        if not active:
            return False
        # The sampled fallback always takes the general-sampling variant
        # (the only one warmup warms for it, as in the JAX engine): the
        # sampled slot that demoted this dispatch may have dropped out of
        # `active`. Greedy rows still take the exact argmax in sample().
        fallback = bool(self._spec_k) and not spec_mode
        flags = _sampling_flags(not fallback and all(
            temps[i] <= 0.0 for i in active))
        plan, lp = self._select_plan(K, spec_mode)
        arrays = {"tables": tables, "active_mask": active_mask}
        if not spec_mode:
            arrays.update(lengths=lengths, temps=temps, top_ps=top_ps,
                          top_ks=top_ks, flags=np.asarray(flags))
        n_part = min(plan.rider_width, len(lp.ids) - lp.pos) if lp else 0
        res = self._exec_plan(self._plan_record(plan, lp, n_part, **arrays))
        if lp is not None:
            self._rider_bookkeeping(lp, n_part)
        self.metrics.decode_steps += K
        self.metrics.busy_slots_acc += len(active) * K
        if spec_mode:
            for i in active:
                s = self.slots[i]
                s.awaiting_first = False
                s.scheduled += worst
                s.kv_worst += worst
            self._inflight.append(_InFlight(
                torch.cat([res["targets"], res["counts"][..., None]],
                          dim=-1), metas, K, plan, res["t_dispatch"],
                spec_worst=worst))
            return True
        if plan.spec_state:
            self.metrics.spec_fallback_steps += 1
        for i in active:
            s = self.slots[i]
            metas.append((i, s, 0 if s.awaiting_first else 1))
            s.awaiting_first = False
            s.scheduled += K
            if plan.spec_state:
                # kv_len moves only at landing: reserve this block's K
                # writes so a sibling dispatch ensures pages past them.
                s.kv_worst += K
        self._inflight.append(_InFlight(res["block"], metas, K, plan,
                                        res["t_dispatch"]))
        return True

    # graftlint: hot-path
    def _rider_candidate(self) -> Optional[_LongPrefill]:
        """The in-progress long prefill whose next chunk can ride the
        next decode dispatch (a rider width, prompt tokens left, a
        scratch cache at least as wide as the rider), or None."""
        if not self._fused_width:
            return None
        self._qos_refresh_preemption()
        for lp in self._long_prefills:
            if (self.slots[lp.slot_idx] is lp.slot and not lp.req.cancelled
                    and not lp.paused and lp.pos < len(lp.ids)
                    and lp.s_total >= self._fused_width):
                return lp
        return None

    # graftlint: hot-path
    def _select_plan(self, K: int, spec_mode: bool):
        """The StepPlan of this decode dispatch: K steps; the verify
        width on a speculative engine unless a live sampled request
        forced the plain fallback (spec_state); a prefill rider when a
        candidate can ride, beside the verify width too (a speculative
        engine has a rider width only with step_plans). The fallback plan
        never carries a rider. A rider always has the full rider width,
        as in the JAX engine: where a prefix hit's suffix leaves fewer
        rows before the scratch's end, the padding rows past it land in
        the scratch's sink row. Returns (plan, rider _LongPrefill or
        None)."""
        spec_k = self._spec_k if spec_mode else 0
        spec_state = bool(self._spec_k) and not spec_mode
        lp = None if spec_state else self._rider_candidate()
        if lp is not None and self._warm_ks and (lp.s_total, K) not in (
                self._warm_spec_fused if spec_k else self._warm_fused):
            # A warmed engine carries a rider only at a warmed (S_total,
            # K); the lane carries this beat's chunk.
            lp = None
        return engine_model.StepPlan(
            decode_k=K, spec_k=spec_k,
            tree_branches=self._tree_branches if spec_k else 0,
            rider_width=self._fused_width if lp else 0,
            rider_s_total=lp.s_total if lp else 0,
            spec_state=spec_state), lp

    # graftlint: hot-path
    def _fuse_ready(self, lp: _LongPrefill) -> bool:
        """True when the next decode dispatch will carry lp's next chunk
        as a rider: lp is the rider candidate and at least one slot will
        dispatch (else deferring would stall the prefill behind traffic
        that never launches a block). On a warmed engine only a scratch
        length warmed with some K may ride: a warmup without
        long_prompts warms no rider, so the lane carries every chunk, as
        in the JAX engine."""
        warm = self._warm_spec_fused if self._spec_k else self._warm_fused
        if self._warm_ks and not any((lp.s_total, k) in warm
                                     for k in self._warm_ks):
            return False
        if self._spec_k and self._sampled_live():
            # The sampled fallback plan carries no rider; the lane feeds
            # the prompt while it runs.
            return False
        return self._rider_candidate() is lp and any(
            s is not None and not s.prefilling and not s.req.cancelled
            and not s.no_capacity and s.req.max_new_tokens - s.scheduled > 0
            for s in self.slots)

    # graftlint: hot-path
    def _rider_bookkeeping(self, lp: _LongPrefill, n_part: int) -> None:
        """After a rider plan ran: advance the prefill's cursor, meter its
        tokens (real ones, not the rider's padding), mark this beat's
        chunk as sent, and commit the prefill once its prompt is fed."""
        lp.pos += n_part
        lp.beat = self._beat  # the rider consumed this beat's chunk
        self.metrics.fused_steps += 1
        self.metrics.fused_prefill_tokens += n_part
        self.metrics.prefill_tokens += n_part
        if self.flight.enabled:
            self.flight.record_event(EV_PREFILL_CHUNK, time.perf_counter(),
                                     rid=lp.req.request_id,
                                     tier=tier_id(lp.tier), a=float(n_part),
                                     b=1.0)  # b = 1: a fused rider
        if lp.pos >= len(lp.ids):
            self._long_prefills.remove(lp)
            self._finish_long_prefill(lp)

    # graftlint: hot-path
    def _note_prefill_stalls(self) -> None:
        """One landed decode block is one beat: a chunked prefill that fed
        no prompt token over it counts one prefill_stall_beats."""
        for lp in self._long_prefills:
            if lp.stall_pos == lp.pos:
                self.metrics.prefill_stall_beats += 1
            lp.stall_pos = lp.pos

    def _advance_capacity(self, slot: _Slot, used: int):
        """(table_cap, avail): tokens the slot can still store against its
        page-table limit, and against its pages plus the free pages."""
        ps = self.pool.page_size
        table_cap = self.max_pages * ps - used
        in_page = len(slot.seq.pages) * ps - used
        return table_cap, in_page + self.allocator.n_free * ps

    def _starve(self, slot_idx: int) -> None:
        """The slot cannot advance. With blocks still in flight for it,
        defer (they may finish it legitimately); else finish 'length'."""
        slot = self.slots[slot_idx]
        if slot is None:
            return
        if any(s is slot for fl in self._inflight for _, s, _ in fl.metas):
            slot.no_capacity = True
        else:
            self._finish(slot_idx, "length")

    def _reap_starved(self) -> None:
        """Finish slots starved of page capacity that still cannot advance
        once their in-flight blocks drained (a speculative landing refunds
        its reservation, retiring slots free pages). The floor is the
        k/v rows one step writes: every packed node of a tree step."""
        need = self._spec_tree_nodes if self._spec_k else 1
        reclaimable = None  # the tree does not change within this pass
        for i, slot in enumerate(self.slots):
            if slot is None or not slot.no_capacity:
                continue
            if any(s is slot for fl in self._inflight
                   for _, s, _ in fl.metas):
                continue
            table_cap, avail = self._advance_capacity(slot,
                                                      self._slot_used(slot))
            if self.prefix_cache is not None and avail < need:
                # Cold cached pages can back the slot (the allocator's
                # reclaim hook evicts inside alloc).
                if reclaimable is None:
                    reclaimable = self.prefix_cache.reclaimable()
                avail += reclaimable * self.pool.page_size
            if table_cap >= need and avail >= need:
                slot.no_capacity = False
                continue
            self._finish(i, "length")

    def _process_block_host(self, fl: _InFlight, block: np.ndarray) -> None:
        """Emit / finish slots from a landed block ([B, K + 1], or [B, K,
        k + 2] for a speculative one)."""
        if fl.spec_worst:
            self._process_spec_block(fl, block)
            return
        now = time.perf_counter()
        tokens_before = self.metrics.tokens_out
        self._pace_engaged = self._pace_decide(fl.K)
        for i, slot, first_col in fl.metas:
            if self.slots[i] is not slot:
                continue  # retired while this block was in flight
            if first_col == 0:
                if slot.first_emitted:
                    first_col = 1  # the prefill copy already emitted it
                else:
                    slot.first_emitted = True
                    self._note_first(slot, now)
            for j in range(first_col, fl.K + 1):
                self._emit(slot, int(block[i, j]), slot_idx=i)
                if self.slots[i] is not slot:
                    break  # finished mid-block; the rest is overshoot
            if fl.plan.spec_state:
                # A plain block on a speculative engine (the sampled
                # fallback): every step advances, so the reconciled
                # length moves K and the reservation is released.
                slot.kv_len += fl.K
                slot.kv_worst -= fl.K
        self._pace_land(fl)
        self.metrics.record_tokens(self.metrics.tokens_out - tokens_before)

    def _process_spec_block(self, fl: _InFlight, block: np.ndarray) -> None:
        """Emit a landed verify block: for each slot and step, the first
        counts[i, s] targets are committed greedy tokens. Reconciles the
        worst-case page and budget reservations with the acceptance."""
        targets, counts = block[..., :-1], block[..., -1]
        emitted_all = 0
        self._pace_engaged = self._pace_decide(fl.K * self._spec_r)
        for i, slot, _ in fl.metas:
            if self.slots[i] is not slot:
                continue  # retired while in flight
            if not slot.first_emitted:
                # The prefill-sampled first token goes out first.
                self._flush_first_for(slot)
                if self.slots[i] is not slot:
                    continue  # it ended the stream
            emitted = 0
            for step in range(fl.K):
                for j in range(int(counts[i, step])):
                    self._emit(slot, int(targets[i, step, j]), slot_idx=i)
                    emitted += 1
                    if self.slots[i] is not slot:
                        break
                if self.slots[i] is not slot:
                    break
            if self.slots[i] is slot:
                # Refund the unaccepted worst case; kv_len / kv_worst
                # follow the acceptance while still covering any sibling
                # block in flight.
                slot.scheduled -= fl.spec_worst - emitted
                slot.kv_len += emitted
                slot.kv_worst -= fl.spec_worst
            emitted_all += emitted
            self.metrics.spec_slot_steps += fl.K
        self._pace_land(fl)
        self.metrics.spec_committed += emitted_all
        self.metrics.record_tokens(emitted_all)

    def _flush_first_for(self, slot: _Slot) -> None:
        """Emit one slot's pending first token now (waiting for its host
        copy, which began at prefill)."""
        for item in list(self._pending_first):
            copy, metas = item
            if any(s is slot for _, s in metas):
                self._pending_first.remove(item)
                self._emit_first_values(copy.numpy().reshape(-1), metas)
                return

    def _emit_first_values(self, vals: np.ndarray, metas) -> None:
        now = time.perf_counter()
        for j, (slot_idx, slot) in enumerate(metas):
            if self.slots[slot_idx] is not slot or slot.first_emitted:
                continue
            slot.first_emitted = True
            self._note_first(slot, now)
            self._emit(slot, int(vals[j]), slot_idx=slot_idx)
            self.metrics.record_tokens(1)

    def _note_first(self, slot: _Slot, landed: float) -> None:
        """The slot's first token goes out now: record its TTFT (the
        metric, the recorder's first-token event and the span's
        first_token event). The clock is read here, per slot, so the
        TTFT and the event both hold the instant the token is emitted,
        which trails the block's landing (`landed`) by the host time the
        block's earlier slots took (up to 3.6 ms at batch 128 on an
        H100). The event's `b` keeps that delay (ms). JAX measures the
        TTFT at the landing and stamps the event at its record."""
        now = time.perf_counter()
        ttft_ms = (now - slot.req.submit_time) * 1e3
        self.metrics.record_ttft(ttft_ms)
        if self.flight.enabled:
            self.flight.record_event(EV_FIRST_TOKEN, now,
                                     rid=slot.req.request_id,
                                     tier=tier_id(slot.req), a=ttft_ms,
                                     b=(now - landed) * 1e3)
        if slot.span is not None:
            slot.span.add_event("first_token",
                                {"ttft_ms": round(ttft_ms, 2)})

    def _emit(self, slot: _Slot, tok: int, slot_idx: int) -> None:
        self.metrics.tokens_out += 1
        slot.generated += 1
        eos_ids = getattr(self.tokenizer, "eos_ids", None) or \
            {getattr(self.tokenizer, "eos_id", None)}
        eos = tok in eos_ids or tok in slot.req.stop_ids
        text = "" if eos else slot.detok.push(tok)
        done = slot.generated >= slot.req.max_new_tokens
        reason = "stop" if eos else "length" if done else None
        self._stream_put(slot, {"text": text, "token_id": tok,
                                "finished": eos or done,
                                "finish_reason": reason})
        if eos or done:
            self._finish(slot_idx, reason, emit=False)

    # -- emission pacer --------------------------------------------------

    def _pace_decide(self, burst: int) -> bool:
        """Pace only interactive regimes: multi-token bursts with at most
        pace_emission_max_streams live decode streams. Read every block,
        so the limit can change while the engine runs; never without the
        pacer thread (start() runs it only for a limit above 0)."""
        lim = self.ecfg.pace_emission_max_streams
        if lim <= 0 or burst <= 1 or self._pace_thread is None:
            return False
        live = sum(1 for s in self.slots
                   if s is not None and not s.prefilling)
        return 0 < live <= lim

    def _stream_put(self, slot: _Slot, ev: Dict[str, Any]) -> None:
        """Deliver a stream event, holding non-terminal tokens back for
        the pacer while a block is emitted with pacing engaged. Anything
        the pacer still holds for the slot goes out first, so order is
        kept and a terminal event is never delayed. A slot's first token
        (generated == 1) is never held: it is the TTFT."""
        if self._pace_engaged and not ev["finished"] and slot.generated > 1:
            slot.pace_buf.append(ev)
            return
        # Only the scheduler thread fills either container, so this check
        # is race-free; unpaced traffic takes no lock.
        if slot.pace_buf or self._pace_entries:
            self._pace_flush(slot)
        slot.req.stream.put(ev)

    def _pace_flush(self, slot: _Slot) -> None:
        """Deliver at once everything held for this slot: the pacer's
        entry (the older block) first, then the current buffer."""
        with self._pace_lock:
            entry = self._pace_entries.pop(id(slot), None)
        if entry is not None:
            for ev in entry["buf"]:
                slot.req.stream.put(ev)
        for ev in slot.pace_buf:
            slot.req.stream.put(ev)
        slot.pace_buf = []

    def _pace_land(self, fl: _InFlight) -> None:
        """End of a landed block's emission: commit each live slot's
        held burst to the pacer (or, unpaced, note the landing time)."""
        paced, self._pace_engaged = self._pace_engaged, False
        end = time.perf_counter()
        for i, slot, _ in fl.metas:
            if self.slots[i] is slot:
                if paced:
                    self._pace_commit(slot, end)
                else:
                    slot.pace_last_land = end

    def _pace_commit(self, slot: _Slot, now: float) -> None:
        """Hand this slot's held burst to the pacer, spaced over the
        observed block interval (at most 100 ms a token). The slot's
        previous entry, if the pacer has not finished it, is flushed
        first on both paths, so the pacer is never more than one block
        behind and a burst never overtakes the one before it."""
        if not slot.pace_buf:
            slot.pace_last_land = now
            return
        n = len(slot.pace_buf)
        interval = (now - slot.pace_last_land) if slot.pace_last_land else 0.0
        slot.pace_last_land = now
        spacing = min(interval / n, 0.1)
        if spacing < 0.004:
            # The first block, or blocks landing fast enough that bursts
            # are already smooth: deliver now, after any pending entry.
            self._pace_flush(slot)
            return
        with self._pace_lock:
            prev = self._pace_entries.pop(id(slot), None)
            if prev is not None:
                for ev in prev["buf"]:
                    slot.req.stream.put(ev)
            self._pace_entries[id(slot)] = {
                "slot": slot, "buf": deque(slot.pace_buf),
                "next_t": now + spacing, "spacing": spacing}
        slot.pace_buf = []
        self._pace_wake.set()

    def _pacer_loop(self) -> None:
        """Deliver paced token events at their times; sleeps on an event
        while nothing is scheduled, so unpaced traffic costs nothing."""
        while self._running:
            timeout = None
            with self._pace_lock:
                if self._pace_entries:
                    now = time.perf_counter()
                    nxt = None
                    for key in list(self._pace_entries):
                        entry = self._pace_entries[key]
                        while entry["buf"] and entry["next_t"] <= now:
                            entry["slot"].req.stream.put(
                                entry["buf"].popleft())
                            entry["next_t"] += entry["spacing"]
                        if not entry["buf"]:
                            del self._pace_entries[key]
                        elif nxt is None or entry["next_t"] < nxt:
                            nxt = entry["next_t"]
                    if nxt is not None:
                        timeout = max(0.001, nxt - now)
            self._pace_wake.wait(timeout=timeout)
            self._pace_wake.clear()

    # -- flight-recorder lifecycle hooks (scheduler thread only) ---------

    # graftlint: hot-path
    def _flight_note_pop(self, req: GenRequest) -> None:
        """Record the request's submit, retroactively (stamped with its
        submit_time: server threads never write the ring), once, and
        under QoS the weighted-fair pick that chose it."""
        if not self.flight.enabled:
            return
        tier = tier_id(req)
        if not req.flight_seen:
            req.flight_seen = True
            if not req.request_id:
                # Engine-direct callers have no server-issued id; one is
                # made so their events still correlate into spans.
                req.request_id = \
                    f"req-{self.flight.stats()['flight_events']}"
            self.flight.record_event(EV_SUBMIT, req.submit_time,
                                     rid=req.request_id, tier=tier,
                                     a=float(len(req.prompt_ids)))
        if self.qos is not None:
            self.flight.record_event(EV_QOS_PICK, time.perf_counter(),
                                     rid=req.request_id, tier=tier)

    # graftlint: hot-path
    def _flight_admit(self, req: GenRequest, slot_idx: int) -> None:
        """Slot reserved: the queue-wait histogram (always live) and the
        admit event."""
        now = time.perf_counter()
        wait_ms = max(0.0, (now - req.submit_time) * 1e3)
        tier = request_tier(req)
        self.metrics.hists["queue_wait_ms_" + tier].observe(wait_ms)
        if self.flight.enabled:
            self.flight.record_event(EV_ADMIT, now, rid=req.request_id,
                                     tier=tier_id(tier), slot=slot_idx,
                                     a=wait_ms)

    # graftlint: hot-path
    def _flight_retire(self, slot: _Slot, reason: str) -> None:
        """Slot retired: the e2e histogram and the retire event (reason
        code, tokens, e2e ms and the span's trace id)."""
        now = time.perf_counter()
        e2e_ms = max(0.0, (now - slot.req.submit_time) * 1e3)
        self.metrics.hists["e2e_ms"].observe(e2e_ms)
        if self.flight.enabled:
            self.flight.record_event(
                EV_RETIRE, now, rid=slot.req.request_id,
                tier=tier_id(slot.req),
                code=RETIRE_CODES.get(reason, -1), a=float(slot.generated),
                b=e2e_ms, aux=tracing.span_trace_id(slot.span))

    def _release_seq(self, seq: SequencePages) -> None:
        """Free a retired sequence's pages once the newest in-flight block
        (which may still write them for the retired slot) has landed."""
        if self._inflight:
            self._inflight[-1].releases.append(seq)
        else:
            seq.release()

    def _finish(self, slot_idx: int, reason: str, emit: bool = True) -> None:
        slot = self.slots[slot_idx]
        if slot is None:
            return
        self._flight_retire(slot, reason)
        self._pace_flush(slot)
        if emit:
            slot.req.stream.put({"text": "", "token_id": -1,
                                 "finished": True, "finish_reason": reason})
        self._release_seq(slot.seq)
        self.slots[slot_idx] = None
        self._mark_done(slot)
        self._wake.set()

    def _mark_done(self, slot: _Slot) -> None:
        """Close a retired slot's span: tokens generated and the device
        memory counters. The counters come from the caching allocator's
        host-side bookkeeping and the device properties (no device sync
        on the scheduler thread), sampled every MEMSTATS_SAMPLE_EVERY
        retirements."""
        if slot.span is None:
            return
        slot.span.set_attribute("tokens_generated", slot.generated)
        if tracing.is_enabled() and self.device.type == "cuda":
            self._memstats_tick += 1
            if self._memstats_cache is None or \
                    self._memstats_tick % MEMSTATS_SAMPLE_EVERY == 1:
                try:
                    st = torch.cuda.memory_stats(self.device)
                    self._memstats_cache = {
                        "bytes_in_use": st.get("allocated_bytes.all.current",
                                               0),
                        "peak_bytes_in_use": st.get(
                            "allocated_bytes.all.peak", 0),
                        "bytes_limit": torch.cuda.get_device_properties(
                            self.device).total_memory}
                except RuntimeError:
                    self._memstats_cache = {}
                    _LOG.debug("device memory stats unavailable for span",
                               exc_info=True)
            for key, value in self._memstats_cache.items():
                slot.span.set_attribute(f"device.{key}", value)
        slot.span.end()
