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

Chunked prefill (the JAX engine's plain lane): a long prompt's chunks
run through a contiguous scratch KVCache with offset queries; the chunk
that completes the prompt samples the first token inside the same
dispatch, and ONE scatter moves the cache into the sequence's pages.

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
the same device state (`decode_plain_spec_state_multi_step`). As in the
JAX engine with `step_plans` off, the spec programs are called
directly.

Not ported yet, and refused at construction (see config/schema.py):
step plans, the fused prefill rider, prefix cache, pager, QoS,
multi-host, emission pacing and the flight recorder.
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
from generativeaiexamples_tpu_torch.ops.quant import is_quantized
from generativeaiexamples_tpu_torch.serving import engine_model
from generativeaiexamples_tpu_torch.serving.kv_cache import (
    PageAllocator, PagePool, SequencePages)
from generativeaiexamples_tpu_torch.utils.tokenizer import StreamDetokenizer

_LOG = logging.getLogger(__name__)

# Failed admissions (page exhaustion) a request may retry while nothing
# in flight could free pages, before it is failed with an error event.
MAX_ADMISSION_RETRIES = 64

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


def _pow2_floor(n: int) -> int:
    """Largest power of two <= max(n, 1): decode block lengths."""
    return 1 << (max(n, 1).bit_length() - 1)


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
    admission_attempts: int = 0
    cancelled: bool = False  # set by the server on disconnect / stop string
    truncate_prompt: bool = False  # opt-in: keep the tail instead of refusing


class _Slot:
    def __init__(self, req: GenRequest, seq: SequencePages, detok):
        self.req = req
        self.seq = seq
        self.detok = detok
        self.generated = 0
        # Tokens DISPATCHED (prefill token + K per decode block joined),
        # in flight included: caps K so no block runs past max_new_tokens.
        self.scheduled = 1
        self.prompt_len = len(req.prompt_ids)
        self.awaiting_first = True   # until the slot joins a decode block
        self.first_emitted = False   # first token reached the stream
        self.no_capacity = False     # starved; finished after the drain
        self.prefilling = False      # placeholder of a chunked prefill
        # Speculative engines: tokens whose KV is known stored (moved at
        # landing) and the worst-case tokens of blocks still in flight;
        # pages must cover kv_len + kv_worst.
        self.kv_len = self.prompt_len
        self.kv_worst = 0


class _LongPrefill:
    """In-progress chunked prefill for one long prompt. While other
    streams are decoding, the scheduler advances it at most
    prefill_chunks_per_block chunks per LANDED decode block (the `beat`
    counter), so chunk dispatches interleave with decode blocks on the
    device queue; with no live decode traffic chunks run at full
    dispatch speed. The scratch cache lives in
    engine._scratch_caches[slot_idx] from the first chunk on."""

    __slots__ = ("req", "slot_idx", "seq", "ids", "s_total", "pos", "slot",
                 "beat", "chunk")

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
                 "plain_spec")

    def __init__(self, block: torch.Tensor, metas, K: int,
                 spec_worst: int = 0, plain_spec: bool = False):
        # Plain blocks: [B, K + 1] tokens. Speculative blocks: [B, K,
        # k + 2], the targets of each step with its count appended.
        self.copy = HostCopy(block)
        self.metas = metas             # [(slot_idx, slot, first_col | base)]
        self.K = K
        # > 0 marks a speculative block: the worst-case tokens per slot
        # (K * (k + 1)), refunded down to the accepted ones at landing.
        self.spec_worst = spec_worst
        # A plain block on a speculative engine (the sampled fallback):
        # landing advances each slot's kv_len by exactly K.
        self.plain_spec = plain_spec
        self.releases: List[SequencePages] = []  # freed once this lands


class EngineMetrics:
    """Serving metrics: TTFT, tokens/s, batch occupancy, kernel launches.
    Written by the scheduler thread; read by scrapes."""

    RATE_WINDOW_S = 30.0
    TTFT_SAMPLES = 4096

    def __init__(self):
        self.tokens_out = 0
        self.decode_steps = 0
        self.busy_slots_acc = 0
        self.prefill_tokens = 0
        self.fused_sample_dispatches = 0
        self.admission_failures = 0
        self.stuck_thread_joins = 0
        # Speculation: committed tokens over slot-steps (the tokens-per-
        # step gauge: 1.0 = no draft accepted, k + 1 = all), and plain
        # fallback dispatches while a sampled request was live.
        self.spec_committed = 0
        self.spec_slot_steps = 0
        self.spec_fallback_steps = 0
        self._ttft: deque = deque(maxlen=self.TTFT_SAMPLES)
        self._token_events: deque = deque(maxlen=8192)
        self._lock = threading.Lock()

    def record_ttft(self, ms: float) -> None:
        with self._lock:
            self._ttft.append(ms)

    @property
    def last_ttft_ms(self) -> Optional[float]:
        """The most recent request's time to first token (None before
        any)."""
        with self._lock:
            return self._ttft[-1] if self._ttft else None

    def record_tokens(self, n: int) -> None:
        if n > 0:
            with self._lock:
                self._token_events.append((time.perf_counter(), n))

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
        with self._lock:
            ttft = sorted(self._ttft)

        def pct(p):
            return ttft[min(len(ttft) - 1, int(p * len(ttft)))] if ttft \
                else None

        out = {
            "ttft_p50_ms": pct(0.50), "ttft_p95_ms": pct(0.95),
            "tokens_generated": self.tokens_out,
            "decode_steps": self.decode_steps,
            "mean_batch_occupancy": (self.busy_slots_acc / self.decode_steps
                                     if self.decode_steps else 0.0),
            "tokens_per_sec": self.tokens_per_sec(),
            "prefill_tokens": self.prefill_tokens,
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
        }
        out.update({f"kernel_launches_{k}": n
                    for k, n in kernels.LAUNCHES.items()})
        return out


class LLMEngine:
    """Single-device engine. `params` must already live on `device`
    (CUDA unless the caller passes device="cpu")."""

    def __init__(self, params, cfg: LlamaConfig, tokenizer,
                 engine_cfg: Any = None, n_pages: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if params["tok_emb"].device.type != self.device.type:
            raise ValueError(f"params on {params['tok_emb'].device}, engine "
                             f"on {self.device}")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.ecfg = EngineConfig.coerce(engine_cfg)
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
        self.slots: List[Optional[_Slot]] = [None] * self.ecfg.max_batch_size
        self.waiting: deque = deque()
        self.metrics = EngineMetrics()
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
        self._scratch_caches: Dict[int, KVCache] = {}
        self._chunk_res: Dict[int, torch.Tensor] = {}  # slot -> tok0 [1]
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

    # -- lifecycle ---------------------------------------------------------

    def warmup(self, buckets=None, group_sizes=None) -> "LLMEngine":
        """Run every prefill (bucket, group) shape and one decode step
        before serving, all against the page-0 sink, so the first live
        burst does not pay first-call costs (kernel builds, cuBLAS
        heuristics, allocator growth). Eager decode launches the same
        shapes at every K, so one step covers every block length. Call
        before start()."""
        if self._running:
            raise RuntimeError("warmup() must run before start()")
        ps = self.pool.page_size
        if group_sizes is None:
            group_sizes, n = [], 1
            bound = min(self.ecfg.max_batch_size, self._prefill_cap)
            while n < bound:
                group_sizes.append(n)
                n *= 2
            group_sizes.append(n)
        for bucket in (buckets or self.buckets):
            for n in group_sizes:
                toks = engine_model.prefill_batch_step(
                    self.params, self.cfg, self.pool,
                    self._put(np.zeros((n, bucket), np.int32)),
                    self._put(np.ones((n,), np.int32)),
                    self._put(np.zeros((n, bucket // ps), np.int32)),
                    self._put(np.zeros((n,), np.float32)),
                    self._put(np.ones((n,), np.float32)),
                    self._put(np.zeros((n,), np.int32)),
                    self._generator, sampling_flags=(True, False, False))
                engine_model.set_last_tokens(
                    self._last_tokens, np.full((n,), len(self.slots)), toks)
        B = self.ecfg.max_batch_size
        tables = self._put(np.zeros((B, self.max_pages), np.int32))
        inactive = self._put(np.zeros((B,), bool))
        sampling = (self._put(np.zeros((B,), np.float32)),
                    self._put(np.ones((B,), np.float32)),
                    self._put(np.zeros((B,), np.int32)), self._generator)
        if self._spec_k:
            # A verify step and the sampled fallback's plain step over
            # inactive rows (sink page 0); the device state is unchanged.
            (_, _, self._last_tokens, self._dev_lengths,
             self._history) = engine_model.decode_spec_multi_step(
                self.params, self.cfg, self.pool, self._history,
                self._last_tokens, self._dev_lengths, tables, inactive, 1,
                self._spec_k, self._tree_branches)
            (_, self._last_tokens, self._dev_lengths, self._history) = \
                engine_model.decode_plain_spec_state_multi_step(
                    self.params, self.cfg, self.pool, self._history,
                    self._last_tokens, self._dev_lengths, tables, inactive,
                    *sampling, 1)
        else:
            _, self._last_tokens = engine_model.decode_multi_step(
                self.params, self.cfg, self.pool, self._last_tokens, tables,
                self._put(np.ones((B,), np.int32)), inactive, *sampling, 1,
                sampling_flags=(True, False, False))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def start(self) -> "LLMEngine":
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)
            if t.is_alive():
                _LOG.warning("engine stop: scheduler thread still alive "
                             "after the join timeout")
                self.metrics.stuck_thread_joins += 1

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

    # -- scheduler ---------------------------------------------------------

    def _put(self, x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x)).to(self.device)

    @property
    def _prefill_cap(self) -> int:
        cap = self.ecfg.max_prefill_group
        return cap if cap > 0 else self.ecfg.max_batch_size

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

    def _land_next_block(self) -> None:
        """Land the oldest in-flight block: wait for it, emit / retire,
        release the pages parked on it."""
        fl = self._inflight.popleft()
        try:
            self._process_block_host(fl, self._fetch_block_host(fl))
        except Exception:
            _LOG.exception("decode block failed; failing batch")
            self._fail_active()
        finally:
            for seq in fl.releases:
                seq.release()
            fl.releases = []
        self._reap_starved()
        self._beat += 1

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
                req = self.waiting.popleft()
            ids = req.prompt_ids or [0]
            long = len(ids) > self.buckets[-1]
            if long and len(self._long_prefills) >= self._max_long_prefills:
                # One scratch cache at a time: the next long prompt waits
                # (at the head of the queue) for the lane.
                deferred_long.append(req)
                continue
            seq = SequencePages(self.allocator, self.pool.page_size,
                                self.max_pages)
            try:
                seq.ensure(len(ids))
            except MemoryError as e:
                seq.release()
                self.metrics.admission_failures += 1
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
                break
            # Reserve the slot; the real _Slot replaces it at dispatch.
            placeholder = _Slot(req, seq, None)
            self.slots[slot_idx] = placeholder
            if long:
                self._begin_long_prefill(req, slot_idx, seq, ids,
                                         placeholder)
                continue
            groups.setdefault(self._bucket_for(len(ids)), []).append(
                (req, slot_idx, seq, ids))
        if deferred_long:
            with self._lock:
                self.waiting.extendleft(reversed(deferred_long))
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
        scratch KVCache (created with the first chunk) in
        _advance_long_prefills; _finish_long_prefill scatters it into the
        sequence's pages."""
        chunk = self.buckets[-1]
        s_total = -(-len(ids) // chunk) * chunk
        placeholder.prefilling = True
        self._long_prefills.append(
            _LongPrefill(req, slot_idx, seq, ids, s_total, placeholder,
                         chunk))

    def _advance_long_prefills(self) -> bool:
        """Dispatch the next chunk(s) of each in-progress long prefill
        (paced by the landed-block beat while decode traffic is live);
        finish those whose prompt is fully fed. The chunk that completes
        a prompt samples its first token in the same dispatch. Returns
        True if any advanced."""
        did = False
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
        """Dispatch the next chunk of `lp`; True when it completed the
        prompt (its first token is then in _chunk_res and last_tokens)."""
        part = lp.ids[lp.pos:lp.pos + lp.chunk]
        width = self._pick_chunk_width(len(part), lp.chunk)
        tok = np.zeros((1, width), np.int32)
        tok[0, :len(part)] = part
        if lp.pos == 0:
            self._scratch_caches[lp.slot_idx] = KVCache.zeros(
                self.cfg, 1, max_len=lp.s_total, dtype=self._scratch_dtype,
                device=self.device)
        cache = self._scratch_caches[lp.slot_idx]
        final = lp.pos + len(part) >= len(lp.ids)
        if final:
            req = lp.req
            flags = ((True, False, False) if req.temperature <= 0.0
                     else (False, True, True))
            tok0, self._last_tokens, cache = \
                engine_model.prefill_chunk_sample_step(
                    self.params, self.cfg, cache, self._put(tok), len(part),
                    self._last_tokens, lp.slot_idx, req.temperature,
                    req.top_p, req.top_k, self._generator,
                    sampling_flags=flags)
            self._chunk_res[lp.slot_idx] = tok0
            self.metrics.fused_sample_dispatches += 1
        else:
            _, cache = engine_model.prefill_chunk_step(
                self.params, self.cfg, cache, self._put(tok), len(part))
        self._scratch_caches[lp.slot_idx] = cache
        lp.pos += len(part)
        self.metrics.prefill_tokens += len(part)
        return final

    @staticmethod
    def _pick_chunk_width(n: int, chunk: int) -> int:
        """Dispatch width for a chunk of n valid tokens: the smallest
        power of two >= n, capped at the full chunk (eager torch has no
        compiled-variant set to restrict it to)."""
        w = 1
        while w < n:
            w *= 2
        return min(w, chunk)

    def _drop_scratch(self, slot_idx: int) -> None:
        """Free the scratch cache of a long prefill that ended without a
        finish (cancel, slot failure)."""
        self._scratch_caches.pop(slot_idx, None)
        self._chunk_res.pop(slot_idx, None)

    def _finish_long_prefill(self, lp: _LongPrefill) -> None:
        """Last chunk fed: scatter the scratch cache into the sequence's
        pages (padding rows to the sink), then open the slot for decode;
        the first token sampled by the final chunk reaches the host like
        a bucketed prefill's."""
        ps = self.pool.page_size
        row = np.zeros((lp.s_total // ps,), np.int32)
        row[:len(lp.seq.pages)] = lp.seq.pages
        cache = self._scratch_caches.pop(lp.slot_idx)
        engine_model.cache_to_pool(self.pool, cache, self.cfg,
                                   self._put(row))
        tok0 = self._chunk_res.pop(lp.slot_idx)
        if self._spec_k:
            hist = np.zeros((1, self.ecfg.max_seq_len), np.int32)
            hist[0, :len(lp.ids)] = lp.ids
            engine_model.set_history_rows(
                self._history, self._dev_lengths, [lp.slot_idx],
                self._put(hist), self._put(np.asarray([len(lp.ids)],
                                                      np.int32)), tok0)
        slot = _Slot(lp.req, lp.seq, StreamDetokenizer(self.tokenizer))
        self.slots[lp.slot_idx] = slot
        self._pending_first.append((HostCopy(tok0), [(lp.slot_idx, slot)]))

    def _fail_request(self, req: GenRequest, slot_idx: int,
                      seq: SequencePages) -> None:
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
        all_greedy = bool(all(temps[:n] <= 0.0))
        flags = (True, False, False) if all_greedy else (False, True, True)
        d_tokens, d_lengths = self._put(tokens), self._put(lengths)
        toks = engine_model.prefill_batch_step(
            self.params, self.cfg, self.pool, d_tokens, d_lengths,
            self._put(rows), self._put(temps), self._put(top_ps),
            self._put(top_ks), self._generator, sampling_flags=flags)
        engine_model.set_last_tokens(self._last_tokens, idxs, toks)
        if self._spec_k:
            engine_model.set_history_rows(self._history, self._dev_lengths,
                                          idxs, d_tokens, d_lengths, toks)
        self.metrics.fused_sample_dispatches += 1
        metas = []
        for req, slot_idx, seq, ids in entries:
            slot = _Slot(req, seq, StreamDetokenizer(self.tokenizer))
            self.slots[slot_idx] = slot
            metas.append((slot_idx, slot))
            self.metrics.prefill_tokens += len(ids)
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

    def _dispatch_decode(self) -> bool:
        """Dispatch ONE K-step block over the slot batch (device sampling
        or verification, device-chained tokens, no host wait): a verify
        block on a speculative engine unless a sampled request is live,
        else a plain decode block."""
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
        cap_min = min(self._advance_capacity(
            self.slots[i], self._slot_used(self.slots[i]))[0] for i in live)
        max_rem = max(self.slots[i].req.max_new_tokens
                      - self.slots[i].scheduled for i in live)
        K = _pow2_floor(min(K, max(1, (cap_min - (r_nodes - r)) // r)))
        if max_rem < K:
            # The smallest power of two that finishes every live slot in
            # this block (overshoot is discarded on the host).
            K = min(K, 1 << (max_rem - 1).bit_length())
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
            K = _pow2_floor(shrink_to)
            worst = K * r
            alloc = (K - 1) * r + r_nodes
        if not active:
            return False
        self.metrics.decode_steps += K
        self.metrics.busy_slots_acc += len(active) * K
        if spec_mode:
            targets, counts, self._last_tokens, self._dev_lengths, \
                self._history = engine_model.decode_spec_multi_step(
                    self.params, self.cfg, self.pool, self._history,
                    self._last_tokens, self._dev_lengths, self._put(tables),
                    self._put(active_mask), K, self._spec_k,
                    self._tree_branches)
            for i in active:
                s = self.slots[i]
                s.awaiting_first = False
                s.scheduled += worst
                s.kv_worst += worst
            self._inflight.append(_InFlight(
                torch.cat([targets, counts[..., None]], dim=-1), metas, K,
                spec_worst=worst))
            return True
        all_greedy = bool(all(temps[i] <= 0.0 for i in active))
        flags = (True, False, False) if all_greedy else (False, True, True)
        sampling = (self._put(temps), self._put(top_ps), self._put(top_ks),
                    self._generator)
        if self._spec_k:
            block, self._last_tokens, self._dev_lengths, self._history = \
                engine_model.decode_plain_spec_state_multi_step(
                    self.params, self.cfg, self.pool, self._history,
                    self._last_tokens, self._dev_lengths, self._put(tables),
                    self._put(active_mask), *sampling, K,
                    sampling_flags=flags)
            self.metrics.spec_fallback_steps += 1
        else:
            block, self._last_tokens = engine_model.decode_multi_step(
                self.params, self.cfg, self.pool, self._last_tokens,
                self._put(tables), self._put(lengths),
                self._put(active_mask), *sampling, K, sampling_flags=flags)
        for i in active:
            s = self.slots[i]
            metas.append((i, s, 0 if s.awaiting_first else 1))
            s.awaiting_first = False
            s.scheduled += K
            if self._spec_k:
                # kv_len moves only at landing: reserve this block's K
                # writes so a sibling dispatch ensures pages past them.
                s.kv_worst += K
        self._inflight.append(_InFlight(block, metas, K,
                                        plain_spec=bool(self._spec_k)))
        return True

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
        for i, slot in enumerate(self.slots):
            if slot is None or not slot.no_capacity:
                continue
            if any(s is slot for fl in self._inflight
                   for _, s, _ in fl.metas):
                continue
            table_cap, avail = self._advance_capacity(slot,
                                                      self._slot_used(slot))
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
        for i, slot, first_col in fl.metas:
            if self.slots[i] is not slot:
                continue  # retired while this block was in flight
            if first_col == 0:
                if slot.first_emitted:
                    first_col = 1  # the prefill copy already emitted it
                else:
                    slot.first_emitted = True
                    self.metrics.record_ttft(
                        (now - slot.req.submit_time) * 1e3)
            for j in range(first_col, fl.K + 1):
                self._emit(slot, int(block[i, j]), slot_idx=i)
                if self.slots[i] is not slot:
                    break  # finished mid-block; the rest is overshoot
            if fl.plain_spec:
                # Every step of a plain block advances: the reconciled
                # length moves K and the reservation is released.
                slot.kv_len += fl.K
                slot.kv_worst -= fl.K
        self.metrics.record_tokens(self.metrics.tokens_out - tokens_before)

    def _process_spec_block(self, fl: _InFlight, block: np.ndarray) -> None:
        """Emit a landed verify block: for each slot and step, the first
        counts[i, s] targets are committed greedy tokens. Reconciles the
        worst-case page and budget reservations with the acceptance."""
        targets, counts = block[..., :-1], block[..., -1]
        emitted_all = 0
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
            self.metrics.record_ttft((now - slot.req.submit_time) * 1e3)
            self._emit(slot, int(vals[j]), slot_idx=slot_idx)
            self.metrics.record_tokens(1)

    def _emit(self, slot: _Slot, tok: int, slot_idx: int) -> None:
        self.metrics.tokens_out += 1
        slot.generated += 1
        eos_ids = getattr(self.tokenizer, "eos_ids", None) or \
            {getattr(self.tokenizer, "eos_id", None)}
        eos = tok in eos_ids or tok in slot.req.stop_ids
        text = "" if eos else slot.detok.push(tok)
        done = slot.generated >= slot.req.max_new_tokens
        reason = "stop" if eos else "length" if done else None
        slot.req.stream.put({"text": text, "token_id": tok,
                             "finished": eos or done,
                             "finish_reason": reason})
        if eos or done:
            self._finish(slot_idx, reason, emit=False)

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
        if emit:
            slot.req.stream.put({"text": "", "token_id": -1,
                                 "finished": True, "finish_reason": reason})
        self._release_seq(slot.seq)
        self.slots[slot_idx] = None
        self._wake.set()
