"""Configuration of the port: the engine and the RAG chain.

The port's own copy of the slice of generativeaiexamples_tpu's
config/schema.py that this package honours, with the same names and
defaults:

- `EngineConfig`: the serving engine, with speculation
  (`speculative_k`, `speculative_tree_branches`), the prefix cache and
  KV pager (`prefix_cache`, `kv_pager` and their sizes), the fused
  prefill rider (`fused_prefill`, `fused_token_budget`), step plans
  beside speculation (`step_plans`) and the flight recorder
  (`flight_recorder`, `flight_ring_size`), QoS (`qos`, the tier
  weights, `qos_preempt_prefill`), the emission pacer
  (`pace_emission_max_streams`) and the memory planner
  (`auto_pool_pages`, `hbm_gb_per_device`,
  `planner_headroom_fraction`) and tensor-parallel serving over rank
  processes (`multihost`: rank 0 publishes dispatch records that the
  follower ranks replay, serving/multihost.py). Flags of the JAX engine
  that the port does not have yet would be listed in `UNSUPPORTED` with
  the ROADMAP item that brings them (none is left);
  `EngineConfig.coerce` refuses any of them set away from its default.
  `weights_path` names an HF safetensors snapshot (empty: random weights
  at a named geometry).
- `MeshConfig`: the device mesh (parallel/mesh.py) and the rank
  processes' coordinator, with the JAX `[mesh]` section's fields and
  defaults.
- `FleetConfig`: the serving fleet (serving/fleet.py): local replicas,
  remote replica URLs, the router policy, health probes and
  disaggregated prefill/decode, the autoscaler (`autoscale*`) and the
  chaos harness (`chaos`, `chaos_seed`).
- `AppConfig`: the sections the chain's pipelines, the engine server
  and the playground read (vector_store, llm, text_splitter, embeddings,
  reranker, retriever, vlm, voice, prompts, mesh, engine, serving,
  fleet, tracing: the JAX tree's order).
  `load_config()` reads the YAML or JSON file that
  `APP_CONFIG_FILE` names, overlays `APP_<SECTION>_<FIELD>` environment
  variables (the JAX config wizard's contract) and refuses fields that
  name unported features when they are set away from their defaults
  (`check_supported`), in the file as in the env, and `auto_pool_pages`
  beside more than one engine on a device (`AUTO_POOL_SHARED`: a
  fleet's local replicas, the autoscaler's spawns, or tensor-parallel
  rank processes that share one device).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

_LOG = logging.getLogger(__name__)


@dataclass(frozen=True)
class EngineConfig:
    # HF snapshot directory of the LLM ("" = random-init, the launcher's
    # --model-size geometry).
    weights_path: str = ""
    dtype: str = "bfloat16"       # model weights / activations
    kv_dtype: str = "bfloat16"    # bfloat16 | float32 | int8 (fused pool)
    quantize_weights: str = "none"  # none | int8 (weight-only, per column)
    max_batch_size: int = 8
    max_seq_len: int = 8192
    page_size: int = 128          # tokens per KV page
    prefill_buckets: Tuple[int, ...] = (128, 512, 1024, 2048, 4096)
    # Largest number of admissions batched into one prefill dispatch
    # (0 = max_batch_size).
    max_prefill_group: int = 64
    decode_steps_per_dispatch: int = 8
    # Decode blocks kept in flight ahead of the host's read of the oldest.
    pipeline_depth: int = 2
    # Chunked long-prompt prefill: chunks dispatched per LANDED decode
    # block while other streams decode (idle engines run chunks at full
    # dispatch speed).
    prefill_chunks_per_block: int = 2
    # While a chunked prefill is in progress, cap decode blocks at this
    # many steps, so chunks interleave with decode at a fine grain
    # (0 = no cap).
    prefill_decode_k_cap: int = 2
    # Greedy self-speculation: k n-gram draft tokens per verify step from
    # the device token history, verified in one forward (0 = off).
    # Sampled requests fall back to plain decode on the same engine.
    speculative_k: int = 0
    # Tree verify: this many k-deep draft branches per step, verified as
    # one packed tree (0 or 1 = the linear chain). Inert without
    # speculative_k, as in the JAX engine.
    speculative_tree_branches: int = 0
    # Cross-request prefix KV reuse (serving/prefix_cache.py): a radix
    # tree maps page-granular prompt prefixes to ref-counted pool pages;
    # admissions adopt the longest cached prefix and prefill only the
    # suffix. Off by default: off is the engine without the cache.
    prefix_cache: bool = False
    # Fraction of the page pool the tree may hold (LRU-trimmed beyond it;
    # allocator pressure evicts further: live sequences always win).
    prefix_cache_capacity: float = 0.5
    # Session KV pager (serving/kv_pager.py; requires prefix_cache):
    # eviction demotes cached pages to host RAM and then a disk spill
    # instead of dropping them, and a match promotes them back with one
    # scatter. Off by default.
    kv_pager: bool = False
    # Host-RAM budget of the pager's warm tier in MB (0 = no host tier:
    # demotions go straight to the spill file).
    kv_host_budget_mb: int = 256
    # Directory of the spill file ("" = a temporary directory per
    # engine, removed when the engine stops).
    kv_spill_dir: str = ""
    # Fused prefill rider: while streams decode, the next chunk of an
    # in-progress chunked prefill rides inside the decode dispatch
    # (engine_model.fused_decode_prefill_step) instead of going out as a
    # standalone chunk forward ahead of the decode blocks. The chunked
    # lane carries the chunks when the engine is idle, and on a
    # speculative engine without step_plans (accepted there, never
    # fused). Off by default.
    fused_prefill: bool = False
    # Prompt tokens one rider carries: its width is the largest power of
    # two <= min(fused_token_budget, the largest prefill bucket); 0 turns
    # the rider off.
    fused_token_budget: int = 512
    # The chunk that completes a prompt samples its first token in the
    # same call, and a finish whose last chunk did not sample (a rider,
    # fused_sampling off) samples with sample_token_into. False is the
    # unfused two-call finish (sample_token, then set_last_token), an
    # A/B knob. Bucketed prefill groups always sample in their dispatch.
    fused_sampling: bool = True
    # Composed step plans: on a speculative engine the fused rider rides
    # inside the verify dispatch (engine_model.fused_spec_prefill_step),
    # so speculation and fused_prefill compose. Off: a speculative engine
    # never fuses (the lane carries every chunk), as in the JAX engine.
    step_plans: bool = False
    # Flight recorder (serving/flight.py): one record per landed decode
    # block and per request lifecycle event in preallocated rings,
    # served at /debug/timeline. On by default, as in the JAX engine.
    flight_recorder: bool = True
    # Beat-ring capacity in records (the event ring is 4x this).
    flight_ring_size: int = 4096
    # Emission pacing: a landed K-step block delivers up to K tokens a
    # stream at once; while at most this many streams decode, the pacer
    # spreads each burst over the observed block interval (at most 100 ms
    # a token; a terminal event or the next block flushes it at once).
    # 0 turns pacing off.
    pace_emission_max_streams: int = 16
    # SLO-aware multi-tenant QoS (serving/qos.py): requests carry a tier
    # (latency | standard | batch) and a tenant; admission is weighted-fair
    # across tiers and least-served-tenant within one instead of FIFO, and
    # a latency-tier request in its TTFT phase pauses lower-tier long
    # prefills at the beat boundary. Off by default: off is the FIFO
    # scheduler.
    qos: bool = False
    # Admission-bandwidth weights per tier (floored at 1).
    qos_weight_latency: int = 8
    qos_weight_standard: int = 4
    qos_weight_batch: int = 1
    # With qos on, pause lower-tier long prefills while a latency-tier
    # request is prefilling or awaiting its first token.
    qos_preempt_prefill: bool = True
    # Size the page pool from serving/memory_plan.py instead of the
    # max_batch_size x max_pages worst case: weights, scratch and
    # activation transients and the headroom are counted against the
    # device's memory and every remaining byte becomes KV pages (or the
    # build fails with the breakdown and the smallest mesh that fits).
    auto_pool_pages: bool = False
    # Device memory budget in GiB for the planner (0 = the device's own:
    # total_memory on CUDA, 4 GiB on the CPU).
    hbm_gb_per_device: float = 0.0
    # Share of device memory the planner leaves unallocated (allocator
    # fragmentation, transients beyond its estimate);
    # planner_headroom_bytes in /metrics.
    planner_headroom_fraction: float = 0.1
    # Tensor-parallel serving over rank processes (serving/multihost.py):
    # rank 0 runs the scheduler and the OpenAI surface and publishes a
    # record of each device dispatch before launching it; the follower
    # ranks replay the records through the same executors, so the
    # collectives pair up by launch order. The whole serving profile
    # replays (speculation, step plans, the fused rider, the prefix
    # cache and the KV pager); validate_multihost_profile refuses only a
    # batch-sharded mesh. Off: one process, one device.
    multihost: bool = False

    @staticmethod
    def coerce(cfg: Any = None) -> "EngineConfig":
        """An EngineConfig from None, an EngineConfig, a mapping, or any
        object with the JAX engine config's attributes. Raises ValueError
        naming the ROADMAP item for a flag this port does not support."""
        if cfg is None:
            return EngineConfig()
        if isinstance(cfg, EngineConfig):
            out = cfg
        else:
            get = (cfg.get if isinstance(cfg, Mapping)
                   else lambda k, d=None: getattr(cfg, k, d))
            for name, (default, item) in UNSUPPORTED.items():
                value = get(name, default)
                if value != default:
                    raise ValueError(
                        f"engine.{name}={value!r} is not supported by the "
                        f"PyTorch port yet ({item})")
            known = {f.name for f in dataclasses.fields(EngineConfig)}
            if isinstance(cfg, Mapping):
                unknown = set(cfg) - known - set(UNSUPPORTED)
                if unknown:
                    raise ValueError(f"unknown engine config keys {unknown}")
            kw = {n: get(n) for n in known if get(n) is not None}
            if "prefill_buckets" in kw:
                kw["prefill_buckets"] = tuple(kw["prefill_buckets"])
            out = EngineConfig(**kw)
        if out.kv_dtype not in ("bfloat16", "float32", "int8"):
            raise ValueError(f"engine.kv_dtype={out.kv_dtype!r}: "
                             f"bfloat16, float32 or int8")
        if out.quantize_weights not in ("none", "int8"):
            raise ValueError(f"engine.quantize_weights="
                             f"{out.quantize_weights!r}: none or int8")
        if out.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"engine.dtype={out.dtype!r}: bfloat16 or "
                             f"float32")
        return out


# JAX EngineConfig flags outside this slice: name -> (default, where the
# port will gain it). Empty: every JAX engine flag the port reads is
# honoured (the JAX-only tuning knobs are logged and ignored).
UNSUPPORTED: Dict[str, Tuple[Any, str]] = {}


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (parallel/mesh.py), the JAX `[mesh]` section
    with its fields and defaults. Axis sizes multiply to the device count
    of the mesh; -1 fills an axis with the remaining devices (the default
    puts every device on the tensor axis). The port serves a tensor axis
    over rank processes, one a device: with no coordinator the launcher
    starts the follower ranks itself on this host; with
    `coordinator_address` every process passes the same value and its
    own `process_id` in [0, `num_processes`) (the env variables
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or the
    launcher's --coordinator / --num-processes / --process-id, override
    these fields, as in the JAX package)."""

    ici_data: int = 1
    ici_fsdp: int = 1
    ici_tensor: int = -1
    ici_sequence: int = 1
    ici_expert: int = 1
    dcn_data: int = 1
    dcn_pipeline: int = 1
    coordinator_address: str = ""  # "host:port" of process 0
    num_processes: int = 0  # 0 = single process
    process_id: int = -1  # -1 = single process


# -- the chain's sections ------------------------------------------------


@dataclass(frozen=True)
class VectorStoreConfig:
    # memory | tpu | native (the device store) | milvus | pgvector (an
    # external server at `url`)
    name: str = "memory"
    url: str = ""
    nlist: int = 64  # IVF partitions
    nprobe: int = 16  # IVF partitions probed a search
    # flat = exact MIPS; ivf = the device's clustered ANN index
    # (ops/ivf.py). Honoured by the device store (tpu / native).
    index_type: str = "flat"
    # Store IVF rows as int8 + per-row scales (1/4 of the f32 bytes).
    quantize_int8: bool = False
    # Tiered demand-paged IVF (ops/tiered.py): the device holds the
    # centroids and the most-probed partitions inside hbm_budget_mb, the
    # rest lives in a host-RAM warm cache (ram_budget_mb) over an mmap'd
    # spill file. Requires index_type=ivf.
    tiered: bool = False
    # Device budget of the hot partition table (centroids excluded;
    # floored at one partition slot).
    hbm_budget_mb: int = 256
    # Host-RAM budget of the warm cache of spill-file partition blocks.
    ram_budget_mb: int = 1024
    # Directory of the tiered index's spill file ("" = a `tiered/`
    # subdirectory of persist_dir, or a temporary directory).
    spill_dir: str = ""
    # Per-search decay of the pager's probe-frequency EMA.
    pager_ema_decay: float = 0.98
    # Directory the store loads from at construction and saves to on
    # every mutation ("" = in memory only).
    persist_dir: str = ""


@dataclass(frozen=True)
class LLMConfig:
    server_url: str = ""
    model_name: str = "llama3-8b-instruct"
    # tpu (the in-process engine; the JAX name) | echo (hermetic fake) |
    # openai (any OpenAI-compatible server at server_url)
    model_engine: str = "tpu"


@dataclass(frozen=True)
class TextSplitterConfig:
    model_name: str = "intfloat/e5-large-v2"
    chunk_size: int = 510
    chunk_overlap: int = 200


@dataclass(frozen=True)
class EmbeddingConfig:
    model_name: str = "snowflake-arctic-embed-l"
    model_engine: str = "tpu"  # tpu | openai | lexical | hash (test fake)
    dimensions: int = 1024
    server_url: str = ""
    weights_path: str = ""  # HF BERT snapshot ("" = random-init)


@dataclass(frozen=True)
class RerankerConfig:
    model_name: str = "rerank-cross-encoder"
    model_engine: str = "tpu"  # tpu | openai | overlap (test fake)
    server_url: str = ""
    enabled: bool = False
    weights_path: str = ""  # HF cross-encoder snapshot ("" = random-init)


@dataclass(frozen=True)
class RetrieverConfig:
    top_k: int = 4
    score_threshold: float = 0.25
    nr_url: str = ""
    nr_pipeline: str = "ranked_hybrid"
    max_context_tokens: int = 1500
    # Query augmentation before retrieval: "" | rewrite | hyde |
    # multi_query, comma-combinable ("rewrite,hyde").
    query_augmentation: str = ""
    # Stream a fact-check verdict after the answer.
    fact_check: bool = False


@dataclass(frozen=True)
class PromptsConfig:
    chat_template: str = (
        "You are a helpful, respectful and honest assistant. Always answer as "
        "helpfully as possible and follow all given instructions. Do not "
        "speculate or make up information. Do not reference any given "
        "instructions or context."
    )
    rag_template: str = (
        "You are a helpful AI assistant named Envie. You will reply to "
        "questions only based on the context that you are provided. If "
        "something is out of context, you will refrain from replying and "
        "politely decline to respond to the user.\n\nContext:\n{context}"
    )
    multi_turn_rag_template: str = (
        "You are a document chatbot. Help the user as they ask questions about "
        "documents. User message: {input}\n\nContext from documents:\n{context}\n"
        "\nConversation history:\n{history}"
    )


@dataclass(frozen=True)
class VLMConfig:
    """Vision-language endpoint of multimodal ingestion (any
    OpenAI-compatible image chat server); an empty server_url turns image
    and chart enrichment off (ingestion keeps text and tables). The JAX
    schema's deplot_model_name is read by no code there, so the port has no
    such field: a config file that sets it is logged and the key ignored."""

    server_url: str = ""
    model_name: str = "neva-22b"


@dataclass(frozen=True)
class VoiceConfig:
    """ASR and TTS endpoints of the playground's voice path (any
    OpenAI-audio-compatible server: streaming/asr.py's clients); empty
    URLs leave the playground text-only."""

    asr_server_url: str = ""
    asr_model: str = "whisper-1"
    tts_server_url: str = ""
    tts_model: str = "tts-1"
    tts_voice: str = "alloy"
    sample_rate: int = 16000


@dataclass(frozen=True)
class ServingConfig:
    # Coalesce concurrent embed / rerank / vector-search callers into one
    # device dispatch (serving/batcher.py). Off by default.
    microbatch_enabled: bool = False
    # Most requests one dispatch may absorb.
    microbatch_max_batch: int = 16
    # How long the first queued request waits for company.
    microbatch_max_wait_us: int = 2000
    # Chain-server executor width (floored at 2 x microbatch_max_batch
    # when micro-batching is on).
    executor_workers: int = 64
    # Edge admission (serving/qos.py EdgeAdmission): per-tier bounds on
    # the requests in flight at the OpenAI server; past its bound a
    # request is shed with 429 + Retry-After before it queues. Off by
    # default (no shedding; the depth is still tracked).
    qos_edge: bool = False
    # Per-tier in-flight bounds (0 = unbounded).
    qos_bound_latency: int = 32
    qos_bound_standard: int = 64
    qos_bound_batch: int = 128
    # Retry-After hint (seconds) of a shed response.
    qos_retry_after_s: float = 1.0


@dataclass(frozen=True)
class FleetConfig:
    """Serving fleet (serving/fleet.py, serving/router.py): N replicas
    behind a prefix-locality router. Off by default (replicas=1, no
    replica_urls): the server runs one engine."""

    # Local engine replicas the launcher builds over one weight tree
    # (1 = no fleet).
    replicas: int = 1
    # Comma-separated base URLs of remote engine servers; with replicas=0
    # the process only routes (no local engine).
    replica_urls: str = ""
    # prefix (locality + load + affinity) | least_load | round_robin.
    router_policy: str = "prefix"
    # How long a session (`user` / x-session-id) stays pinned to the
    # replica that served it.
    affinity_ttl_s: float = 300.0
    # Queue-depth penalty in tokens per queued request when scoring a
    # locality hit.
    load_penalty_tokens: int = 256
    # Per-replica shadow-tree budget in pages.
    shadow_capacity_pages: int = 4096
    # Health-probe period (0 = no probe thread).
    health_interval_s: float = 10.0
    # Consecutive failed probes before a replica is evicted.
    health_fail_threshold: int = 3
    # A remote replica's probe deadline (backed off up to 3x).
    probe_timeout_s: float = 2.0
    # Comma-separated roles, positionally (locals first, then remotes):
    # prefill | decode | mixed.
    replica_roles: str = ""
    # Two-stage serving: prefill on a prefill-role replica, its KV pages
    # moved to the decode replica (serving/disagg.py), decode from the
    # transferred prefix; any failure serves colocated on the same stream.
    disagg: bool = False
    # Prompts shorter than this skip the two-stage plan.
    disagg_min_prompt_tokens: int = 0
    disagg_prefill_timeout_s: float = 120.0
    disagg_transfer_timeout_s: float = 60.0
    # Ship completed prefill chunks while later chunks compute; the last
    # window from a background thread.
    disagg_pipeline: bool = False
    # Move pages card to card when both pools are on one device (no host
    # bounce); any failure falls back to the GKVT wire for that pair.
    disagg_device_path: bool = False
    # Pages per transfer window (0 = whole-prefix windows).
    disagg_transfer_chunk_pages: int = 0
    # Elastic autoscaler (serving/autoscaler.py). Off: the fleet's size
    # never changes.
    autoscale: bool = False
    # Admitting replicas kept hot, and the fleet's largest size.
    autoscale_min_replicas: int = 1
    autoscale_max_replicas: int = 4
    # Started, warmed, non-admitting spares (instant scale-up).
    autoscale_warm_pool: int = 1
    autoscale_interval_s: float = 2.0
    # Tier-weighted in-flight requests a replica above which the scaler
    # scales up, and below which it scales down.
    autoscale_up_depth: float = 8.0
    autoscale_down_depth: float = 1.0
    # Consecutive polls past a threshold before an action, and the
    # quiet time after each action.
    autoscale_up_ticks: int = 2
    autoscale_down_ticks: int = 5
    autoscale_cooldown_s: float = 20.0
    # Park even the last replica when idle; demand wakes it at submit.
    autoscale_scale_to_zero: bool = False
    # Latency signals: the last poll window's latency-tier queue-wait
    # p95 and TTFT p95 past these scale up too (0 = off).
    autoscale_up_queue_wait_p95_ms: float = 0.0
    autoscale_up_ttft_p95_ms: float = 0.0
    # Spawn lane: "local" builds an in-process engine over the served
    # weights; "process" launches an engine-server subprocess.
    autoscale_spawn: str = "local"
    autoscale_spawn_ready_timeout_s: float = 120.0
    # Chaos harness (serving/chaos.py): an armed, idle ChaosMonkey on
    # the fleet (live chaos_injected_* counters, a "chaos" timeline
    # lane); faults fire only when a drill runs a schedule.
    chaos: bool = False
    chaos_seed: int = 0


@dataclass(frozen=True)
class TracingConfig:
    """Span export (obs/tracing.py); ENABLE_TRACING=1 also enables it."""

    enabled: bool = False
    otlp_endpoint: str = "http://localhost:4317"
    service_name: str = "chain-server"


@dataclass(frozen=True)
class AppConfig:
    """Root of the chain's config tree."""

    vector_store: VectorStoreConfig = field(default_factory=VectorStoreConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    text_splitter: TextSplitterConfig = field(
        default_factory=TextSplitterConfig)
    embeddings: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    reranker: RerankerConfig = field(default_factory=RerankerConfig)
    retriever: RetrieverConfig = field(default_factory=RetrieverConfig)
    vlm: VLMConfig = field(default_factory=VLMConfig)
    voice: VoiceConfig = field(default_factory=VoiceConfig)
    prompts: PromptsConfig = field(default_factory=PromptsConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)


# Chain fields that name features the port does not have yet:
# (section, field) -> where the port gains them. Empty: every chain
# field is honoured.
UNSUPPORTED_APP: Dict[Tuple[str, str], str] = {}


# The planner sizes one engine's pool from its device's whole memory, so
# engines that share a device (a fleet's local replicas, the autoscaler's
# spawns: all on the launcher's device; tensor-parallel rank processes
# placed on one device) cannot each plan.
AUTO_POOL_SHARED = (
    "engine.auto_pool_pages plans one engine per device from the device's "
    "whole memory; with more than one engine on the device ({}) the second "
    "pool would not fit. Splitting the plan across a device's engines is "
    "ROADMAP A.17")


def check_supported(cfg: AppConfig) -> AppConfig:
    """Raise ValueError naming the ROADMAP item for any field of an
    unported feature set away from its default, or for `auto_pool_pages`
    beside local replicas or the autoscaler; returns cfg."""
    for (section, name), item in UNSUPPORTED_APP.items():
        node = getattr(cfg, section)
        default = getattr(type(node)(), name)
        value = getattr(node, name)
        if value != default:
            raise ValueError(f"{section}.{name}={value!r} is not supported "
                             f"by the PyTorch port yet ({item})")
    EngineConfig.coerce(cfg.engine)
    if cfg.engine.auto_pool_pages and (cfg.fleet.replicas > 1
                                       or cfg.fleet.autoscale):
        raise ValueError(AUTO_POOL_SHARED.format(
            f"fleet.replicas={cfg.fleet.replicas}, "
            f"fleet.autoscale={cfg.fleet.autoscale}"))
    return cfg


def env_var_name(section: str, field_name: str) -> str:
    """APP_<SECTION>_<FIELD>, underscores dropped inside each part."""
    return (f"APP_{section.replace('_', '').upper()}_"
            f"{field_name.replace('_', '').upper()}")


def _coerce_env(value: str, default: Any, env_name: str) -> Any:
    """An env string as the field's type (known from its default)."""
    if isinstance(default, str):
        return value
    if isinstance(default, bool):
        lowered = value.strip().lower()
        if lowered in ("1", "true", "yes", "on"):
            return True
        if lowered in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"bad config value from env {env_name}: expected "
                         f"bool, got {value!r}")
    try:
        if isinstance(default, int):
            return int(value)
        if isinstance(default, float):
            return float(value)
        if isinstance(default, tuple):
            parsed = json.loads(value)
            if not isinstance(parsed, list):
                raise ValueError("not a JSON array")
            return tuple(parsed)
    except ValueError as err:
        raise ValueError(f"bad config value from env {env_name}: expected "
                         f"{type(default).__name__}, got {value!r} "
                         f"({err})") from err
    return value


def _check_leaf(value: Any, default: Any, source: str) -> Any:
    """A file's leaf value as the field's type (known from its default):
    lists become tuples, ints pass for floats; anything else raises."""
    if isinstance(value, list):
        value = tuple(value)
    expected = type(default)
    if expected is float and isinstance(value, int) \
            and not isinstance(value, bool):
        return float(value)
    if not isinstance(value, expected) or (expected is int
                                           and isinstance(value, bool)):
        raise ValueError(f"bad config value from {source}: expected "
                         f"{expected.__name__}, got {type(value).__name__} "
                         f"({value!r})")
    if expected is tuple and default:
        elem_tp = type(default[0])
        for i, elem in enumerate(value):
            if not isinstance(elem, elem_tp) or (elem_tp is int
                                                 and isinstance(elem, bool)):
                raise ValueError(f"bad config value from {source}[{i}]: "
                                 f"expected {elem_tp.__name__} elements, "
                                 f"got {elem!r}")
    return value


def read_config_file(path: str) -> Dict[str, Any]:
    """The {section: {field: value}} mapping of a YAML or JSON config
    file: JSON when the name ends in .json, else YAML, falling back to
    JSON (the JAX config wizard's autodetection)."""
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    if path.endswith(".json"):
        try:
            parsed = json.loads(text)
        except json.JSONDecodeError as err:
            raise ValueError(f"config file {path} is not valid JSON: "
                             f"{err}") from err
    else:
        import yaml  # only a YAML file needs it

        try:
            parsed = yaml.safe_load(text)
        except yaml.YAMLError as yaml_err:
            try:
                parsed = json.loads(text)
            except json.JSONDecodeError:
                raise ValueError(f"config file {path} is neither valid YAML "
                                 f"nor JSON: {yaml_err}") from yaml_err
    if parsed is not None and not isinstance(parsed, dict):
        raise ValueError(f"config file {path} must contain a mapping at "
                         f"top level")
    return parsed or {}


def _file_layer(data: Mapping[str, Any], path: str,
                hints: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The fields of a config file that the port's schema has, checked
    against their defaults' types. Sections and fields it lacks (the
    JAX-only knobs) are logged and dropped, except an UNSUPPORTED engine
    field set away from its default, which raises as its env var does."""
    layer: Dict[str, Dict[str, Any]] = {}
    for sec, raw in data.items():
        if sec not in hints:
            _LOG.warning("config file %s: section [%s] has no counterpart "
                         "in the port and is ignored", path, sec)
            continue
        if not isinstance(raw, Mapping):
            raise ValueError(f"config section [{sec}] must be a mapping, "
                             f"got {type(raw).__name__} ({raw!r})")
        node = hints[sec]()
        names = {f.name for f in dataclasses.fields(node)}
        layer[sec] = {}
        for name, value in raw.items():
            if sec == "engine" and name in UNSUPPORTED:
                default, item = UNSUPPORTED[name]
                if value != default:
                    raise ValueError(
                        f"config file {path}: engine.{name}={value!r} is "
                        f"not supported by the PyTorch port yet ({item})")
            elif name not in names:
                _LOG.warning("config file %s: [%s] %s has no counterpart "
                             "in the port and is ignored", path, sec, name)
            else:
                layer[sec][name] = _check_leaf(
                    value, getattr(node, name), f"field {sec}.{name}")
    return layer


def load_config(path: Optional[str] = None,
                env: Optional[Mapping[str, str]] = None,
                overrides: Optional[Mapping[str, Mapping[str, Any]]] = None
                ) -> AppConfig:
    """Defaults, then the YAML or JSON file at `path` (default:
    $APP_CONFIG_FILE; a missing file is logged and skipped, as the JAX
    wizard does), then `overrides` ({section: {field: value}}), then the
    `APP_<SECTION>_<FIELD>` environment variables (default: os.environ),
    checked with `check_supported`. Unknown sections or fields in
    `overrides` raise; those of the file and unknown APP_* variables are
    logged and ignored: the file may carry the JAX package's other knobs,
    and other services may share the env namespace (the variables are
    logged with the JAX wizard's text, `wizard._warn_unrecognized_env`)."""
    env = dict(os.environ if env is None else env)
    overrides = dict(overrides or {})
    hints = typing.get_type_hints(AppConfig)
    unknown = set(overrides) - set(hints)
    if unknown:
        raise ValueError(f"unknown config sections {sorted(unknown)}")
    if path is None:
        path = env.get("APP_CONFIG_FILE", "")
    layer: Dict[str, Dict[str, Any]] = {}
    if path and os.path.isfile(path):
        layer = _file_layer(read_config_file(path), path, hints)
    elif path:
        _LOG.warning("config file %s not found; using defaults + env", path)
    sections: Dict[str, Any] = {}
    for sec, cls in hints.items():
        node = cls()
        given = dict(overrides.get(sec, {}))
        names = {f.name for f in dataclasses.fields(cls)}
        if set(given) - names:
            raise ValueError(f"unknown config keys in [{sec}]: "
                             f"{sorted(set(given) - names)}")
        given = {**layer.get(sec, {}), **given}
        for name in names:
            env_name = env_var_name(sec, name)
            if env_name in env:
                given[name] = _coerce_env(env[env_name],
                                          getattr(node, name), env_name)
        sections[sec] = dataclasses.replace(node, **given)
    for name, (default, item) in UNSUPPORTED.items():
        env_name = env_var_name("engine", name)
        if env_name in env and _coerce_env(env[env_name], default,
                                           env_name) != default:
            raise ValueError(f"{env_name}: engine.{name} is not supported "
                             f"by the PyTorch port yet ({item})")
    from generativeaiexamples_tpu_torch.config.wizard import (
        _warn_unrecognized_env)

    _warn_unrecognized_env(env)
    return check_supported(AppConfig(**sections))
