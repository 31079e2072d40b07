"""Configuration of the port: the engine and the RAG chain.

The port's own copy of the slice of generativeaiexamples_tpu's
config/schema.py that this package honours, with the same names and
defaults:

- `EngineConfig`: the serving engine, speculation included
  (`speculative_k`, `speculative_tree_branches`). Flags of the JAX
  engine that the port does not have yet (step plans, the fused prefill
  rider, prefix cache, ...) are listed in `UNSUPPORTED` with the ROADMAP
  item that brings them; `EngineConfig.coerce` refuses any of them set
  away from its default.
- `AppConfig`: the sections the developer_rag chain reads (llm,
  embeddings, reranker, retriever, prompts, text_splitter, vector_store,
  serving, engine). `load_config()` reads the YAML or JSON file that
  `APP_CONFIG_FILE` names, overlays `APP_<SECTION>_<FIELD>` environment
  variables (the JAX config wizard's contract) and refuses fields that
  name unported features when they are set away from their defaults
  (`check_supported`), in the file as in the env.
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
    # Greedy self-speculation: k n-gram draft tokens per verify step from
    # the device token history, verified in one forward (0 = off).
    # Sampled requests fall back to plain decode on the same engine.
    speculative_k: int = 0
    # Tree verify: this many k-deep draft branches per step, verified as
    # one packed tree (0 or 1 = the linear chain). Inert without
    # speculative_k, as in the JAX engine.
    speculative_tree_branches: int = 0
    # First tokens are sampled inside the prefill dispatch (bucketed
    # groups and the chunk that completes a long prompt). The port has
    # only that form, so False is refused.
    fused_sampling: bool = True

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
        if not out.fused_sampling:
            raise ValueError("engine.fused_sampling=False (the unfused "
                             "two-dispatch finish, an A/B knob of the JAX "
                             "engine) is not ported (ROADMAP A.7)")
        return out


# JAX EngineConfig flags outside this slice: name -> (default, where the
# port will gain it).
UNSUPPORTED = {
    "weights_path": ("", "ROADMAP A.10: HF checkpoint loading"),
    "step_plans": (False, "ROADMAP A.14: step plans"),
    "fused_prefill": (False, "ROADMAP A.14: fused prefill"),
    "prefix_cache": (False, "ROADMAP A.15: prefix cache"),
    "kv_pager": (False, "ROADMAP A.15: KV pager"),
    "qos": (False, "ROADMAP A.16: QoS"),
    "multihost": (False, "ROADMAP A.17: multi-host"),
    "auto_pool_pages": (False, "ROADMAP A.17: memory planner"),
}


# -- the chain's sections ------------------------------------------------


@dataclass(frozen=True)
class VectorStoreConfig:
    name: str = "memory"  # memory | tpu | native (tpu/native: device store)
    url: str = ""
    nlist: int = 64
    nprobe: int = 16
    index_type: str = "flat"  # ivf: ROADMAP A.18
    quantize_int8: bool = False  # ROADMAP A.18
    tiered: bool = False  # ROADMAP A.18
    persist_dir: str = ""  # ROADMAP A.11


@dataclass(frozen=True)
class LLMConfig:
    server_url: str = ""
    model_name: str = "llama3-8b-instruct"
    model_engine: str = "tpu"  # the in-process engine (the JAX name)


@dataclass(frozen=True)
class TextSplitterConfig:
    model_name: str = "intfloat/e5-large-v2"
    chunk_size: int = 510
    chunk_overlap: int = 200


@dataclass(frozen=True)
class EmbeddingConfig:
    model_name: str = "snowflake-arctic-embed-l"
    model_engine: str = "tpu"
    dimensions: int = 1024
    server_url: str = ""
    weights_path: str = ""  # ROADMAP A.10


@dataclass(frozen=True)
class RerankerConfig:
    model_name: str = "rerank-cross-encoder"
    model_engine: str = "tpu"
    server_url: str = ""
    enabled: bool = False
    weights_path: str = ""  # ROADMAP A.10


@dataclass(frozen=True)
class RetrieverConfig:
    top_k: int = 4
    score_threshold: float = 0.25
    nr_url: str = ""
    nr_pipeline: str = "ranked_hybrid"
    max_context_tokens: int = 1500
    query_augmentation: str = ""  # ROADMAP A.11
    fact_check: bool = False  # ROADMAP A.11


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


@dataclass(frozen=True)
class ServingConfig:
    microbatch_enabled: bool = False  # ROADMAP A.11
    executor_workers: int = 64


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
    prompts: PromptsConfig = field(default_factory=PromptsConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)


# Chain fields that name features the port does not have yet:
# (section, field) -> where the port gains them.
UNSUPPORTED_APP = {
    ("retriever", "query_augmentation"): "ROADMAP A.11: query augmentation",
    ("retriever", "fact_check"): "ROADMAP A.11: fact check",
    ("serving", "microbatch_enabled"): "ROADMAP A.11: micro-batching",
    ("vector_store", "index_type"): "ROADMAP A.18: IVF index",
    ("vector_store", "quantize_int8"): "ROADMAP A.18: int8 rows",
    ("vector_store", "tiered"): "ROADMAP A.18: tiered index",
    ("vector_store", "persist_dir"): "ROADMAP A.11: store persistence",
    ("embeddings", "weights_path"): "ROADMAP A.10: checkpoint loading",
    ("reranker", "weights_path"): "ROADMAP A.10: checkpoint loading",
}


def check_supported(cfg: AppConfig) -> AppConfig:
    """Raise ValueError naming the ROADMAP item for any field of an
    unported feature set away from its default; returns cfg."""
    for (section, name), item in UNSUPPORTED_APP.items():
        node = getattr(cfg, section)
        default = getattr(type(node)(), name)
        value = getattr(node, name)
        if value != default:
            raise ValueError(f"{section}.{name}={value!r} is not supported "
                             f"by the PyTorch port yet ({item})")
    EngineConfig.coerce(cfg.engine)
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
    logged and ignored (the file may carry the JAX package's other knobs,
    and other services may share the env namespace)."""
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
    known_env = {"APP_CONFIG_FILE"}
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
            known_env.add(env_name)
            if env_name in env:
                given[name] = _coerce_env(env[env_name],
                                          getattr(node, name), env_name)
        sections[sec] = dataclasses.replace(node, **given)
    for name, (default, item) in UNSUPPORTED.items():
        env_name = env_var_name("engine", name)
        known_env.add(env_name)
        if env_name in env and _coerce_env(env[env_name], default,
                                           env_name) != default:
            raise ValueError(f"{env_name}: engine.{name} is not supported "
                             f"by the PyTorch port yet ({item})")
    for key in env:
        if key.startswith("APP_") and key not in known_env:
            _LOG.warning("env var %s matches no config field of the port "
                         "and is ignored", key)
    return check_supported(AppConfig(**sections))
