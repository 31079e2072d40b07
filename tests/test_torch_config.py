"""The port's config file read (APP_CONFIG_FILE) against the JAX wizard.

The port's `load_config` layers defaults, the YAML or JSON file, and the
`APP_<SECTION>_<FIELD>` env as `generativeaiexamples_tpu.config.wizard`
does; for the same file and env both give the same value in every field
the port has. A file that sets an unported feature is refused naming its
ROADMAP item, as the env var is; the JAX package's other knobs are logged
and ignored.
"""

import dataclasses
import json
import logging

import pytest
import yaml

from generativeaiexamples_tpu.config.wizard import load_config as jax_load
from generativeaiexamples_tpu_torch.config.schema import (
    UNSUPPORTED, UNSUPPORTED_APP, AppConfig, load_config)

# A deployment's file: every section the port reads, one int8 speculative
# engine, and JAX-only knobs the port does not have.
FILE = {
    "llm": {"model_name": "llama3-8b-instruct", "server_url": "http://h:1"},
    "embeddings": {"dimensions": 768, "model_name": "e5"},
    "reranker": {"enabled": True},
    "retriever": {"top_k": 6, "score_threshold": 0.5,
                  "max_context_tokens": 900},
    "text_splitter": {"chunk_size": 256, "chunk_overlap": 32},
    "vector_store": {"name": "tpu", "nprobe": 8},
    "prompts": {"chat_template": "Be brief."},
    "serving": {"executor_workers": 16},
    "engine": {"kv_dtype": "int8", "quantize_weights": "int8",
               "max_batch_size": 128, "page_size": 64,
               "prefill_buckets": [128, 512], "speculative_k": 3,
               "speculative_tree_branches": 4,
               # JAX-only engine knobs: logged and ignored by the port.
               "flight_ring_size": 512, "enable_pallas_kernels": True},
    "mesh": {"ici_tensor": 1},
}

ENV = {"APP_RETRIEVER_TOPK": "9", "APP_ENGINE_PAGESIZE": "128",
       "APP_TEXTSPLITTER_CHUNKOVERLAP": "16"}


def _write(tmp_path, kind, data):
    if kind == "json":
        p = tmp_path / "config.json"
        p.write_text(json.dumps(data))
    else:
        p = tmp_path / "config.yaml"
        p.write_text(yaml.safe_dump(data))
    return str(p)


def _assert_same(port: AppConfig, theirs) -> None:
    for f in dataclasses.fields(port):
        ours = dataclasses.asdict(getattr(port, f.name))
        node = dataclasses.asdict(getattr(theirs, f.name))
        assert {k: node[k] for k in ours} == ours, f.name


@pytest.mark.parametrize("kind", ["json", "yaml"])
@pytest.mark.parametrize("with_env", [False, True])
def test_config_file_matches_jax_wizard(tmp_path, kind, with_env):
    path = _write(tmp_path, kind, FILE)
    env = {"APP_CONFIG_FILE": path, **(ENV if with_env else {})}
    port = load_config(env=env)
    _assert_same(port, jax_load(env=env))
    # The file was read and the env sits on top of it.
    assert port.engine.kv_dtype == "int8"
    assert port.engine.speculative_k == 3
    assert port.engine.prefill_buckets == (128, 512)
    assert port.embeddings.dimensions == 768
    assert port.retriever.top_k == (9 if with_env else 6)
    assert port.engine.page_size == (128 if with_env else 64)
    # An explicit path reads the same file.
    assert load_config(path, env={k: v for k, v in env.items()
                                  if k != "APP_CONFIG_FILE"}) == port


@pytest.mark.parametrize("kind", ["json", "yaml"])
@pytest.mark.parametrize("section, fields, item", [
    # The prefix cache and the pager are ported; beside multi-host (the
    # pager's slice mode is ROADMAP A.17) the file is still refused.
    pytest.param("engine", {"prefix_cache": True, "kv_pager": True,
                            "multihost": True}, "A.17",
                 id="engine-prefix_cache-True-A.15"),
    pytest.param("engine", {"step_plans": True}, "A.14",
                 id="engine-step_plans-True-A.14"),
    pytest.param("vector_store", {"tiered": True}, "A.18",
                 id="vector_store-tiered-True-A.18"),
    pytest.param("vector_store", {"index_type": "ivf"}, "A.18",
                 id="vector_store-index_type-ivf-A.18"),
])
def test_config_file_refuses_unported_fields(tmp_path, kind, section, fields,
                                             item):
    path = _write(tmp_path, kind, {section: fields})
    with pytest.raises(ValueError, match=item):
        load_config(env={"APP_CONFIG_FILE": path})
    # The JAX wizard takes the same file: the refusal is the port's.
    node = getattr(jax_load(path, env={}), section)
    assert {n: getattr(node, n) for n in fields} == fields


PREFIX_FIELDS = {"prefix_cache": True, "prefix_cache_capacity": 0.25,
                 "kv_pager": True, "kv_host_budget_mb": 512,
                 "kv_spill_dir": "/var/spill"}
PREFIX_ENV = {"APP_ENGINE_PREFIXCACHE": "true",
              "APP_ENGINE_PREFIXCACHECAPACITY": "0.25",
              "APP_ENGINE_KVPAGER": "1", "APP_ENGINE_KVHOSTBUDGETMB": "512",
              "APP_ENGINE_KVSPILLDIR": "/var/spill"}


@pytest.mark.parametrize("source", ["env", "json", "yaml"])
def test_prefix_cache_fields_match_jax_wizard(tmp_path, source):
    """The five prefix-cache and pager fields, from the env or the file,
    read as the JAX wizard reads them (defaults included)."""
    default = load_config(env={}).engine
    theirs = jax_load(env={}).engine
    assert {n: getattr(default, n) for n in PREFIX_FIELDS} == {
        n: getattr(theirs, n) for n in PREFIX_FIELDS}
    assert not default.prefix_cache and not default.kv_pager
    env = (dict(PREFIX_ENV) if source == "env" else {
        "APP_CONFIG_FILE": _write(tmp_path, source,
                                  {"engine": PREFIX_FIELDS})})
    port = load_config(env=env)
    _assert_same(port, jax_load(env=env))
    assert {n: getattr(port.engine, n) for n in PREFIX_FIELDS} == \
        PREFIX_FIELDS


def test_config_file_unported_field_at_default_passes(tmp_path):
    path = _write(tmp_path, "yaml", {"engine": {"prefix_cache": False,
                                                "qos": False}})
    assert load_config(env={"APP_CONFIG_FILE": path}) == load_config(env={})


def test_config_file_missing_falls_back_with_warning(tmp_path, caplog):
    env = {"APP_CONFIG_FILE": str(tmp_path / "nope.yaml"),
           "APP_RETRIEVER_TOPK": "5"}
    with caplog.at_level(logging.WARNING):
        cfg = load_config(env=env)
    assert "not found" in caplog.text
    assert cfg.retriever.top_k == 5
    assert cfg == load_config(env={"APP_RETRIEVER_TOPK": "5"})
    _assert_same(cfg, jax_load(env=env))


def test_config_file_jax_only_keys_logged(tmp_path, caplog):
    path = _write(tmp_path, "yaml", FILE)
    with caplog.at_level(logging.WARNING):
        load_config(env={"APP_CONFIG_FILE": path})
    assert "flight_ring_size" in caplog.text
    assert "[mesh]" in caplog.text


@pytest.mark.parametrize("data, match", [
    ({"retriever": {"top_k": "six"}}, "retriever.top_k"),
    ({"engine": {"prefill_buckets": ["128"]}}, "engine.prefill_buckets"),
    ({"retriever": 3}, "must be a mapping"),
])
def test_config_file_bad_values_raise(tmp_path, data, match):
    path = _write(tmp_path, "json", data)
    with pytest.raises(ValueError, match=match):
        load_config(env={"APP_CONFIG_FILE": path})
    with pytest.raises(ValueError):
        jax_load(path, env={})


# Checkpoint loading (engine, embedder, reranker) and store persistence
# are ported: their fields are accepted, from the env or the file.
SERVE_FROM_DISK = {"engine": {"weights_path": "/models/llama"},
                   "embeddings": {"weights_path": "/models/embed"},
                   "reranker": {"weights_path": "/models/rerank"},
                   "vector_store": {"persist_dir": "/var/store"}}
SERVE_FROM_DISK_ENV = {"APP_ENGINE_WEIGHTSPATH": "/models/llama",
                       "APP_EMBEDDINGS_WEIGHTSPATH": "/models/embed",
                       "APP_RERANKER_WEIGHTSPATH": "/models/rerank",
                       "APP_VECTORSTORE_PERSISTDIR": "/var/store"}


@pytest.mark.parametrize("source", ["env", "json", "yaml"])
def test_weights_path_and_persist_dir_accepted(tmp_path, source):
    env = (dict(SERVE_FROM_DISK_ENV) if source == "env" else {
        "APP_CONFIG_FILE": _write(tmp_path, source, SERVE_FROM_DISK)})
    port = load_config(env=env)
    _assert_same(port, jax_load(env=env))
    for sec, fields in SERVE_FROM_DISK.items():
        node = getattr(port, sec)
        assert {n: getattr(node, n) for n in fields} == fields


def _off_default(value):
    if isinstance(value, bool):
        return not value
    return "x" if isinstance(value, str) else value


@pytest.mark.parametrize("key", sorted(UNSUPPORTED_APP), ids=".".join)
def test_remaining_chain_refusals_name_their_item(key):
    section, name = key
    default = getattr(getattr(AppConfig(), section), name)
    with pytest.raises(ValueError, match=UNSUPPORTED_APP[key].split(":")[0]):
        load_config(env={}, overrides={section: {name: _off_default(
            default)}})


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_remaining_engine_refusals_name_their_item(name):
    default, item = UNSUPPORTED[name]
    env = {f"APP_ENGINE_{name.replace('_', '').upper()}":
           "true" if isinstance(default, bool) else "x"}
    with pytest.raises(ValueError, match=item.split(":")[0]):
        load_config(env=env)


# The chain's tracing section, the micro-batch knobs, query augmentation,
# the fact check, the external stores and the decode K cap are ported:
# read from the env or the file as the JAX wizard reads them.
CHAIN_FIELDS = {
    "tracing": {"enabled": True, "otlp_endpoint": "http://collector:4317",
                "service_name": "rag"},
    "serving": {"microbatch_enabled": True, "microbatch_max_batch": 8,
                "microbatch_max_wait_us": 500},
    "retriever": {"query_augmentation": "rewrite,hyde", "fact_check": True},
    "engine": {"prefill_decode_k_cap": 4},
    "vector_store": {"name": "pgvector", "url": "postgresql://u@h/db"},
    "llm": {"model_engine": "echo"},
    "embeddings": {"model_engine": "lexical"},
    "reranker": {"model_engine": "overlap"},
}
CHAIN_ENV = {"APP_TRACING_ENABLED": "1",
             "APP_TRACING_OTLPENDPOINT": "http://collector:4317",
             "APP_TRACING_SERVICENAME": "rag",
             "APP_SERVING_MICROBATCHENABLED": "true",
             "APP_SERVING_MICROBATCHMAXBATCH": "8",
             "APP_SERVING_MICROBATCHMAXWAITUS": "500",
             "APP_RETRIEVER_QUERYAUGMENTATION": "rewrite,hyde",
             "APP_RETRIEVER_FACTCHECK": "yes",
             "APP_ENGINE_PREFILLDECODEKCAP": "4",
             "APP_VECTORSTORE_NAME": "pgvector",
             "APP_VECTORSTORE_URL": "postgresql://u@h/db",
             "APP_LLM_MODELENGINE": "echo",
             "APP_EMBEDDINGS_MODELENGINE": "lexical",
             "APP_RERANKER_MODELENGINE": "overlap"}


@pytest.mark.parametrize("source", ["env", "json", "yaml"])
def test_chain_and_k_cap_fields_match_jax_wizard(tmp_path, source, caplog):
    env = (dict(CHAIN_ENV) if source == "env" else {
        "APP_CONFIG_FILE": _write(tmp_path, source, CHAIN_FIELDS)})
    with caplog.at_level(logging.WARNING):
        port = load_config(env=env)
    assert "no counterpart" not in caplog.text
    assert "ignored" not in caplog.text
    _assert_same(port, jax_load(env=env))
    for sec, fields in CHAIN_FIELDS.items():
        node = getattr(port, sec)
        assert {n: getattr(node, n) for n in fields} == fields, sec


def test_chain_and_k_cap_defaults_match_jax_wizard():
    port, theirs = load_config(env={}), jax_load(env={})
    _assert_same(port, theirs)
    assert dataclasses.asdict(port.tracing) == dataclasses.asdict(
        theirs.tracing)
    assert port.engine.prefill_decode_k_cap == \
        theirs.engine.prefill_decode_k_cap == 2
    assert not {("retriever", "query_augmentation"),
                ("retriever", "fact_check"),
                ("serving", "microbatch_enabled")} & set(UNSUPPORTED_APP)
