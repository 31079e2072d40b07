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
               "speculative_tree_branches": 4, "flight_ring_size": 512,
               # The pacer and the planner are ported: read as JAX does.
               "pace_emission_max_streams": 4, "auto_pool_pages": True,
               "hbm_gb_per_device": 40, "planner_headroom_fraction": 0.2,
               # A JAX-only engine knob: logged and ignored by the port.
               "enable_pallas_kernels": True},
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
    # The prefix cache, the pager and multi-host tensor-parallel serving
    # (A.17, the pager's slice mode included) are ported: read as the JAX
    # wizard reads them (item None: accepted).
    pytest.param("engine", {"prefix_cache": True, "kv_pager": True,
                            "multihost": True}, None,
                 id="engine-prefix_cache-True-A.15"),
    # Step plans, QoS, the memory planner and multi-host are ported: the
    # file reads. (The engine refuses step plans beside multi-host at
    # build, serving/multihost.py.)
    pytest.param("engine", {"step_plans": True, "qos": True,
                            "auto_pool_pages": True, "multihost": True},
                 None, id="engine-step_plans-True-A.14"),
    # The fleet's autoscaler and chaos harness are ported (A.16): read
    # as the JAX wizard reads them (item None: accepted).
    pytest.param("fleet", {"replicas": 2, "autoscale": True,
                           "autoscale_spawn": "process"}, None,
                 id="fleet-autoscale-True-A.16"),
    pytest.param("fleet", {"disagg": True, "chaos": True, "chaos_seed": 7},
                 None, id="fleet-chaos-True-A.16"),
    # The ANN indexes are ported (A.18): the IVF, int8 and tiered knobs
    # are read as the JAX wizard reads them.
    pytest.param("vector_store", {"tiered": True, "hbm_budget_mb": 512,
                                  "ram_budget_mb": 2048,
                                  "spill_dir": "/var/spill",
                                  "pager_ema_decay": 0.9}, None,
                 id="vector_store-tiered-True-A.18"),
    pytest.param("vector_store", {"index_type": "ivf", "quantize_int8": True,
                                  "nlist": 128}, None,
                 id="vector_store-index_type-ivf-A.18"),
])
def test_config_file_refuses_unported_fields(tmp_path, kind, section, fields,
                                             item):
    path = _write(tmp_path, kind, {section: fields})
    if item is None:
        port = getattr(load_config(env={"APP_CONFIG_FILE": path}), section)
        assert {n: getattr(port, n) for n in fields} == fields
    else:
        with pytest.raises(ValueError, match=item):
            load_config(env={"APP_CONFIG_FILE": path})
    # The JAX wizard takes the same file: a refusal is the port's.
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
    assert "enable_pallas_kernels" in caplog.text
    # The [mesh] section is read since multi-host serving is ported.
    assert "[mesh]" not in caplog.text
    # The flight recorder's, the pacer's and the planner's knobs are
    # ported: read, not logged.
    for name in ("flight_ring_size", "pace_emission_max_streams",
                 "auto_pool_pages", "hbm_gb_per_device"):
        assert name not in caplog.text


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
    if isinstance(value, (int, float)):
        return value + 1
    return "x" if isinstance(value, str) else value


# The chain fields once refused (the ANN knobs, A.18), beside any still
# refused.
CHAIN_KEYS = sorted({*UNSUPPORTED_APP, ("vector_store", "index_type"),
                     ("vector_store", "quantize_int8"),
                     ("vector_store", "tiered")})


@pytest.mark.parametrize("key", CHAIN_KEYS, ids=".".join)
def test_remaining_chain_refusals_name_their_item(key):
    """A field still unported is refused naming its item; a ported one
    (the test keeps the name it had when all were refused) is read from
    overrides and the env as the JAX wizard reads it."""
    section, name = key
    default = getattr(getattr(AppConfig(), section), name)
    value = _off_default(default)
    if key in UNSUPPORTED_APP:
        with pytest.raises(ValueError,
                           match=UNSUPPORTED_APP[key].split(":")[0]):
            load_config(env={}, overrides={section: {name: value}})
        return
    port = load_config(env={}, overrides={section: {name: value}})
    assert getattr(getattr(port, section), name) == value
    env = {f"APP_{section.replace('_', '').upper()}_"
           f"{name.replace('_', '').upper()}": str(value)}
    port, theirs = load_config(env=env), jax_load(env=env)
    assert getattr(getattr(port, section), name) == getattr(
        getattr(theirs, section), name) == value
    _assert_same(port, theirs)


@pytest.mark.parametrize("name", ["multihost"])
def test_remaining_engine_refusals_name_their_item(name):
    """No engine flag is refused any more: multihost, the last one, is
    read from the env as the JAX wizard reads it (the engine refuses it
    at build without rank processes, serving/multihost.py)."""
    assert name not in UNSUPPORTED and not UNSUPPORTED
    env = {f"APP_ENGINE_{name.replace('_', '').upper()}": "true"}
    port, theirs = load_config(env=env), jax_load(env=env)
    assert getattr(port.engine, name) is getattr(theirs.engine, name) is True
    _assert_same(port, theirs)


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


# The fused prefill rider and the unfused finish are ported: their three
# knobs read from the env or the file as the JAX wizard reads them.
FUSED_FIELDS = {"fused_prefill": True, "fused_token_budget": 256,
                "fused_sampling": False}
FUSED_ENV = {"APP_ENGINE_FUSEDPREFILL": "true",
             "APP_ENGINE_FUSEDTOKENBUDGET": "256",
             "APP_ENGINE_FUSEDSAMPLING": "false"}


@pytest.mark.parametrize("source", ["env", "json", "yaml"])
def test_fused_prefill_fields_match_jax_wizard(tmp_path, source):
    default, theirs = load_config(env={}).engine, jax_load(env={}).engine
    assert {n: getattr(default, n) for n in FUSED_FIELDS} == {
        n: getattr(theirs, n) for n in FUSED_FIELDS} == {
        "fused_prefill": False, "fused_token_budget": 512,
        "fused_sampling": True}
    env = (dict(FUSED_ENV) if source == "env" else {
        "APP_CONFIG_FILE": _write(tmp_path, source,
                                  {"engine": FUSED_FIELDS})})
    port = load_config(env=env)
    _assert_same(port, jax_load(env=env))
    assert {n: getattr(port.engine, n) for n in FUSED_FIELDS} == \
        FUSED_FIELDS
    assert "fused_prefill" not in UNSUPPORTED


def test_fused_prefill_beside_speculation_is_accepted():
    """As in the JAX engine, a speculative config may set the rider, with
    or without step plans (APP_ENGINE_STEPPLANS, read as the JAX wizard
    reads it); QoS and the fleet's autoscaler beside them too."""
    port = load_config(env={**FUSED_ENV, "APP_ENGINE_SPECULATIVEK": "3"})
    assert port.engine.fused_prefill and port.engine.speculative_k == 3
    assert not port.engine.step_plans
    env = {**FUSED_ENV, "APP_ENGINE_SPECULATIVEK": "3",
           "APP_ENGINE_STEPPLANS": "true"}
    port = load_config(env=env)
    assert port.engine.step_plans
    _assert_same(port, jax_load(env=env))
    # QoS and the fleet's autoscaler beside them are read as the JAX
    # wizard reads them.
    port = load_config(env={**env, "APP_ENGINE_QOS": "true"})
    assert port.engine.qos
    _assert_same(port, jax_load(env={**env, "APP_ENGINE_QOS": "true"}))
    env = {**env, "APP_FLEET_AUTOSCALE": "true",
           "APP_FLEET_AUTOSCALEWARMPOOL": "2"}
    port = load_config(env=env)
    assert port.fleet.autoscale and port.fleet.autoscale_warm_pool == 2
    _assert_same(port, jax_load(env=env))


# Step plans and the flight recorder are ported: read from the env or the
# file as the JAX wizard reads them, with its defaults.
PLAN_FLIGHT_FIELDS = {"step_plans": True, "flight_recorder": False,
                      "flight_ring_size": 256}
PLAN_FLIGHT_ENV = {"APP_ENGINE_STEPPLANS": "yes",
                   "APP_ENGINE_FLIGHTRECORDER": "0",
                   "APP_ENGINE_FLIGHTRINGSIZE": "256"}


@pytest.mark.parametrize("source", ["env", "json", "yaml"])
def test_step_plans_and_flight_fields_match_jax_wizard(tmp_path, source,
                                                       caplog):
    default, theirs = load_config(env={}).engine, jax_load(env={}).engine
    assert {n: getattr(default, n) for n in PLAN_FLIGHT_FIELDS} == {
        n: getattr(theirs, n) for n in PLAN_FLIGHT_FIELDS} == {
        "step_plans": False, "flight_recorder": True,
        "flight_ring_size": 4096}
    env = (dict(PLAN_FLIGHT_ENV) if source == "env" else {
        "APP_CONFIG_FILE": _write(tmp_path, source,
                                  {"engine": PLAN_FLIGHT_FIELDS})})
    with caplog.at_level(logging.WARNING):
        port = load_config(env=env)
    assert "ignored" not in caplog.text
    _assert_same(port, jax_load(env=env))
    assert {n: getattr(port.engine, n) for n in PLAN_FLIGHT_FIELDS} == \
        PLAN_FLIGHT_FIELDS
    assert not set(PLAN_FLIGHT_FIELDS) & set(UNSUPPORTED)


# The fleet, QoS and the edge are ported: read from the env or the file as
# the JAX wizard reads them, with its defaults.
FLEET_FIELDS = {"replicas": 2, "replica_urls": "http://h1:8000",
                "router_policy": "least_load", "affinity_ttl_s": 30.0,
                "load_penalty_tokens": 64, "shadow_capacity_pages": 512,
                "health_interval_s": 0.5, "health_fail_threshold": 2,
                "probe_timeout_s": 1.5, "replica_roles": "prefill,decode",
                "disagg": True, "disagg_min_prompt_tokens": 128,
                "disagg_prefill_timeout_s": 30.0,
                "disagg_transfer_timeout_s": 20.0, "disagg_pipeline": True,
                "disagg_device_path": True,
                "disagg_transfer_chunk_pages": 8}
QOS_ENGINE_FIELDS = {"qos": True, "qos_weight_latency": 6,
                     "qos_weight_standard": 3, "qos_weight_batch": 2,
                     "qos_preempt_prefill": False}
QOS_SERVING_FIELDS = {"qos_edge": True, "qos_bound_latency": 4,
                      "qos_bound_standard": 8, "qos_bound_batch": 2,
                      "qos_retry_after_s": 2.5}


@pytest.mark.parametrize("source", ["env", "json", "yaml"])
def test_fleet_and_qos_fields_match_jax_wizard(tmp_path, source):
    default = load_config(env={})
    theirs = jax_load(env={})
    for sec, fields in (("fleet", FLEET_FIELDS),
                        ("engine", QOS_ENGINE_FIELDS),
                        ("serving", QOS_SERVING_FIELDS)):
        assert {n: getattr(getattr(default, sec), n) for n in fields} == {
            n: getattr(getattr(theirs, sec), n) for n in fields}
    data = {"fleet": FLEET_FIELDS, "engine": QOS_ENGINE_FIELDS,
            "serving": QOS_SERVING_FIELDS}
    if source == "env":
        env = {f"APP_{sec.upper()}_{n.replace('_', '').upper()}":
               str(v).lower() if isinstance(v, bool) else str(v)
               for sec, fields in data.items() for n, v in fields.items()}
    else:
        env = {"APP_CONFIG_FILE": _write(tmp_path, source, data)}
    port = load_config(env=env)
    _assert_same(port, jax_load(env=env))
    for sec, fields in data.items():
        assert {n: getattr(getattr(port, sec), n) for n in fields} == fields
    assert "qos" not in UNSUPPORTED


@pytest.mark.parametrize("field", ["autoscale", "autoscale_max_replicas",
                                   "autoscale_spawn", "chaos",
                                   "chaos_seed"])
def test_fleet_autoscaler_and_chaos_are_refused_naming_a16(tmp_path, field):
    """The autoscaler and the chaos harness (A.16) are ported: their
    fields, once refused naming A.16 (the test keeps the name it had
    then), are read from overrides, the file and the env as the JAX
    wizard reads them."""
    default = getattr(AppConfig().fleet, field)
    value = "process" if field == "autoscale_spawn" else _off_default(default)
    port = load_config(env={}, overrides={"fleet": {field: value}})
    assert getattr(port.fleet, field) == value
    path = _write(tmp_path, "yaml", {"fleet": {field: value}})
    env = {"APP_CONFIG_FILE": path}
    port = load_config(env=env)
    assert getattr(port.fleet, field) == value
    _assert_same(port, jax_load(env=env))
    env = {f"APP_FLEET_{field.replace('_', '').upper()}": str(value)}
    _assert_same(load_config(env=env), jax_load(env=env))


@pytest.mark.parametrize("fleet", [{"replicas": 2}, {"autoscale": True}],
                         ids=["replicas", "autoscale"])
@pytest.mark.parametrize("source", ["env", "yaml"])
def test_auto_pool_pages_refused_beside_engines_sharing_a_device(
        tmp_path, fleet, source):
    """The planner sizes one engine a device from the device's whole
    memory: beside local replicas or the autoscaler's spawns (all on one
    device) the port refuses it naming A.17; the JAX wizard reads the
    same deployment."""
    data = {"engine": {"auto_pool_pages": True}, "fleet": fleet}
    if source == "env":
        env = {"APP_ENGINE_AUTOPOOLPAGES": "true",
               **{f"APP_FLEET_{n.replace('_', '').upper()}": str(v).lower()
                  for n, v in fleet.items()}}
    else:
        env = {"APP_CONFIG_FILE": _write(tmp_path, source, data)}
    with pytest.raises(ValueError, match=r"auto_pool_pages.*A\.17"):
        load_config(env=env)
    theirs = jax_load(env=env)
    assert theirs.engine.auto_pool_pages
    assert {n: getattr(theirs.fleet, n) for n in fleet} == fleet
    # Either alone is accepted.
    for part in ({"engine": data["engine"]}, {"fleet": fleet}):
        load_config(env={"APP_CONFIG_FILE": _write(tmp_path, "json", part)})


# The emission pacer and the memory planner are ported: read from the env
# and the file under the JAX wizard's names, with its defaults.
PACER_PLANNER_FIELDS = {"pace_emission_max_streams": 4,
                        "auto_pool_pages": True, "hbm_gb_per_device": 79.5,
                        "planner_headroom_fraction": 0.15}
PACER_PLANNER_ENV = {"APP_ENGINE_PACEEMISSIONMAXSTREAMS": "4",
                     "APP_ENGINE_AUTOPOOLPAGES": "true",
                     "APP_ENGINE_HBMGBPERDEVICE": "79.5",
                     "APP_ENGINE_PLANNERHEADROOMFRACTION": "0.15"}


@pytest.mark.parametrize("source", ["env", "yaml", "json"])
def test_pacer_and_planner_fields_read_as_jax(tmp_path, source):
    if source == "env":
        env = dict(PACER_PLANNER_ENV)
    else:
        env = {"APP_CONFIG_FILE": _write(
            tmp_path, source, {"engine": PACER_PLANNER_FIELDS})}
    port = load_config(env=env)
    assert {n: getattr(port.engine, n) for n in PACER_PLANNER_FIELDS} == \
        PACER_PLANNER_FIELDS
    _assert_same(port, jax_load(env=env))
    defaults = load_config(env={}).engine
    assert (defaults.pace_emission_max_streams, defaults.auto_pool_pages,
            defaults.hbm_gb_per_device,
            defaults.planner_headroom_fraction) == (16, False, 0.0, 0.1)
    assert not set(PACER_PLANNER_FIELDS) & set(UNSUPPORTED)
    assert set(UNSUPPORTED) == set()  # multihost is ported (A.17)
    assert not UNSUPPORTED_APP  # the ANN knobs are ported (A.18)


# The ANN indexes (A.18): every vector_store knob the JAX store honours.
ANN_FIELDS = {"index_type": "ivf", "nlist": 256, "nprobe": 24,
              "quantize_int8": True, "tiered": True, "hbm_budget_mb": 1024,
              "ram_budget_mb": 4096, "spill_dir": "/var/spill",
              "pager_ema_decay": 0.95}
ANN_ENV = {"APP_VECTORSTORE_INDEXTYPE": "ivf", "APP_VECTORSTORE_NLIST": "256",
           "APP_VECTORSTORE_NPROBE": "24",
           "APP_VECTORSTORE_QUANTIZEINT8": "true",
           "APP_VECTORSTORE_TIERED": "1",
           "APP_VECTORSTORE_HBMBUDGETMB": "1024",
           "APP_VECTORSTORE_RAMBUDGETMB": "4096",
           "APP_VECTORSTORE_SPILLDIR": "/var/spill",
           "APP_VECTORSTORE_PAGEREMADECAY": "0.95"}


@pytest.mark.parametrize("source", ["env", "json", "yaml"])
def test_ann_fields_match_jax_wizard(tmp_path, source):
    """The IVF, int8 and tiered knobs, from the env or the file, read as
    the JAX wizard reads them (defaults included); a bad value raises in
    both."""
    default, theirs = load_config(env={}), jax_load(env={})
    assert {n: getattr(default.vector_store, n) for n in ANN_FIELDS} == {
        n: getattr(theirs.vector_store, n) for n in ANN_FIELDS}
    env = (dict(ANN_ENV) if source == "env" else {
        "APP_CONFIG_FILE": _write(tmp_path, source,
                                  {"vector_store": ANN_FIELDS})})
    port = load_config(env=env)
    _assert_same(port, jax_load(env=env))
    assert {n: getattr(port.vector_store, n) for n in ANN_FIELDS} == \
        ANN_FIELDS
    bad = {"APP_VECTORSTORE_HBMBUDGETMB": "lots"}
    for load in (load_config, jax_load):
        with pytest.raises(ValueError, match="HBMBUDGETMB"):
            load(env=bad)
