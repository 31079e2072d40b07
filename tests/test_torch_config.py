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
from generativeaiexamples_tpu_torch.config.schema import (AppConfig,
                                                          load_config)

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
@pytest.mark.parametrize("section, name, value, item", [
    ("engine", "prefix_cache", True, "A.15"),
    ("engine", "step_plans", True, "A.14"),
    ("retriever", "query_augmentation", "rewrite", "A.11"),
    ("vector_store", "index_type", "ivf", "A.18"),
])
def test_config_file_refuses_unported_fields(tmp_path, kind, section, name,
                                             value, item):
    path = _write(tmp_path, kind, {section: {name: value}})
    with pytest.raises(ValueError, match=item):
        load_config(env={"APP_CONFIG_FILE": path})
    # The JAX wizard takes the same file: the refusal is the port's.
    assert getattr(getattr(jax_load(path, env={}), section), name) == value


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
