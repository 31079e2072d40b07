"""Port parity: config/wizard.py and the `[voice]` section.

`print_config_help`, the cached config (`get_config` / `set_config` /
`config_from_env`) and the unrecognised-env warning against the JAX
wizard's, on the same environments and files.
"""

import dataclasses
import json
import logging

import pytest

from generativeaiexamples_tpu.config import schema as jschema
from generativeaiexamples_tpu.config import wizard as jw
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch.config import schema as tschema
from generativeaiexamples_tpu_torch.config import wizard as tw

# The fields only the JAX tree has: TPU and pandas-agent knobs the port
# logs and ignores (config/schema.py's `_file_layer`).
JAX_ONLY_HELP_LINES = [
    "  APP_LLM_MODELNAMEPANDASAI                    (default: '')",
    "  APP_VLM_DEPLOTMODELNAME                      (default: "
    "'google/deplot')",
    "  APP_ENGINE_ENABLEPALLASKERNELS               (default: True)",
    "  APP_ENGINE_COMPILECACHEDIR                   (default: "
    "'/tmp/gaie_tpu/compile_cache')",
]


def _sections(text):
    out, cur = [], None
    for ln in text.splitlines():
        if ln.startswith("["):
            cur = (ln, [])
            out.append(cur)
        elif ln.strip() and cur is not None:
            cur[1].append(ln)
    return out


def test_help_is_jax_help_without_the_jax_only_fields():
    """The same sections in the same order; in each, the same lines (a
    section may list its fields in another order: the port's engine
    section does)."""
    want = _sections(jw.print_config_help())
    got = _sections(tw.print_config_help())
    assert [h for h, _ in got] == [h for h, _ in want]
    for (h, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(ln for ln in w
                                   if ln not in JAX_ONLY_HELP_LINES), h
    jax_lines = {ln for _, w in want for ln in w}
    assert set(JAX_ONLY_HELP_LINES) <= jax_lines
    assert tw.print_config_help().splitlines()[:2] == \
        jw.print_config_help().splitlines()[:2]
    assert "[voice]" in [h for h, _ in got]


def test_voice_section_matches_jax():
    assert dataclasses.asdict(tschema.VoiceConfig()) == \
        dataclasses.asdict(jschema.VoiceConfig())
    assert [f.name for f in dataclasses.fields(tschema.AppConfig)] == [
        f.name for f in dataclasses.fields(jschema.AppConfig)]


@pytest.mark.parametrize("source", ["env", "yaml", "json"])
def test_voice_is_read_not_ignored(tmp_path, source, caplog):
    values = {"asr_server_url": "http://asr:9000", "asr_model": "w-2",
              "tts_server_url": "http://tts:9001", "tts_voice": "echo",
              "sample_rate": 22050}
    env = {}
    path = ""
    if source == "env":
        env = {jschema.env_var_name("voice", k): str(v)
               for k, v in values.items()}
    else:
        path = str(tmp_path / f"cfg.{source}")
        text = json.dumps({"voice": values})
        if source == "yaml":
            import yaml

            text = yaml.safe_dump({"voice": values})
        with open(path, "w") as fh:
            fh.write(text)
    with caplog.at_level(logging.WARNING):
        got = tschema.load_config(path=path, env=env).voice
    want = jw.load_config(path=path, env=env).voice
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.sample_rate == 22050 and got.asr_model == "w-2"
    assert "no counterpart" not in caplog.text
    assert "matches no config field" not in caplog.text


def test_unrecognized_env_warnings_equal_jax(caplog):
    env = {"APP_LLM_MODEL_NAME": "x", "APP_VOICE_ASR_SERVER_URL": "y",
           "APP_NOPE": "1", "APP_LLM_MODELNAME": "ok", "OTHER": "1"}
    with caplog.at_level(logging.WARNING):
        jw._warn_unrecognized_env(env)
        want = [r.getMessage() for r in caplog.records]
        caplog.clear()
        tw._warn_unrecognized_env(env)
        got = [r.getMessage() for r in caplog.records]
        caplog.clear()
        tschema.load_config(path="", env=env)
        loaded = [r.getMessage() for r in caplog.records]
    assert got == want and len(want) == 3
    assert loaded == want


def test_cached_config_follows_jax(monkeypatch):
    old_j, old_t = jw._CONFIG, tw._CONFIG
    try:
        jw._CONFIG = tw._CONFIG = None
        monkeypatch.setenv("APP_LLM_MODELNAME", "first")
        monkeypatch.delenv("APP_CONFIG_FILE", raising=False)
        for w in (jw, tw):
            a = w.get_config()
            assert a.llm.model_name == "first"
            monkeypatch.setenv("APP_LLM_MODELNAME", "second")
            assert w.get_config() is a  # cached
            b = w.get_config(refresh=True)
            assert b is not a and b.llm.model_name == "second"
            w.set_config(a)
            assert w.get_config() is a
            monkeypatch.setenv("APP_LLM_MODELNAME", "first")
        monkeypatch.setenv("APP_CONFIG_FILE", "/nonexistent/cfg.yaml")
        monkeypatch.setenv("APP_RETRIEVER_TOPK", "9")
        assert tw.config_from_env().retriever.top_k == \
            jw.config_from_env().retriever.top_k == 9
    finally:
        jw._CONFIG, tw._CONFIG = old_j, old_t


def test_package_exports_the_wizard():
    for name in ("get_config", "set_config", "config_from_env",
                 "load_config", "print_config_help", "VoiceConfig"):
        assert hasattr(tconfig, name), name
    assert tconfig.load_config is tschema.load_config
