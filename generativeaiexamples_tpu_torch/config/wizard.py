"""The process-wide config and `--help-config`.

Counterpart of generativeaiexamples_tpu/config/wizard.py. Loading is
`schema.load_config` (defaults, then the `APP_CONFIG_FILE` file, then
`APP_<SECTION>_<FIELD>` env vars): one loader, which this module wraps
with

* `get_config(refresh)` / `set_config(cfg)`: the cached config under its
  lock;
* `config_from_env()`: defaults and env only, never the file;
* `print_config_help()`: every field of the port's tree with its env
  name and default, in the JAX wizard's line format;
* `_warn_unrecognized_env(env)`: the JAX wizard's warning for an APP_*
  variable that names no field (a typo such as APP_LLM_MODEL_NAME).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import typing
from typing import Mapping, Optional

from generativeaiexamples_tpu_torch.config.schema import (
    UNSUPPORTED, AppConfig, env_var_name, load_config)

_LOG = logging.getLogger(__name__)

_CONFIG_LOCK = threading.Lock()
_CONFIG: Optional[AppConfig] = None


def _known_env_names() -> set:
    names = {"APP_CONFIG_FILE"}
    for f in dataclasses.fields(AppConfig):
        for sub in dataclasses.fields(typing.get_type_hints(AppConfig)[f.name]):
            names.add(env_var_name(f.name, sub.name))
    names.update(env_var_name("engine", name) for name in UNSUPPORTED)
    return names


def _warn_unrecognized_env(env: Mapping[str, str]) -> None:
    """Flag APP_* vars that match no config field. A warning, not an
    error: other services in a deployment may share the APP_ namespace."""
    known = _known_env_names()
    for key in env:
        if key.startswith("APP_") and key not in known:
            _LOG.warning(
                "env var %s matches no config field and is ignored "
                "(did you mean one of the APP_<SECTION>_<FIELD> names from "
                "--help-config? underscores inside section/field names are "
                "dropped, e.g. APP_LLM_MODELNAME)",
                key,
            )


def config_from_env() -> AppConfig:
    """Defaults + env overlay only: never reads APP_CONFIG_FILE."""
    return load_config(path="")


def get_config(refresh: bool = False) -> AppConfig:
    """The process-wide cached config, loaded at the first call (and
    again with `refresh`)."""
    global _CONFIG
    with _CONFIG_LOCK:
        if _CONFIG is None or refresh:
            _CONFIG = load_config()
        return _CONFIG


def set_config(cfg: AppConfig) -> None:
    """Install a config (tests, embedded use)."""
    global _CONFIG
    with _CONFIG_LOCK:
        _CONFIG = cfg


def print_config_help() -> str:
    """Every field with its env var and default (--help-config)."""
    lines = ["Configuration fields (APP_CONFIG_FILE + env overrides):", ""]
    root = AppConfig()
    for f in dataclasses.fields(AppConfig):
        node = getattr(root, f.name)
        lines.append(f"[{f.name}]")
        for sub in dataclasses.fields(node):
            default = getattr(node, sub.name)
            lines.append(
                f"  {env_var_name(f.name, sub.name):<44} "
                f"(default: {default!r})"
            )
        lines.append("")
    return "\n".join(lines)
