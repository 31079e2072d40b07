"""Import hygiene of the PyTorch port.

The port (`generativeaiexamples_tpu_torch`) and `chip_smoke.py` import
torch and never jax, and nothing of the JAX package: the card's machine
has no jax. Entry points run on CUDA unless the caller asks for the CPU;
with no CUDA and no explicit device they raise instead of falling back.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "generativeaiexamples_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__") for p in PORT_FILES)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_every_port_module_imports_with_jax_blocked():
    """`sys.modules["jax"] = None` makes any `import jax` raise."""
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",
        "sys.modules['generativeaiexamples_tpu'] = None",
        f"sys.path.insert(0, {str(ROOT)!r})",
        f"for m in {MODULES!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "for name in ('emit', 'nvidia_smi', 'time_ms', 'bound', "
        "'phase_flash', 'phase_paged', 'phase_model', 'phase_serving', "
        "'main'):",
        "    getattr(chip_smoke, name)",
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items()"
        " if v is not None}",
        "print('ok', len(sys.modules))",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "generativeaiexamples_tpu")]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_raise_without_cuda_or_explicit_device(monkeypatch):
    from generativeaiexamples_tpu_torch.device import resolve_device
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.serving.__main__ import build_engine
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
    from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(cfg)
    params = llama.init_params(cfg, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(params, cfg, ByteTokenizer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine("tiny", warmup=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_cuda():
    """Without a card the check prints no result and exits non-zero."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
