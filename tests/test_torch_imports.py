"""Import hygiene of the PyTorch port.

The port (`generativeaiexamples_tpu_torch`) and `chip_smoke.py` import
torch and never jax, and nothing of the JAX package: the card's machine
has no jax. Nor do they import safetensors, ml_dtypes, transformers or
requests (the HTTP clients use urllib). psutil and the OpenTelemetry SDK
are optional: imported only inside the functions that fall back without
them (obs/tracing.py's `setup` and `get_system_metrics`), so every module
imports with both missing. Entry points run on CUDA unless the caller
asks for the CPU; with no CUDA and no explicit device they raise instead
of falling back.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "generativeaiexamples_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
# The hello world and the tutorials are scripts (jupytext percent files
# run at import, argv parsed there): scanned below, never imported.
EXAMPLES = sorted((PORT / "examples").rglob("*.py"))
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__") for p in PORT_FILES if p not in EXAMPLES)


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
        "'phase_flash', 'phase_paged', 'phase_encoder', 'phase_model', "
        "'phase_serving', 'phase_chunked', 'phase_rag', 'phase_paged_int8', "
        "'phase_int8_matmul', 'phase_serving_int8', 'phase_tree', "
        "'phase_spec_int8', 'phase_spec_bf16', 'phase_prefix', "
        "'checkpoint_streams', 'phase_checkpoint', 'phase_chain', "
        "'phase_flight', 'phase_fused_prefill', 'phase_fused_prefill_int8', "
        "'phase_fleet', 'phase_pacer', 'phase_ann', 'phase_tp', "
        "'paged_int8_sdpa_gathered_ms', 'phase_ingest', 'phase_eval', "
        "'phase_ui', 'phase_train', 'phase_streaming', "
        "'phase_train_ranks', '_train_rank_leg', 'phase_tools_int8', "
        "'phase_tools_encoders', 'phase_tutorial', 'main'):",
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


def test_fleet_and_planner_modules_are_covered():
    """The elastic fleet's and the memory planner's modules are among
    those imported with jax blocked and scanned below."""
    for name in ("autoscaler", "chaos", "memory_plan"):
        assert f"generativeaiexamples_tpu_torch.serving.{name}" in MODULES


def test_step_graphs_module_is_covered():
    """The warmed engine's CUDA graphs (serving/step_graphs.py, the
    counterpart of the JAX steps' jit) are imported with jax blocked and
    scanned below; the module imports no CUDA-only package at import."""
    assert "generativeaiexamples_tpu_torch.serving.step_graphs" in MODULES


def test_framework_neutral_and_training_modules_are_covered():
    """The wizard, ingest, eval, CVE agent, playground, SSE, voice and
    training modules are among those imported with jax blocked and
    scanned below (the playground rides aiohttp, the clients urllib)."""
    for name in ("config.wizard", "ingest.pipeline", "eval.metrics",
                 "eval.harness", "eval.__main__", "agents.cve",
                 "ui.server", "ui.chat_client", "ui.__main__", "utils.sse",
                 "utils.http", "streaming.asr", "training.trainer",
                 "training.lora", "training.retriever_ft"):
        assert f"generativeaiexamples_tpu_torch.{name}" in MODULES, name


def test_sharded_training_and_streaming_modules_are_covered():
    """Ring attention, the GPipe pipeline, the whole streaming package
    and the native ring are among the modules imported with jax and the
    JAX package blocked and scanned below; the native ring's C source is
    the port's own copy, beside its binding."""
    for name in ("ops.ring_attention", "parallel.pipeline",
                 "streaming", "streaming.__main__", "streaming.dsp",
                 "streaming.replay", "streaming.timestamps",
                 "streaming.accumulator", "streaming.prompts",
                 "streaming.chains", "streaming.server", "streaming.asr",
                 "native", "native.ring"):
        assert f"generativeaiexamples_tpu_torch.{name}" in MODULES, name
    assert (PORT / "native" / "sdr_ring.c").is_file()
    src = (PORT / "native" / "ring.py").read_text()
    assert "_sdr_ring.so" not in src and "generativeaiexamples_tpu/" \
        not in src.split('"""', 2)[2]


def test_lint_modules_are_covered():
    """graftlint's torch side, file for file with the JAX package's
    lint/, is among the modules imported with jax and the JAX package
    blocked and scanned below (it imports neither torch nor jax: it
    parses source)."""
    jax_lint = ROOT / "generativeaiexamples_tpu" / "lint"
    names = sorted(".".join(p.relative_to(jax_lint).with_suffix("").parts)
                   for p in jax_lint.rglob("*.py"))
    assert len(names) == 17
    for name in names:
        mod = "generativeaiexamples_tpu_torch.lint" + (
            "" if name == "__init__" else "." + name.removesuffix(
                ".__init__"))
        assert mod in MODULES, mod


def test_streaming_entry_points_raise_without_cuda_or_explicit_device(
        monkeypatch):
    """The DSP, the receiver, the pump and the IQ source run on CUDA
    unless the caller asks for the CPU; with no CUDA they raise."""
    import numpy as np

    from generativeaiexamples_tpu_torch.streaming import dsp, replay
    from generativeaiexamples_tpu_torch.streaming.asr import FakeASR

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    audio = np.zeros(160, np.float32)
    for call in (lambda: dsp.FMReceiver(250_000),
                 lambda: dsp.firwin(33, 0.2),
                 lambda: dsp.fm_modulate(audio, 16_000, 250_000),
                 lambda: dsp.resample_poly(audio, 2, 1),
                 lambda: replay.StreamPump(FakeASR(), lambda s, t: None),
                 lambda: list(replay.iq_chunks(audio, 16_000, 250_000))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert dsp.FMReceiver(250_000, device="cpu").taps.device.type == "cpu"


def test_scripts_and_examples_are_covered():
    """The attribution tools are among the modules imported with jax and
    the JAX package blocked; the hello world and the seven tutorials
    among the files scanned (not imported) below."""
    for name in ("ttft_breakdown", "decompose_decode",
                 "decompose_bert_forward", "decompose_encoders",
                 "profile_card"):
        assert f"generativeaiexamples_tpu_torch.scripts.{name}" in MODULES
    names = [p.name for p in EXAMPLES]
    assert "5_mins_rag.py" in names and len(names) == 8
    assert set(EXAMPLES) <= set(PORT_FILES)
    assert not any(".examples" in m for m in MODULES)


def test_ann_modules_are_covered():
    """The ANN indexes' modules (ops/ivf.py, ops/tiered.py) are among
    those imported with jax blocked and scanned below."""
    for name in ("ivf", "tiered"):
        assert f"generativeaiexamples_tpu_torch.ops.{name}" in MODULES
        assert PORT / "ops" / f"{name}.py" in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    """Nor the packages that read checkpoints for the JAX loader: the port
    reads safetensors itself (the card's machine need not have them); nor
    requests, which the card's machine does not list."""
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "generativeaiexamples_tpu", "safetensors",
                                  "ml_dtypes", "transformers", "requests")]
    assert not bad, f"{path.name} imports {bad}"


OPTIONAL = ("psutil", "opentelemetry")


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_optional_packages_only_in_guarded_function_imports(path):
    """psutil and the OpenTelemetry SDK: never at module level, and only
    in obs/tracing.py's functions, each inside a try block."""
    tree = ast.parse(path.read_text(), str(path))
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            for inner in node.body:
                for sub in ast.walk(inner):
                    guarded.add(id(sub))
    found = []
    for fn in [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        for node in ast.walk(fn):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            if any(n.split(".")[0] in OPTIONAL for n in names):
                found.append((fn.name, id(node) in guarded))
    top = [m for node in tree.body for m in (
        [a.name for a in node.names] if isinstance(node, ast.Import) else
        [node.module] if isinstance(node, ast.ImportFrom) and node.module
        else []) if m.split(".")[0] in OPTIONAL]
    assert not top, f"{path.name} imports {top} at module level"
    if path.name == "tracing.py":
        assert {f for f, _ in found} <= {
            "setup", "get_system_metrics", "extract_context",
            "inject_context", "current_context", "attach_context",
            "detach_context", "context"}, found
        assert all(ok for _, ok in found), found
    else:
        assert not found, f"{path.name} imports {found}"


def test_every_port_module_imports_without_the_optional_packages():
    """psutil and the OpenTelemetry SDK blocked: every module imports, the
    tracer takes the built-in backend and the host metrics their
    resource-module fallback."""
    code = "\n".join([
        "import importlib, sys",
        "for m in ('jax', 'generativeaiexamples_tpu', 'psutil',",
        "          'opentelemetry', 'opentelemetry.sdk', 'requests'):",
        "    sys.modules[m] = None",
        f"sys.path.insert(0, {str(ROOT)!r})",
        f"for m in {MODULES!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "from generativeaiexamples_tpu_torch.obs import tracing",
        "exp = tracing.MemoryExporter()",
        "assert tracing.setup(exporter=exp) and tracing._BACKEND == 'mini'",
        "m = tracing.get_system_metrics()",
        "assert m['system.memory_rss_mb'] > 0 and 'system.cpu_user_s' in m",
        "tracing.ManualSpan('x').end()",
        "assert [s.name for s in exp.get_finished_spans()] == ['x']",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


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


def test_int8_entry_points_raise_without_cuda_or_explicit_device(
        monkeypatch):
    """quantize_llama_params, the int8 pool and an int8 engine (and its
    launcher) resolve to CUDA unless given the CPU."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.quant import (
        quantize_llama_params)
    from generativeaiexamples_tpu_torch.serving.__main__ import build_engine
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
    from generativeaiexamples_tpu_torch.serving.kv_cache import (
        PagePool, QuantPagePool)
    from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, "cpu")
    int8 = {"kv_dtype": "int8", "quantize_weights": "int8"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize_llama_params(params)
    for make in (lambda: QuantPagePool.zeros(cfg, 4, 8),
                 lambda: PagePool.zeros(cfg, 4, 8, dtype=torch.int8),
                 lambda: build_engine("tiny", warmup=False, engine_cfg=int8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    qparams = quantize_llama_params(params, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(qparams, cfg, ByteTokenizer(), int8)
    monkeypatch.setenv("APP_ENGINE_QUANTIZEWEIGHTS", "int8")
    monkeypatch.setenv("APP_ENGINE_KVDTYPE", "int8")
    monkeypatch.setattr("sys.argv", ["serving", "--port", "0"])
    from generativeaiexamples_tpu_torch.serving import __main__ as launcher
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main()
    # Asked for the CPU, they build.
    assert QuantPagePool.zeros(cfg, 4, 8, "cpu").quantized
    eng = build_engine("tiny", "cpu", warmup=False, engine_cfg=int8)
    assert eng.pool.quantized and eng.params["layers"]["wq"].q.dtype \
        == torch.int8


def test_spec_entry_points_raise_without_cuda_or_explicit_device(
        monkeypatch):
    """A speculative engine (linear and tree, bf16 and int8 pools) and the
    launcher with APP_ENGINE_SPECULATIVE* resolve to CUDA unless given
    the CPU."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.serving import __main__ as launcher
    from generativeaiexamples_tpu_torch.serving.__main__ import build_engine
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
    from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, "cpu")
    specs = ({"speculative_k": 3},
             {"speculative_k": 3, "speculative_tree_branches": 4},
             {"speculative_k": 1, "kv_dtype": "int8"})
    for spec in specs:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LLMEngine(params, cfg, ByteTokenizer(), spec)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_engine("tiny", warmup=False, engine_cfg=spec)
    monkeypatch.setenv("APP_ENGINE_SPECULATIVEK", "3")
    monkeypatch.setenv("APP_ENGINE_SPECULATIVETREEBRANCHES", "4")
    monkeypatch.setattr("sys.argv", ["serving", "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main()
    # Asked for the CPU, they build, with the device state speculation
    # needs.
    for spec in specs:
        eng = LLMEngine(params, cfg, ByteTokenizer(), spec, device="cpu")
        assert eng._spec_k == spec["speculative_k"]
        assert eng._history.shape == (eng.ecfg.max_batch_size,
                                      eng.ecfg.max_seq_len)


def test_rag_entry_points_raise_without_cuda_or_explicit_device(
        monkeypatch):
    """The encoders, the device store, the engine hub behind the chain
    server, and both launchers resolve to CUDA unless given the CPU."""
    from generativeaiexamples_tpu_torch.api import server as api
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.models import bert
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        DeviceVectorStore)
    from generativeaiexamples_tpu_torch.serving import __main__ as launcher
    from generativeaiexamples_tpu_torch.serving.encoders import (
        EmbeddingEngine, RerankEngine)
    from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = bert.BertConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert.init_params(cfg)
    params = bert.init_params(cfg, "cpu")
    rcfg = bert.BertConfig(**{**cfg.__dict__, "n_labels": 1})
    for make in (lambda: EmbeddingEngine(params, cfg, ByteTokenizer()),
                 lambda: RerankEngine(bert.init_params(rcfg, "cpu"), rcfg,
                                      ByteTokenizer()),
                 lambda: DeviceVectorStore(8),
                 lambda: EngineHub(load_config(env={})),
                 lambda: api.ChainServer(load_config(env={})),
                 lambda: launcher.build_encoders(),
                 lambda: launcher.default_encoder_size()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    monkeypatch.setattr("sys.argv", ["api", "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.main()
    monkeypatch.setattr("sys.argv", ["serving", "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main()
    # A sharded index (and a store over a mesh) places its shards on the
    # mesh's devices: CUDA ones raise here; a mesh of CPUs builds.
    from generativeaiexamples_tpu_torch.config.schema import MeshConfig
    from generativeaiexamples_tpu_torch.ops.ivf import ShardedIVFIndex
    from generativeaiexamples_tpu_torch.ops.topk import ShardedMIPSIndex
    from generativeaiexamples_tpu_torch.parallel.mesh import build_mesh

    rows = np.ones((16, 8), np.float32)
    for devices in (["cuda:0", "cuda:0"], ["cuda:0", "cuda:1"]):
        mesh = build_mesh(MeshConfig(ici_tensor=2), devices)
        for make in (lambda: ShardedMIPSIndex(rows, mesh),
                     lambda: ShardedIVFIndex(rows, 2, mesh),
                     lambda: DeviceVectorStore(8, mesh=mesh)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    mesh = build_mesh(MeshConfig(ici_tensor=2), ["cpu", "cpu"])
    assert ShardedMIPSIndex(rows, mesh).device.type == "cpu"
    assert DeviceVectorStore(8, mesh=mesh).device.type == "cpu"
    # Asked for the CPU, they build.
    assert DeviceVectorStore(8, device="cpu").device.type == "cpu"
    assert launcher.default_encoder_size("cpu") == "tiny"
    emb, rr = launcher.build_encoders("cpu")
    assert emb.device.type == rr.device.type == "cpu"
    assert emb.cfg.dim == 32 and rr.cfg.n_labels == 1


def test_library_path_rebuilds_when_a_shared_header_changes(
        tmp_path, monkeypatch):
    """Each kernel's library is keyed by its source AND every csrc/*.cuh
    header (sources include the shared mma helpers), so editing a header
    gives every kernel a new library path, i.e. a rebuild."""
    from generativeaiexamples_tpu_torch import kernels

    for src in kernels.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = {n: kernels.library_path(n) for n in kernels.SIGNATURES}
    header = tmp_path / "mma_bf16.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: kernels.library_path(n) for n in kernels.SIGNATURES}
    assert all(before[n] != after[n] for n in kernels.SIGNATURES)
    (tmp_path / "encoder_attention.cu").write_text("// edited source")
    assert kernels.library_path("encoder_attention") != \
        after["encoder_attention"]
    assert kernels.library_path("flash_attention") == after["flash_attention"]
    assert '#include "mma_bf16.cuh"' in (
        kernels.CSRC / "flash_attention.cu").read_text()


def test_chip_smoke_refuses_to_run_without_cuda():
    """Without a card the check prints no result and exits non-zero."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# The chain's pipeline layer (ROADMAP A.11(f)): the six pipelines beside
# developer_rag and the modules they brought.
PIPELINE_MODULES = (
    "generativeaiexamples_tpu_torch.connectors.vlm",
    "generativeaiexamples_tpu_torch.kg",
    "generativeaiexamples_tpu_torch.kg.evaluation",
    "generativeaiexamples_tpu_torch.kg.extraction",
    "generativeaiexamples_tpu_torch.kg.graph",
    "generativeaiexamples_tpu_torch.pipelines.api_catalog",
    "generativeaiexamples_tpu_torch.pipelines.knowledge_graph",
    "generativeaiexamples_tpu_torch.pipelines.multi_turn_rag",
    "generativeaiexamples_tpu_torch.pipelines.multimodal",
    "generativeaiexamples_tpu_torch.pipelines.query_decomposition",
    "generativeaiexamples_tpu_torch.pipelines.structured_data",
    "generativeaiexamples_tpu_torch.utils.fsio",
    "generativeaiexamples_tpu_torch.utils.layout",
    "generativeaiexamples_tpu_torch.utils.pptx",
)


def test_scans_cover_the_pipeline_modules():
    """The AST scan (PORT_FILES) and the blocked-import passes (MODULES)
    both reach every pipeline module, so each is held to importing
    neither jax, the JAX package nor requests."""
    assert set(PIPELINE_MODULES) <= set(MODULES)
    scanned = {".".join(p.relative_to(ROOT).with_suffix("").parts)
               .removesuffix(".__init__") for p in PORT_FILES}
    assert set(PIPELINE_MODULES) <= scanned


def test_pipeline_modules_import_without_their_lazy_packages():
    """pandas (structured_data) and networkx (kg GraphML) are imported
    only inside the functions that need them, and the VLM client rides
    urllib: every pipeline module imports, and the registry lists all
    seven examples, with jax, the JAX package, requests, pandas and
    networkx blocked; chip_smoke's pipelines phase is there."""
    code = "\n".join([
        "import importlib, sys",
        "for m in ('jax', 'generativeaiexamples_tpu', 'requests', 'pandas',",
        "          'networkx'):",
        "    sys.modules[m] = None",
        f"sys.path.insert(0, {str(ROOT)!r})",
        f"for m in {PIPELINE_MODULES!r}:",
        "    importlib.import_module(m)",
        "from generativeaiexamples_tpu_torch.pipelines.base import "
        "list_examples",
        "assert len(list_examples()) == 7, list_examples()",
        "import chip_smoke",
        "for name in ('phase_pipelines', '_pipelines_pdf', "
        "'_pipelines_deck', '_stub_vlm'):",
        "    getattr(chip_smoke, name)",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_flight_module_and_timeline_analyzer_are_covered():
    """The flight recorder is the port's own copy (pure numpy), and
    chip_smoke.py runs scripts/analyze_timeline.py on the card, where no
    JAX is installed: neither may import jax or the JAX package."""
    assert "generativeaiexamples_tpu_torch.serving.flight" in MODULES
    analyzer = ROOT / "scripts" / "analyze_timeline.py"
    assert {m.split(".")[0] for m in _imports(analyzer)} <= {
        "__future__", "argparse", "json", "sys", "typing"}
