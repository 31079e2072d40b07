"""Engine server launcher: `python -m generativeaiexamples_tpu_torch.serving`.

Counterpart of generativeaiexamples_tpu/serving/__main__.py without
fleet or multi-host. The config comes from `load_config()` (the
APP_CONFIG_FILE file and APP_<SECTION>_<FIELD> variables):

- `engine.weights_path`: an HF Llama snapshot (safetensors, config.json
  and, for real text, tokenizer.json), loaded in `engine.dtype` and
  quantized to weight-only int8 at load with
  `engine.quantize_weights=int8`. Empty: random weights at the
  --model-size geometry from a seed, with the byte tokenizer, as the JAX
  launcher does.
- `embeddings.weights_path`, `reranker.weights_path`: HF BERT snapshots
  for the embedder and the cross-encoder, each with its own tokenizer,
  bf16 on the card and f32 on the CPU. Empty: with a random LLM, the JAX
  launcher's hermetic tiny encoders (on the CPU) or random ones at full
  width (arctic-embed-l, BERT-base; on the card, where K3 takes head_dim
  64 only); with a loaded LLM, none (the endpoint answers 503).

    APP_ENGINE_WEIGHTSPATH=/models/llama3-8b-instruct \\
        python -m generativeaiexamples_tpu_torch.serving
    APP_ENGINE_WEIGHTSPATH=/models/llama3-8b-instruct \\
        APP_ENGINE_QUANTIZEWEIGHTS=int8 APP_ENGINE_KVDTYPE=int8 \\
        APP_EMBEDDINGS_WEIGHTSPATH=/models/arctic-embed-l \\
        APP_RERANKER_WEIGHTSPATH=/models/reranker \\
        python -m generativeaiexamples_tpu_torch.serving
    python -m generativeaiexamples_tpu_torch.serving --model-size tiny \\
        --device cpu --port 8099

Serves /v1/chat/completions, /v1/completions, /v1/embeddings,
/v1/ranking, /v1/models, /health and /metrics on one port.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import Any, Optional, Tuple

import torch

from generativeaiexamples_tpu_torch.config.schema import EngineConfig
from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.models import bert, hf_loader, llama
from generativeaiexamples_tpu_torch.ops.quant import quantize_llama_params
from generativeaiexamples_tpu_torch.serving.encoders import (
    EmbeddingEngine, RerankEngine)
from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
from generativeaiexamples_tpu_torch.utils.tokenizer import (
    ByteTokenizer, load_tokenizer)

GEOMETRIES = {
    # The tiny test geometry's vocabulary covers the byte tokenizer's
    # specials (<bos> is 257), so every prompt id has an embedding row.
    "tiny": lambda: llama.LlamaConfig.tiny(vocab_size=ByteTokenizer().vocab_size),
    "1b": llama.LlamaConfig.llama3_2_1b,
    "8b": llama.LlamaConfig.llama3_8b,
}


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_engine(model_size: str = "8b", device: DeviceLike = None,
                 seed: int = 0, warmup: bool = True, engine_cfg: Any = None,
                 n_pages: Optional[int] = None,
                 weights_path: str = "") -> LLMEngine:
    """An LLMEngine at `engine_cfg` (default: the default EngineConfig)
    on `device` (CUDA unless asked otherwise) with `n_pages` pool pages
    (default: the engine's sizing), warmed up (not started).

    With `weights_path` (default: `engine_cfg.weights_path`) the HF
    snapshot there is loaded in `engine_cfg.dtype`, weight-only int8
    quantized at load when `engine_cfg.quantize_weights` is "int8", with
    the snapshot's tokenizer (`load_tokenizer`'s gate applies). Without,
    the model is random-init at the named geometry (in its own dtype:
    f32 for tiny, bf16 otherwise), drawn from `seed`, quantized after
    init for int8, with the byte tokenizer."""
    dev = resolve_device(device)
    ecfg = EngineConfig.coerce(engine_cfg)
    weights_path = weights_path or ecfg.weights_path
    quantize = ecfg.quantize_weights == "int8"
    if weights_path:
        params, cfg = hf_loader.load_llama(
            weights_path, device=dev, dtype=DTYPES[ecfg.dtype],
            quantize=quantize)
        tokenizer = load_tokenizer(weights_path)
    else:
        cfg = GEOMETRIES[model_size]()
        logging.warning("engine.weights_path empty: random-init %s model, "
                        "seed %d, on %s", model_size, seed, dev)
        params = llama.init_params(
            cfg, dev, torch.Generator(device=dev).manual_seed(seed))
        if quantize:
            params = quantize_llama_params(params, dev)
        tokenizer = load_tokenizer("byte")
    engine = LLMEngine(params, cfg, tokenizer, ecfg, n_pages=n_pages,
                       device=dev)
    return engine.warmup() if warmup else engine


ENCODER_GEOMETRIES = {
    # The JAX launcher's hermetic encoders (vocabulary 512 covers the
    # byte tokenizer's ids).
    "tiny": (lambda: bert.BertConfig.tiny(vocab_size=512),
             lambda: bert.BertConfig(vocab_size=512, dim=32, n_layers=2,
                                     n_heads=2, mlp_dim=64, max_position=64,
                                     n_labels=1)),
    "full": (lambda: _bf16(bert.BertConfig.arctic_embed_l()),
             lambda: _bf16(bert.BertConfig.reranker_base())),
}


def _bf16(cfg: bert.BertConfig) -> bert.BertConfig:
    return dataclasses.replace(cfg, dtype=torch.bfloat16)


def default_encoder_size(device: DeviceLike = None) -> str:
    """Full width on the card, the hermetic tiny encoders on the CPU."""
    return "full" if resolve_device(device).type == "cuda" else "tiny"


def build_encoders(device: DeviceLike = None, seed: int = 1,
                   embed_path: str = "", rerank_path: str = "",
                   random_init: bool = True
                   ) -> Tuple[Optional[EmbeddingEngine],
                              Optional[RerankEngine]]:
    """The embedder and the cross-encoder reranker on `device` (CUDA
    unless asked otherwise). Each loads from its HF snapshot when given
    one (`embed_path` with n_labels=0, `rerank_path` with n_labels=1; bf16
    on the card, f32 on the CPU), with that snapshot's tokenizer.
    Without, it is random-init at `default_encoder_size(device)` (the
    embedder from `seed`, the reranker from seed + 1) with the byte
    tokenizer when `random_init`, else None: a real LLM is never paired
    with a random encoder."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    geometry = ENCODER_GEOMETRIES[default_encoder_size(dev)]
    out = []
    for engine_cls, path, n_labels, make, s in (
            (EmbeddingEngine, embed_path, 0, geometry[0], seed),
            (RerankEngine, rerank_path, 1, geometry[1], seed + 1)):
        if path:
            params, cfg = hf_loader.load_bert(path, n_labels=n_labels,
                                              dtype=dtype, device=dev)
            out.append(engine_cls(params, cfg, load_tokenizer(path),
                                  device=dev))
        elif random_init:
            cfg = make()
            out.append(engine_cls(
                bert.init_params(cfg, dev, torch.Generator(dev).manual_seed(s)),
                cfg, load_tokenizer("byte"), device=dev))
        else:
            out.append(None)
    return out[0], out[1]


def main() -> None:
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.serving.openai_server import (
        OpenAIServer, run_server)

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--model-size", default="8b", choices=sorted(GEOMETRIES),
                    help="geometry when engine.weights_path is empty")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--model-name", default="llama3-8b-instruct",
                    help="served model id")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    config = load_config()
    emb, rr = build_encoders(
        args.device, embed_path=config.embeddings.weights_path,
        rerank_path=config.reranker.weights_path,
        random_init=not config.engine.weights_path)
    engine = build_engine(args.model_size, args.device,
                          engine_cfg=config.engine).start()
    logging.info("engine server on %s:%d (device %s)", args.host, args.port,
                 engine.device)
    try:
        run_server(OpenAIServer(engine, emb, rr, model_name=args.model_name),
                   args.host, args.port)
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
