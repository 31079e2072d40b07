"""Engine server launcher: `python -m generativeaiexamples_tpu_torch.serving`.

Counterpart of generativeaiexamples_tpu/serving/__main__.py without
fleet or multi-host. There are no checkpoints to load yet (ROADMAP
A.10), so the models are random-init at the chosen published geometry,
from a seed, with the hermetic byte tokenizer -- what the JAX launcher
does when `engine.weights_path` is empty. The encoders are the JAX
launcher's hermetic tiny ones (f32, CPU), or at full width
(arctic-embed-l embedder, BERT-base reranker, bf16) on the card, where
the K3 kernel takes head_dim 64 only.

    python -m generativeaiexamples_tpu_torch.serving --model-size 8b
    python -m generativeaiexamples_tpu_torch.serving --model-size tiny \\
        --device cpu --port 8099

The engine's config comes from the APP_ENGINE_* environment variables
(config/schema.py load_config). The int8 deployment (weight-only int8,
quantized at load, and the fused int8 KV pool):

    APP_ENGINE_QUANTIZEWEIGHTS=int8 APP_ENGINE_KVDTYPE=int8 \\
        python -m generativeaiexamples_tpu_torch.serving --model-size 8b

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
from generativeaiexamples_tpu_torch.models import bert, llama
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


def build_engine(model_size: str = "8b", device: DeviceLike = None,
                 seed: int = 0, warmup: bool = True, engine_cfg: Any = None,
                 n_pages: Optional[int] = None) -> LLMEngine:
    """Random-init model of the named geometry (in its own dtype: f32
    for tiny, bf16 otherwise), drawn from `seed`, on `device` (CUDA
    unless asked otherwise), quantized to weight-only int8 when
    `engine_cfg.quantize_weights` is "int8" (as the JAX launcher does
    with no checkpoint), wrapped in an LLMEngine at `engine_cfg`
    (default: the default EngineConfig) with `n_pages` pool pages
    (default: the engine's sizing) and warmed up (not started)."""
    dev = resolve_device(device)
    ecfg = EngineConfig.coerce(engine_cfg)
    cfg = GEOMETRIES[model_size]()
    logging.warning("no checkpoint loading yet (ROADMAP A.10): random-init "
                    "%s model, seed %d, on %s", model_size, seed, dev)
    params = llama.init_params(
        cfg, dev, torch.Generator(device=dev).manual_seed(seed))
    if ecfg.quantize_weights == "int8":
        params = quantize_llama_params(params, dev)
    engine = LLMEngine(params, cfg, load_tokenizer("byte"), ecfg,
                       n_pages=n_pages, device=dev)
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


def build_encoders(device: DeviceLike = None, seed: int = 1
                   ) -> Tuple[EmbeddingEngine, RerankEngine]:
    """Random-init embedder (seed) and reranker (seed + 1) on `device`
    (CUDA unless asked otherwise) at `default_encoder_size(device)`, with
    the byte tokenizer."""
    dev = resolve_device(device)
    ecfg, rcfg = (make() for make in
                  ENCODER_GEOMETRIES[default_encoder_size(dev)])
    tk = load_tokenizer("byte")
    emb = EmbeddingEngine(
        bert.init_params(ecfg, dev, torch.Generator(dev).manual_seed(seed)),
        ecfg, tk, device=dev)
    rr = RerankEngine(
        bert.init_params(rcfg, dev,
                         torch.Generator(dev).manual_seed(seed + 1)),
        rcfg, tk, device=dev)
    return emb, rr


def main() -> None:
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.serving.openai_server import (
        OpenAIServer, run_server)

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--model-size", default="8b", choices=sorted(GEOMETRIES))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--model-name", default="llama3-8b-instruct",
                    help="served model id")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    engine_cfg = load_config().engine
    emb, rr = build_encoders(args.device)
    engine = build_engine(args.model_size, args.device,
                          engine_cfg=engine_cfg).start()
    logging.info("engine server on %s:%d (device %s)", args.host, args.port,
                 engine.device)
    try:
        run_server(OpenAIServer(engine, emb, rr, model_name=args.model_name),
                   args.host, args.port)
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
