"""Engine server launcher: `python -m generativeaiexamples_tpu_torch.serving`.

Counterpart of generativeaiexamples_tpu/serving/__main__.py without
encoders, fleet or multi-host. There are no checkpoints to load yet
(ROADMAP A.10), so the model is random-init at the chosen published
geometry, from seed 0, with the hermetic byte tokenizer — what the JAX
launcher does when `engine.weights_path` is empty.

    python -m generativeaiexamples_tpu_torch.serving --model-size 8b
    python -m generativeaiexamples_tpu_torch.serving --model-size tiny \\
        --device cpu --port 8099

Serves /v1/chat/completions, /v1/completions, /v1/models, /health and
/metrics on one port (/v1/embeddings and /v1/ranking answer 503).
"""

from __future__ import annotations

import argparse
import logging

import torch

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.models import llama
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
                 seed: int = 0, warmup: bool = True) -> LLMEngine:
    """Random-init model of the named geometry (in its own dtype: f32
    for tiny, bf16 otherwise), drawn from `seed`, on `device` (CUDA
    unless asked otherwise), wrapped in an LLMEngine at the default
    engine config and warmed up (not started)."""
    dev = resolve_device(device)
    cfg = GEOMETRIES[model_size]()
    logging.warning("no checkpoint loading yet (ROADMAP A.10): random-init "
                    "%s model, seed %d, on %s", model_size, seed, dev)
    params = llama.init_params(
        cfg, dev, torch.Generator(device=dev).manual_seed(seed))
    engine = LLMEngine(params, cfg, load_tokenizer("byte"), device=dev)
    return engine.warmup() if warmup else engine


def main() -> None:
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
    engine = build_engine(args.model_size, args.device).start()
    logging.info("engine server on %s:%d (device %s)", args.host, args.port,
                 engine.device)
    try:
        run_server(OpenAIServer(engine, model_name=args.model_name),
                   args.host, args.port)
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
