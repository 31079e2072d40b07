"""Engine server launcher: `python -m generativeaiexamples_tpu_torch.serving`.

Counterpart of generativeaiexamples_tpu/serving/__main__.py. The config
comes from `load_config()` (the APP_CONFIG_FILE file and
APP_<SECTION>_<FIELD> variables):

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
- `[fleet]` (serving/fleet.py): `fleet.replicas` > 1 builds that many
  engines over ONE weight tree on the card, each with its own pool,
  behind the prefix-locality router; `fleet.replica_urls` adds remote
  engine servers (with `fleet.replicas` 0 the process only routes, with
  no engine and no encoders); `fleet.replica_roles` and `fleet.disagg`
  split prefill and decode across replicas.
- `[mesh]` (parallel/mesh.py): tensor-parallel serving over rank
  processes, one a device. The mesh spans `--devices` (one entry per
  rank; default: every CUDA device of this host, or the one --device);
  JAX's default `ici_tensor=-1` puts them all on the tensor axis, so on
  one card the mesh is one device and nothing changes. A replica fleet,
  which rank processes cannot serve, stays on the first card when
  neither --devices nor a `[mesh]` axis size asks for more, and is
  refused when one does (JAX shards a fleet's replicas over the mesh in
  one process). With more than
  one device and no coordinator, this process is rank 0 and starts the
  follower ranks itself (`spawn`), with `engine.multihost` on. With
  `--coordinator host:port --num-processes N --process-id R` (or
  `mesh.coordinator_address` / `num_processes` / `process_id`, or the
  JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env) each
  rank is started by hand and `engine.multihost=true` is required. Every
  rank loads only its shard; rank 0 runs the scheduler, the encoders and
  the HTTP surface and publishes its dispatch records, the followers
  build no encoders, serve no HTTP and replay them
  (serving/multihost.py) until rank 0 stops (SIGTERM or Ctrl-C). The
  backend is NCCL when every rank has a card of its own, gloo when they
  share one or run on the CPU (`--devices cpu,cpu`).
- `ENGINE_WARMUP=0` skips the engine warmup (the JAX launcher's knob);
  it must match across ranks (warmup's collectives pair up too). The
  server warms as the JAX launcher does (`serving_warmup_kw`): the
  sampled variants too, and the long-prompt lattice (chunk widths, the
  fused rider) with `ENGINE_WARMUP_LONG=1`. A warmed engine dispatches
  only the shapes it warmed; on one card its decode blocks replay as
  CUDA graphs (serving/step_graphs.py).

    APP_ENGINE_WEIGHTSPATH=/models/llama3-8b-instruct \\
        python -m generativeaiexamples_tpu_torch.serving
    APP_ENGINE_WEIGHTSPATH=/models/llama3-8b-instruct \\
        APP_FLEET_REPLICAS=2 APP_ENGINE_PREFIXCACHE=true \\
        APP_FLEET_REPLICAROLES=prefill,decode APP_FLEET_DISAGG=true \\
        python -m generativeaiexamples_tpu_torch.serving
    APP_ENGINE_WEIGHTSPATH=/models/llama3-8b-instruct \\
        APP_ENGINE_QUANTIZEWEIGHTS=int8 APP_ENGINE_KVDTYPE=int8 \\
        APP_EMBEDDINGS_WEIGHTSPATH=/models/arctic-embed-l \\
        APP_RERANKER_WEIGHTSPATH=/models/reranker \\
        python -m generativeaiexamples_tpu_torch.serving
    python -m generativeaiexamples_tpu_torch.serving --model-size tiny \\
        --device cpu --port 8099
    python -m generativeaiexamples_tpu_torch.serving --model-size tiny \\
        --devices cpu,cpu --port 8099

Serves /v1/chat/completions, /v1/completions, /v1/embeddings,
/v1/ranking, /v1/models, /health, /metrics, /debug/timeline and
/v1/kv/export, /v1/kv/import on one port.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from generativeaiexamples_tpu_torch.config.schema import (
    AUTO_POOL_SHARED, EngineConfig, MeshConfig)
from generativeaiexamples_tpu_torch.parallel import mesh as mesh_lib
from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.models import bert, hf_loader, llama
from generativeaiexamples_tpu_torch.ops.quant import quantize_llama_params
from generativeaiexamples_tpu_torch.serving.encoders import (
    EmbeddingEngine, RerankEngine)
from generativeaiexamples_tpu_torch.serving import sharding as shd
from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
from generativeaiexamples_tpu_torch.utils.tokenizer import load_tokenizer

GEOMETRIES = {
    # The tiny test geometry's vocabulary covers the byte tokenizer's 259
    # ids (<bos> is 257), so every prompt id has an embedding row, and is
    # even, so a tensor axis of 2 splits it.
    "tiny": lambda: llama.LlamaConfig.tiny(vocab_size=260),
    "1b": llama.LlamaConfig.llama3_2_1b,
    "8b": llama.LlamaConfig.llama3_8b,
}


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def serving_warmup_kw() -> Dict[str, Any]:
    """LLMEngine.warmup's arguments for the server, as the JAX launcher
    passes them: the sampled variants too (temperature > 0 is the API's
    default, so the first real request must find them warm), and the
    long-prompt lattice only with ENGINE_WARMUP_LONG=1."""
    return {"sampled": True,
            "long_prompts": os.environ.get("ENGINE_WARMUP_LONG", "0") == "1"}


def build_engines(model_size: str = "8b", device: DeviceLike = None,
                  seed: int = 0, warmup: bool = True, engine_cfg: Any = None,
                  n_pages: Optional[int] = None, weights_path: str = "",
                  replicas: int = 1,
                  warmup_kw: Optional[Dict[str, Any]] = None
                  ) -> List[LLMEngine]:
    """`replicas` LLMEngines over ONE weight tree (loaded or random, as
    `build_engine` makes it), each with its own pool of `n_pages` pages,
    warmed up with `warmup_kw` (not started): a fleet's local replicas.
    They share the device, so more than one refuses `auto_pool_pages`
    without `n_pages`."""
    if (replicas > 1 and n_pages is None
            and EngineConfig.coerce(engine_cfg).auto_pool_pages):
        raise ValueError(AUTO_POOL_SHARED.format(f"replicas={replicas}"))
    first = build_engine(model_size, device, seed=seed, warmup=warmup,
                         engine_cfg=engine_cfg, n_pages=n_pages,
                         weights_path=weights_path, warmup_kw=warmup_kw)
    out = [first]
    for _ in range(max(1, replicas) - 1):
        eng = LLMEngine(first.params, first.cfg, first.tokenizer, first.ecfg,
                        n_pages=n_pages, device=first.device)
        out.append(eng.warmup(**(warmup_kw or {})) if warmup else eng)
    return out


def build_engine(model_size: str = "8b", device: DeviceLike = None,
                 seed: int = 0, warmup: bool = True, engine_cfg: Any = None,
                 n_pages: Optional[int] = None,
                 weights_path: str = "", mesh=None,
                 warmup_kw: Optional[Dict[str, Any]] = None) -> LLMEngine:
    """An LLMEngine at `engine_cfg` (default: the default EngineConfig)
    on `device` (CUDA unless asked otherwise) with `n_pages` pool pages
    (default: the engine's sizing), warmed up with `warmup_kw` (default:
    LLMEngine.warmup's defaults), not started.

    With `weights_path` (default: `engine_cfg.weights_path`) the HF
    snapshot there is loaded in `engine_cfg.dtype`, weight-only int8
    quantized at load when `engine_cfg.quantize_weights` is "int8", with
    the snapshot's tokenizer (`load_tokenizer`'s gate applies). Without,
    the model is random-init at the named geometry (in its own dtype:
    f32 for tiny, bf16 otherwise), drawn from `seed`, quantized after
    init for int8, with the byte tokenizer.

    With a tensor-parallel `mesh` (parallel/mesh.py) of more than one
    rank, this is the calling rank's engine on its own device: the
    snapshot is loaded sharded, or the random tree drawn whole (the same
    seed on every rank) and cut to the rank's shard; the mesh's tensor
    axis is clamped to the model's dims first (`compatible_mesh`)."""
    if mesh is not None and mesh.size > 1:
        device = mesh.device
    else:
        mesh = None
    dev = resolve_device(device)
    ecfg = EngineConfig.coerce(engine_cfg)
    weights_path = weights_path or ecfg.weights_path
    quantize = ecfg.quantize_weights == "int8"
    if weights_path:
        cfg = hf_loader.llama_config_from_hf(weights_path)
        if mesh is not None:
            mesh = shd.compatible_mesh(cfg, mesh)
        params, cfg = hf_loader.load_llama(
            weights_path, cfg=cfg, device=dev, dtype=DTYPES[ecfg.dtype],
            quantize=quantize, mesh=mesh)
        tokenizer = load_tokenizer(weights_path)
    else:
        cfg = GEOMETRIES[model_size]()
        logging.warning("engine.weights_path empty: random-init %s model, "
                        "seed %d, on %s", model_size, seed, dev)
        params = llama.init_params(
            cfg, dev, torch.Generator(device=dev).manual_seed(seed))
        if quantize:
            params = quantize_llama_params(params, dev)
        if mesh is not None:
            mesh = shd.compatible_mesh(cfg, mesh)
            params = shd.shard_llama_params(params, cfg, mesh)
        tokenizer = load_tokenizer("byte")
    engine = LLMEngine(params, cfg, tokenizer, ecfg, n_pages=n_pages,
                       device=dev, mesh=mesh)
    return engine.warmup(**(warmup_kw or {})) if warmup else engine


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


def build_llm(config, model_size: str = "8b", device: DeviceLike = None,
              warmup: bool = True):
    """The LLM surface the server fronts, from the config, warmed as the
    server warms (`serving_warmup_kw`): one started
    LLMEngine, or with `fleet.replicas` > 1 or `fleet.replica_urls` a
    started EngineFleet (`fleet.replicas` 0 with URLs: router-only, the
    tokenizer from `engine.weights_path` or the byte tokenizer). A fleet's
    autoscaler spawns engines over the same weight tree on the same
    device, or engine-server processes at the same model size and
    device."""
    from generativeaiexamples_tpu_torch.serving.fleet import build_fleet

    urls = (config.fleet.replica_urls or "").strip()
    if urls and config.fleet.replicas <= 0:
        wp = config.engine.weights_path
        tokenizer = load_tokenizer(wp) if wp else load_tokenizer("byte")
        fleet = build_fleet(config, engines=None, tokenizer=tokenizer)
        logging.info("router-only fleet over %s", urls)
        return fleet.start()
    n = max(1, config.fleet.replicas)
    if n > 1 or urls:
        engines = build_engines(model_size, device, warmup=warmup,
                                engine_cfg=config.engine, replicas=n,
                                warmup_kw=serving_warmup_kw())
        first = engines[0]

        def engine_factory() -> LLMEngine:
            # The autoscaler's spawn lane: one more engine over the same
            # weight tree on the same device (its own pool and thread).
            return LLMEngine(first.params, first.cfg, first.tokenizer,
                             first.ecfg, device=first.device)

        return build_fleet(
            config, engines=engines, engine_factory=engine_factory,
            spawn_kw={"model_size": model_size,
                      "device": str(first.device.type)}).start()
    return build_engine(model_size, device, warmup=warmup,
                        engine_cfg=config.engine,
                        warmup_kw=serving_warmup_kw()).start()


MULTIHOST_FLEET = (
    "engine.multihost=true serves ONE engine spanning all hosts "
    "behind rank 0; it cannot combine with a replica fleet "
    "(fleet.replicas={}, replica_urls={!r}). Run fleets as separate "
    "single-slice processes, or drop fleet config for multi-host.")


MESH_FLEET = (
    "a mesh of {} devices serves ONE engine over rank processes behind "
    "rank 0; it cannot combine with a replica fleet (fleet.replicas={}, "
    "replica_urls={!r}). Serve the fleet on one device (--device cuda:0, "
    "with no --devices and no [mesh] axis sizes), or drop the fleet "
    "config for tensor-parallel serving.")


def _has_fleet(config) -> bool:
    return config.fleet.replicas > 1 or bool(
        (config.fleet.replica_urls or "").strip())


def check_mesh_config(config, n_devices: int) -> None:
    """The JAX launcher's refusal of engine.multihost beside a replica
    fleet, and the port's own of a mesh of more than one device beside
    one (the port serves a mesh over rank processes, one engine behind
    rank 0)."""
    if not _has_fleet(config):
        return
    urls = (config.fleet.replica_urls or "").strip()
    if config.engine.multihost:
        raise ValueError(MULTIHOST_FLEET.format(config.fleet.replicas, urls))
    if n_devices > 1:
        raise ValueError(MESH_FLEET.format(n_devices, config.fleet.replicas,
                                           urls))


def mesh_devices(device: DeviceLike = None, devices: str = "",
                 config=None) -> List[str]:
    """The mesh's devices, one per rank: `devices` ("cuda:0,cuda:1",
    "cpu,cpu", ...), else the one `device`, else every CUDA device of
    this host. With `config`, that default holds only where rank
    processes can serve it: a replica fleet with the [mesh] defaults and
    engine.multihost off serves on the first device, as the launcher did
    before it had a mesh, and the log says why. An explicit mesh is held
    to the rules (check_mesh_config, the engine's
    validate_multihost_profile)."""
    if devices:
        return [d.strip() for d in devices.split(",") if d.strip()]
    if device is not None:
        return [str(resolve_device(device))]
    local = [str(d) for d in mesh_lib.local_devices()]
    if (len(local) > 1 and config is not None
            and not config.engine.multihost
            and dataclasses.replace(config.mesh, coordinator_address="",
                                    num_processes=0, process_id=-1)
            == MeshConfig()):
        if _has_fleet(config):
            logging.info("serving on %s alone, not a mesh of the %d local "
                         "devices: a replica fleet serves its engines on "
                         "one device", local[0], len(local))
            return local[:1]
    return local


def free_coordinator() -> str:
    """A coordinator address on this host with a free port."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sock.getsockname()[1]}"


def with_mesh_process(config, coordinator: str, n: int, rank: int):
    """`config` with the mesh's coordinator and this rank's id set, and
    replay on (rank processes of one engine)."""
    return dataclasses.replace(
        config,
        mesh=dataclasses.replace(config.mesh, coordinator_address=coordinator,
                                 num_processes=n, process_id=rank),
        engine=dataclasses.replace(config.engine, multihost=True))


def run_rank(config, devices: Sequence[str], model_size: str = "8b",
             host: str = "0.0.0.0", port: int = 8000,
             model_name: str = "llama3-8b-instruct",
             warmup: bool = True) -> None:
    """One rank process of a tensor-parallel engine (the process group
    already up): build the mesh and this rank's engine (warmed up on
    every rank: warmup's collectives pair up too). Rank 0 starts it
    behind the OpenAI server with the encoders; a follower replays rank
    0's dispatch records until the stop record. Tears the process group
    down at the end."""
    from generativeaiexamples_tpu_torch.serving.multihost import run_follower
    from generativeaiexamples_tpu_torch.serving.openai_server import (
        OpenAIServer, run_server)

    mesh = mesh_lib.build_mesh(config.mesh, devices)
    try:
        engine = build_engine(model_size, warmup=warmup,
                              engine_cfg=config.engine, mesh=mesh,
                              warmup_kw=serving_warmup_kw())
        if mesh.rank != 0:
            logging.info("rank %d/%d: follower replay loop (rank 0 serves "
                         "the OpenAI surface)", mesh.rank, mesh.size)
            try:
                run_follower(engine)
            finally:
                engine.stop()
            return
        emb, rr = build_encoders(
            mesh.device, embed_path=config.embeddings.weights_path,
            rerank_path=config.reranker.weights_path,
            random_init=not config.engine.weights_path)
        engine.start()
        logging.info("engine server on %s:%d (rank 0 of %d, mesh %s, %s)",
                     host, port, mesh.size, mesh.shape, mesh.backend)
        try:
            run_server(OpenAIServer(engine, emb, rr, model_name=model_name,
                                    serving_cfg=config.serving), host, port)
        finally:
            engine.stop()
    finally:
        mesh_lib.shutdown()


def _follower_main(config, devices, model_size, warmup) -> None:
    """A spawned follower rank: join the process group, then run_rank."""
    logging.basicConfig(level=logging.INFO)
    m = config.mesh
    mesh_lib.init_ranks(m.coordinator_address, m.num_processes,
                        m.process_id, devices)
    run_rank(config, devices, model_size, warmup=warmup)


def spawn_followers(config, devices: Sequence[str], model_size: str,
                    warmup: bool = True) -> list:
    """Start ranks 1..n-1 of a local mesh as child processes (`spawn`:
    CUDA needs a fresh interpreter), each with its process id set; the
    caller is rank 0 and `config` already names the coordinator."""
    import importlib
    import multiprocessing as mp

    # The entry point by its module's own name: run as `python -m`, this
    # module is __main__, which a spawned child cannot look it up in.
    entry = importlib.import_module(
        "generativeaiexamples_tpu_torch.serving.__main__")._follower_main
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(1, len(devices)):
        cfg = with_mesh_process(config, config.mesh.coordinator_address,
                                len(devices), rank)
        p = ctx.Process(target=entry,
                        args=(cfg, list(devices), model_size, warmup),
                        name=f"gaie-rank{rank}")
        p.start()
        procs.append(p)
    return procs


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
    ap.add_argument("--devices", default="",
                    help="the mesh's devices, one per rank process "
                         "(e.g. cuda:0,cuda:1 or cpu,cpu; default: every "
                         "CUDA device, or the one --device)")
    ap.add_argument("--coordinator", default="",
                    help="rank-0 address host:port of the rank processes "
                         "(overrides mesh.coordinator_address)")
    ap.add_argument("--num-processes", type=int, default=0,
                    help="total rank processes (overrides "
                         "mesh.num_processes)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank, 0..num_processes-1 "
                         "(overrides mesh.process_id)")
    ap.add_argument("--model-name", default="llama3-8b-instruct",
                    help="served model id")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    config = load_config()
    if args.coordinator or args.num_processes or args.process_id is not None:
        config = dataclasses.replace(config, mesh=dataclasses.replace(
            config.mesh,
            coordinator_address=(args.coordinator
                                 or config.mesh.coordinator_address),
            num_processes=args.num_processes or config.mesh.num_processes,
            process_id=(args.process_id if args.process_id is not None
                        else config.mesh.process_id)))
    warmup = os.environ.get("ENGINE_WARMUP", "1") != "0"
    devices = mesh_devices(args.device, args.devices, config)
    check_mesh_config(config, len(devices))
    if mesh_lib.maybe_initialize_distributed(config.mesh, devices):
        if not config.engine.multihost:
            raise ValueError(
                f"the process group spans {len(devices)} processes but "
                "engine.multihost=false — the ranks would not replay rank "
                "0's dispatches. Set engine.multihost=true (and see "
                "serving/multihost.py for the supported profile), or "
                "launch without a coordinator for single-host serving.")
        run_rank(config, devices, args.model_size, args.host, args.port,
                 args.model_name, warmup)
        return
    if len(devices) > 1:
        # One host, several devices: this process is rank 0 and starts
        # the followers (the counterpart of JAX's single-process mesh).
        config = with_mesh_process(config, free_coordinator(),
                                   len(devices), 0)
        procs = spawn_followers(config, devices, args.model_size, warmup)
        try:
            mesh_lib.init_ranks(config.mesh.coordinator_address,
                                len(devices), 0, devices)
            run_rank(config, devices, args.model_size, args.host,
                     args.port, args.model_name, warmup)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
        bad = {p.name: p.exitcode for p in procs if p.exitcode != 0}
        if bad:
            raise RuntimeError(f"follower rank processes failed: {bad}")
        return
    router_only = (config.fleet.replicas <= 0
                   and bool(config.fleet.replica_urls.strip()))
    emb = rr = None
    if not router_only:
        emb, rr = build_encoders(
            args.device, embed_path=config.embeddings.weights_path,
            rerank_path=config.reranker.weights_path,
            random_init=not config.engine.weights_path)
    llm = build_llm(config, args.model_size, args.device, warmup=warmup)
    logging.info("engine server on %s:%d (device %s)", args.host, args.port,
                 getattr(llm, "device", None))
    try:
        run_server(OpenAIServer(llm, emb, rr, model_name=args.model_name,
                                serving_cfg=config.serving),
                   args.host, args.port)
    finally:
        llm.stop()


if __name__ == "__main__":
    main()
