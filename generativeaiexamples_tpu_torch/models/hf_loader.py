"""HF safetensors snapshots -> the port's Llama and BERT parameter trees.

Counterpart of generativeaiexamples_tpu/models/hf_loader.py. The name
tables are the JAX file's; the trees are the ones `models/llama.py` and
`models/bert.py` take (stacked `[L, ...]` layer weights, `[in, out]`
projections, so HF's `[out, in]` linears are transposed).

Loads stream. Each leaf is allocated once, whole, on the device; then
each layer of it is read from the mapped files (`SnapshotReader`) in
chunks of rows of at most `CHUNK_BYTES`, copied through one of two
pinned host buffers (taken in turn, so the host fills one while the
other crosses the bus), and written into its slot on the device, where
the transpose and the cast to the model dtype happen. The host never
holds more than the two buffers, and device memory never more than the
tree plus one chunk and its temporaries. With `quantize=True` the
weight-only int8 leaves (`ops.quant.LLAMA_QUANT_KEYS` and an untied
`lm_head`) are quantized chunk by chunk on the device from the
checkpoint's stored values, with the JAX loader's arithmetic
(`ops.quant.quantize_for_load`): a chunk's rows are whole output
channels, so its scales are those of the whole leaf, and device memory
stays at the int8 tree plus one chunk.

Sharded loads (`mesh`, a tensor-parallel rank): each rank allocates only
its shard of each leaf (`llama.param_specs` at its mesh coordinates,
serving/sharding.py) and reads only the source rows it holds; a leaf
sharded on its input dimension (`wo`, `w_down`: the source's columns)
is read row by row and cut to the rank's columns on the host before the
copy to the device. int8-at-load quantizes such a row-parallel leaf
over its FULL input axis first (the whole source row goes to the
device) and keeps the rank's columns of the codes and every scale, so
each rank's codes and scales are bit-identical to the matching slice of
the single-device int8 tree (the JAX loader's rule).

Unlike the JAX loader, `load_llama` and `load_bert` return the config
with the dtype they loaded in: the port's models compute in `cfg.dtype`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.models import bert as bert_lib
from generativeaiexamples_tpu_torch.models import llama as llama_lib
from generativeaiexamples_tpu_torch.models.safetensors_reader import (
    SnapshotReader)
from generativeaiexamples_tpu_torch.ops.quant import (
    LLAMA_QUANT_KEYS, QuantizedTensor, quantize_for_load)

_LOG = logging.getLogger(__name__)

# Largest host -> device copy: one pinned buffer's size.
CHUNK_BYTES = 8 << 20

# leaf -> (HF name format, transpose). HF linears are [out, in]; ours
# [in, out].
_LLAMA_LAYER_LEAVES = {
    "ln1": ("model.layers.{}.input_layernorm.weight", False),
    "ln2": ("model.layers.{}.post_attention_layernorm.weight", False),
    "wq": ("model.layers.{}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{}.self_attn.o_proj.weight", True),
    "w_gate": ("model.layers.{}.mlp.gate_proj.weight", True),
    "w_up": ("model.layers.{}.mlp.up_proj.weight", True),
    "w_down": ("model.layers.{}.mlp.down_proj.weight", True),
}

_BERT_LAYER_LEAVES = {
    "wq": ("attention.self.query.weight", True),
    "bq": ("attention.self.query.bias", False),
    "wk": ("attention.self.key.weight", True),
    "bk": ("attention.self.key.bias", False),
    "wv": ("attention.self.value.weight", True),
    "bv": ("attention.self.value.bias", False),
    "wo": ("attention.output.dense.weight", True),
    "bo": ("attention.output.dense.bias", False),
    "ln1_w": ("attention.output.LayerNorm.weight", False),
    "ln1_b": ("attention.output.LayerNorm.bias", False),
    "w_in": ("intermediate.dense.weight", True),
    "b_in": ("intermediate.dense.bias", False),
    "w_out": ("output.dense.weight", True),
    "b_out": ("output.dense.bias", False),
    "ln2_w": ("output.LayerNorm.weight", False),
    "ln2_b": ("output.LayerNorm.bias", False),
}


# -- sources ---------------------------------------------------------------


def _cpu_tensor(a: Any) -> torch.Tensor:
    """A state dict's value (torch tensor or numpy array, bf16 as
    `ml_dtypes.bfloat16`) as a CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr.view(np.int16))).view(
            torch.bfloat16)
    # A copy: JAX hands over read-only views of its buffers.
    return torch.from_numpy(np.array(arr))


class _DictSource:
    """A name -> tensor mapping read like a snapshot."""

    def __init__(self, sd: Mapping[str, Any]):
        self._sd = {k: _cpu_tensor(v) for k, v in sd.items()}

    def keys(self):
        return iter(self._sd)

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._sd[name].shape)

    def read(self, name: str, rows: Optional[slice] = None) -> torch.Tensor:
        t = self._sd[name]
        return t if rows is None else t[rows]


def read_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of an HF snapshot directory, name -> CPU tensor in its
    stored dtype over the mapped files (no bytes copied)."""
    reader = SnapshotReader(path)
    return {name: reader.read(name) for name in reader.keys()}


# -- streaming -------------------------------------------------------------


class _Stager:
    """Source rows onto the device. On the card each copy goes through
    one of two pinned buffers, taken in turn: the host fills one while the
    other's copy to the card is in flight, and waits for a buffer's
    earlier copy to land before refilling it. On the CPU the rows are
    used where they lie."""

    def __init__(self, device: torch.device):
        self.device = device
        self._cuda = device.type == "cuda"
        self._bufs: List[torch.Tensor] = [
            torch.empty(CHUNK_BYTES, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)] if self._cuda else []
        self._landed: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0

    def put(self, src: torch.Tensor) -> torch.Tensor:
        if not self._cuda:
            return src
        i, self._turn = self._turn, self._turn ^ 1
        if self._landed[i] is not None:
            self._landed[i].synchronize()
        nbytes = src.numel() * src.element_size()
        if nbytes > self._bufs[i].numel():
            self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8,
                                        pin_memory=True)
        host = self._bufs[i][:nbytes].view(src.dtype).view(src.shape)
        host.copy_(src)
        out = host.to(self.device, non_blocking=True)
        self._landed[i] = torch.cuda.Event()
        self._landed[i].record()
        return out


def _load_leaf(src, stager: _Stager, names: List[str], transpose: bool,
               dtype, stacked: bool, quantize: bool,
               shard: Optional[tuple] = None):
    """One leaf: source tensor `names[l]` is layer l of a stacked leaf
    (or the whole of a flat one), transposed when `transpose`, cast to
    `dtype`, or quantized to int8 codes and f32 scales per output channel
    when `quantize` (transposed leaves only: a source row is one output
    channel). Written chunk by chunk into tensors allocated once on the
    stager's device. `shard` is the slice of each dimension of one
    layer's leaf (our layout) that this rank holds (default: all)."""
    if quantize and not transpose:
        raise ValueError(f"{names[0]}: only [out, in] linears quantize")
    src_shape = src.shape(names[0])
    if transpose and len(src_shape) != 2:
        raise ValueError(f"{names[0]}: shape {src_shape} is not a matrix")
    # The rank's rows and (2-D sources) columns, in source coordinates.
    if shard is None:
        shard = tuple(slice(0, n) for n in src_shape[::-1 if transpose
                                                     else 1])
    src_sl = shard[::-1] if transpose else shard
    rows = src_sl[0]
    cols = src_sl[1] if len(src_shape) == 2 else None
    cut = cols is not None and (cols.start, cols.stop) != (0, src_shape[1])
    src_shard = tuple(sl.stop - sl.start for sl in src_sl)
    shape = src_shard[::-1] if transpose else src_shard
    full = ((len(names),) + shape) if stacked else shape
    dev = stager.device
    if quantize:
        q = torch.empty(full, dtype=torch.int8, device=dev)
        s = torch.empty(full[:-2] + full[-1:], dtype=torch.float32,
                        device=dev)
    else:
        out = torch.empty(full, dtype=dtype, device=dev)
    row_elems = int(np.prod(src_shape[1:], dtype=np.int64))
    for layer, name in enumerate(names):
        if src.shape(name) != src_shape:
            raise ValueError(f"{name}: shape {src.shape(name)}, but "
                             f"{names[0]} has {src_shape}")
        row_bytes = row_elems * src.read(name).element_size()
        step = max(1, CHUNK_BYTES // max(1, row_bytes))
        for r0 in range(rows.start, rows.stop, step):
            host = src.read(name, slice(r0, min(r0 + step, rows.stop)))
            if cut and not quantize:
                # The rank's columns only cross to the device; a
                # quantized leaf takes whole rows (its scales are over
                # the full input axis) and keeps its columns after.
                host = host[:, cols]
            x = stager.put(host)
            a, b = r0 - rows.start, r0 - rows.start + x.shape[0]
            if quantize:
                part = quantize_for_load(x, contract_axis=-1)
                codes = part.q[:, cols] if cut else part.q
                (q[layer] if stacked else q)[:, a:b].copy_(codes.t())
                (s[layer] if stacked else s)[a:b].copy_(part.s)
            elif transpose:
                (out[layer] if stacked else out)[:, a:b].copy_(x.t())
            else:
                (out[layer] if stacked else out)[a:b].copy_(x)
    return QuantizedTensor(q, s) if quantize else out


def _stream_tree(src, leaves, device: torch.device, dtype,
                 progress: Optional[Callable[[str, int, int], None]],
                 label: str, shards: Optional[Callable] = None
                 ) -> Dict[str, Any]:
    """Load `leaves` [(key path, source names, transpose, stacked,
    quantize)] into a nested dict, leaf by leaf. `shards(path, shape)`
    gives the slices of one layer's leaf (our layout) a rank holds."""
    stager = _Stager(device)
    tree: Dict[str, Any] = {}
    placed = 0
    for i, (path, names, transpose, stacked, quantize) in enumerate(leaves):
        shard = None
        if shards is not None:
            src_shape = src.shape(names[0])
            shard = shards(path, src_shape[::-1] if transpose
                           else src_shape)
        val = _load_leaf(src, stager, names, transpose, dtype, stacked,
                         quantize, shard)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
        placed += (val.q.nbytes + val.s.nbytes if quantize else val.nbytes)
        if progress is not None:
            progress(path[-1], i + 1, len(leaves))
        else:
            _LOG.info("stream-load %s: leaf %d/%d (%s, %s bytes placed so "
                      "far)", label, i + 1, len(leaves), path[-1],
                      f"{placed:,}")
    return tree


# -- Llama -----------------------------------------------------------------


def llama_config_from_hf(path: str) -> llama_lib.LlamaConfig:
    """LlamaConfig from an HF snapshot's config.json (bf16)."""
    with open(os.path.join(path, "config.json")) as fh:
        c = json.load(fh)
    rs = c.get("rope_scaling") or None
    scaling = None
    if rs is not None:
        rope_type = rs.get("rope_type", rs.get("type"))
        if rope_type != "llama3":
            raise ValueError(
                f"unsupported rope_scaling type {rope_type!r} in {path}; "
                "only llama3-style frequency scaling is implemented"
            )
        scaling = llama_lib.RopeScaling(
            factor=float(rs["factor"]),
            low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            original_max_position_embeddings=int(
                rs.get("original_max_position_embeddings", 8192)),
        )
    return llama_lib.LlamaConfig(
        vocab_size=c["vocab_size"],
        dim=c["hidden_size"],
        n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c.get("num_key_value_heads", c["num_attention_heads"]),
        head_dim=c.get("head_dim", c["hidden_size"] // c["num_attention_heads"]),
        mlp_dim=c["intermediate_size"],
        rope_theta=c.get("rope_theta", 10000.0),
        rms_eps=c.get("rms_norm_eps", 1e-5),
        max_seq_len=c.get("max_position_embeddings", 8192),
        tie_embeddings=c.get("tie_word_embeddings", False),
        rope_scaling=scaling,
    )


def _llama_leaves(cfg: llama_lib.LlamaConfig, quantize: bool):
    leaves = [(("tok_emb",), ["model.embed_tokens.weight"], False, False,
               False),
              (("ln_f",), ["model.norm.weight"], False, False, False)]
    for leaf, (fmt, transpose) in _LLAMA_LAYER_LEAVES.items():
        leaves.append((("layers", leaf),
                       [fmt.format(i) for i in range(cfg.n_layers)],
                       transpose, True, quantize and leaf in LLAMA_QUANT_KEYS))
    if not cfg.tie_embeddings:
        leaves.append((("lm_head",), ["lm_head.weight"], True, False,
                       quantize))
    return leaves


def llama_params_from_state_dict(sd: Mapping[str, Any],
                                 cfg: llama_lib.LlamaConfig, dtype=None,
                                 device: DeviceLike = None
                                 ) -> Dict[str, Any]:
    """HF LlamaForCausalLM state dict (torch tensors or numpy arrays) ->
    the port's tree in `dtype` (default cfg.dtype) on `device` (CUDA
    unless the caller asks for the CPU)."""
    return _stream_tree(_DictSource(sd), _llama_leaves(cfg, False),
                        resolve_device(device), dtype or cfg.dtype,
                        progress=lambda *a: None, label="state dict")


def _llama_shards(cfg: llama_lib.LlamaConfig, mesh):
    """shards(path, shape) for `_stream_tree`: one layer's slices of each
    leaf at this rank's mesh coordinates (`llama.param_specs`)."""
    from generativeaiexamples_tpu_torch.serving.sharding import (
        shard_slices, validate_tp)

    validate_tp(cfg, mesh)
    specs = llama_lib.param_specs(cfg)

    def shards(path, shape):
        spec = specs[path[0]] if len(path) == 1 else specs[path[0]][path[1]]
        if len(path) > 1:
            spec = spec[1:]  # stacked: one layer's dimensions
        return shard_slices(shape, spec, mesh)

    return shards


def stream_load_llama(path: str, cfg: llama_lib.LlamaConfig,
                      device: DeviceLike = None, dtype=None,
                      quantize: bool = False,
                      progress: Optional[Callable[[str, int, int], None]]
                      = None, mesh=None) -> Dict[str, Any]:
    """Layer-streaming HF Llama load onto `device` (CUDA unless the caller
    asks for the CPU) in `dtype` (default cfg.dtype), weight-only int8
    when `quantize`; with a tensor-parallel `mesh` of more than one rank,
    this rank's shard only. `progress(leaf, i, total)` fires after each
    placed leaf (default: one log line each)."""
    shards = (_llama_shards(cfg, mesh)
              if mesh is not None and mesh.size > 1 else None)
    return _stream_tree(SnapshotReader(path), _llama_leaves(cfg, quantize),
                        resolve_device(device), dtype or cfg.dtype,
                        progress, os.path.basename(path.rstrip("/")),
                        shards=shards)


def load_llama(path: str, cfg: Optional[llama_lib.LlamaConfig] = None,
               device: DeviceLike = None, dtype=None, quantize: bool = False,
               progress=None, mesh=None
               ) -> Tuple[Dict[str, Any], llama_lib.LlamaConfig]:
    """Load an HF Llama snapshot through the streaming path: (params, cfg
    with the dtype loaded in; the whole model's config, also when `mesh`
    makes the params this rank's shard)."""
    cfg = cfg or llama_config_from_hf(path)
    dtype = dtype or cfg.dtype
    params = stream_load_llama(path, cfg, device=device, dtype=dtype,
                               quantize=quantize, progress=progress,
                               mesh=mesh)
    return params, dataclasses.replace(cfg, dtype=dtype)


# -- BERT ------------------------------------------------------------------


def bert_config_from_hf(path: str, n_labels: int = 0) -> bert_lib.BertConfig:
    with open(os.path.join(path, "config.json")) as fh:
        c = json.load(fh)
    return bert_lib.BertConfig(
        vocab_size=c["vocab_size"],
        dim=c["hidden_size"],
        n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"],
        mlp_dim=c["intermediate_size"],
        max_position=c.get("max_position_embeddings", 512),
        type_vocab_size=c.get("type_vocab_size", 2),
        ln_eps=c.get("layer_norm_eps", 1e-12),
        n_labels=n_labels,
    )


def _bert_tree(src, cfg: bert_lib.BertConfig, device: torch.device,
               dtype) -> Dict[str, Any]:
    """HF BertModel names (bare "embeddings..." or prefixed
    "bert.embeddings...") -> the port's BERT tree."""
    names = {k: k for k in src.keys()}
    if not any(k.startswith("embeddings.") for k in names):
        names = {re.sub(r"^bert\.", "", k): k for k in names}
    if cfg.n_labels and "classifier.weight" not in names:
        raise ValueError(
            f"config requests n_labels={cfg.n_labels} (cross-encoder head) "
            "but checkpoint has no classifier.weight — this is an embedding "
            "checkpoint, not a reranker"
        )

    def flat(path, name, transpose=False):
        return (path, [names[name]], transpose, False, False)

    leaves = [flat(("tok_emb",), "embeddings.word_embeddings.weight"),
              flat(("pos_emb",), "embeddings.position_embeddings.weight"),
              flat(("type_emb",), "embeddings.token_type_embeddings.weight"),
              flat(("emb_ln", "w"), "embeddings.LayerNorm.weight"),
              flat(("emb_ln", "b"), "embeddings.LayerNorm.bias")]
    for leaf, (suffix, transpose) in _BERT_LAYER_LEAVES.items():
        leaves.append((("layers", leaf),
                       [names[f"encoder.layer.{i}.{suffix}"]
                        for i in range(cfg.n_layers)], transpose, True,
                       False))
    if cfg.n_labels:
        if "pooler.dense.weight" in names:
            leaves.append(flat(("classifier", "pool_w"),
                               "pooler.dense.weight", True))
        if "pooler.dense.bias" in names:
            leaves.append(flat(("classifier", "pool_b"),
                               "pooler.dense.bias"))
        leaves += [flat(("classifier", "w"), "classifier.weight", True),
                   flat(("classifier", "b"), "classifier.bias")]
    params = _stream_tree(src, leaves, device, dtype,
                          progress=lambda *a: None, label="bert")
    if cfg.n_labels:
        # A checkpoint without a pooler: the identity.
        head = params["classifier"]
        head.setdefault("pool_w", torch.eye(cfg.dim, dtype=dtype,
                                            device=device))
        head.setdefault("pool_b", torch.zeros(cfg.dim, dtype=dtype,
                                              device=device))
    return params


def bert_params_from_state_dict(sd: Mapping[str, Any],
                                cfg: bert_lib.BertConfig, dtype=None,
                                device: DeviceLike = None) -> Dict[str, Any]:
    """HF BertModel state dict -> the port's tree in `dtype` (default
    cfg.dtype) on `device` (CUDA unless the caller asks for the CPU)."""
    return _bert_tree(_DictSource(sd), cfg, resolve_device(device),
                      dtype or cfg.dtype)


def load_bert(path: str, cfg: Optional[bert_lib.BertConfig] = None,
              n_labels: int = 0, dtype=None, device: DeviceLike = None
              ) -> Tuple[Dict[str, Any], bert_lib.BertConfig]:
    """Load an HF BERT-family snapshot (embedder: n_labels=0; cross-
    encoder reranker: n_labels=1): (params, cfg with the dtype loaded
    in)."""
    cfg = cfg or bert_config_from_hf(path, n_labels=n_labels)
    dtype = dtype or cfg.dtype
    params = _bert_tree(SnapshotReader(path), cfg, resolve_device(device),
                        dtype)
    return params, dataclasses.replace(cfg, dtype=dtype)
