"""Weights carried across between the JAX package and the port.

Both packages keep the same Llama and BERT parameter trees (stacked
`[L, ...]` layer weights, `[in, out]` projections), so conversion is a
leaf-by-leaf copy. The JAX side hands over `jax.tree.map(np.asarray, params)`; bf16
leaves arrive as `ml_dtypes.bfloat16` numpy arrays, which torch cannot
read directly, so they pass through float32 (exact for bf16).

Weight-only int8 leaves (a quantized tree: the JAX package's registered
`QuantizedTensor` dataclass, which `jax.tree.map` hands over with numpy
`q` and `s`) cross as the port's `QuantizedTensor` with `q` kept int8 and
`s` float32; only the other leaves take the requested dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.ops.quant import QuantizedTensor


def _is_quantized_leaf(a: Any) -> bool:
    """A QuantizedTensor of either package: codes `q` and scales `s`."""
    return hasattr(a, "q") and hasattr(a, "s") and not isinstance(
        a, (np.ndarray, torch.Tensor))


def _leaf_to_torch(a: Any, device: torch.device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    # A copy: JAX hands over read-only views of its buffers.
    return torch.from_numpy(np.array(arr, copy=True)).to(device=device,
                                                        dtype=dtype)


def llama_params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                            dtype=torch.bfloat16) -> Dict[str, Any]:
    """JAX-package Llama params (numpy leaves) -> the port's params."""
    dev = resolve_device(device)

    def leaf(v):
        if isinstance(v, dict):
            return llama_params_from_numpy(v, dev, dtype)
        if _is_quantized_leaf(v):
            return QuantizedTensor(_leaf_to_torch(v.q, dev, torch.int8),
                                   _leaf_to_torch(v.s, dev, torch.float32))
        return _leaf_to_torch(v, dev, dtype)

    return {k: leaf(v) for k, v in tree.items()}


def bert_params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                           dtype=torch.bfloat16) -> Dict[str, Any]:
    """JAX-package BERT params (numpy leaves, split or fused QKV) -> the
    port's params: the same leaf-by-leaf copy as the Llama tree."""
    return llama_params_from_numpy(tree, device, dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).detach().cpu() \
        .numpy()


def llama_params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params -> numpy leaves (bf16 as float32), ready for
    `jax.tree.map(jnp.asarray, ...)` on the JAX side. A QuantizedTensor
    leaf becomes the pair `(q, s)` of int8 and float32 arrays, which the
    caller wraps in the JAX package's QuantizedTensor."""

    def leaf(v):
        if isinstance(v, dict):
            return llama_params_to_numpy(v)
        if isinstance(v, QuantizedTensor):
            return _to_numpy(v.q), _to_numpy(v.s)
        return _to_numpy(v)

    return {k: leaf(v) for k, v in params.items()}


def bert_params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's BERT params (a retriever fine-tune's result included)
    -> numpy leaves, the same leaf-by-leaf copy as the Llama tree."""
    return llama_params_to_numpy(params)


def lora_params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                           dtype=torch.float32) -> Dict[str, Any]:
    """JAX-package LoRA adapters ({target: {"a": [L, in, r], "b": [L, r,
    out]}}, numpy leaves) -> the port's adapters (f32, as `init_lora`
    makes them)."""
    return llama_params_from_numpy(tree, device, dtype)


def lora_params_to_numpy(lora: Dict[str, Any]) -> Dict[str, Any]:
    """The port's LoRA adapters -> numpy leaves for the JAX side."""
    return llama_params_to_numpy(lora)
