"""Weight-only int8 quantization.

Counterpart of generativeaiexamples_tpu/ops/quant.py. Per-output-channel
symmetric int8 (scale = amax / 127 over the input axis) halves the
weight bytes of a bf16 model, and decode reads every weight once per
step, so it is the bytes that decode time follows.

`QuantizedTensor` holds the int8 codes and f32 scales; `mm(x, w)`
dispatches on the leaf type, so model code never branches:

- a plain tensor: `x @ w`;
- a `QuantizedTensor` on CUDA: the K6 kernel (`ops/int8_matmul.py`),
  which widens the codes on chip, so the weights cross device memory as
  int8. In eager PyTorch the JAX package's XLA route (convert, dot,
  scale) would be two kernels, the first writing a bf16 copy of every
  weight on every call. A stacked (3-D) tensor raises: the model slices
  one layer first (`models/llama.layer_weights`);
- a `QuantizedTensor` on the CPU: that XLA route in plain torch,
  `x @ q.to(x.dtype) * s.to(x.dtype)`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.ops.int8_matmul import int8_matmul


@dataclasses.dataclass
class QuantizedTensor:
    q: torch.Tensor  # int8, the shape of the original weight
    s: torch.Tensor  # f32 scale, that shape minus the reduced axis

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def __getitem__(self, layer: int) -> "QuantizedTensor":
        """One layer of a stacked [L, in, out] tensor (the JAX `take`)."""
        return QuantizedTensor(self.q[layer], self.s[layer])


def quantize_tensor(w: torch.Tensor, contract_axis: int = -2
                    ) -> QuantizedTensor:
    """Per-output-channel symmetric int8. For y = x @ w ([in, out]) the
    contraction axis is -2 and the scales are per output column. The
    same arithmetic as the JAX package (f32 amax, clipped at 1e-8, round
    half to even, clip to +-127), so the codes are bit-identical."""
    wf = w.float()
    amax = wf.abs().amax(dim=contract_axis, keepdim=True)
    s = div127(amax).clamp(min=1e-8)
    q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return QuantizedTensor(q, s.squeeze(contract_axis))


def div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 correctly rounded in f32, as numpy and XLA divide. The
    divisor is a tensor on x's device: CUDA divides by a host scalar as a
    product with its reciprocal, which differs in the last bit for some
    values (chip_smoke.py's checkpoint phase counts them), and then so
    can the codes."""
    return x / torch.tensor(127.0, dtype=torch.float32, device=x.device)


def quantize_for_load(w: torch.Tensor, contract_axis: int = -2
                      ) -> QuantizedTensor:
    """The checkpoint loader's per-output-channel int8: the JAX loader's
    arithmetic (`models/hf_loader._quantize_numpy_leaf` there), which
    clips amax at 1e-8 BEFORE dividing by 127, where `quantize_tensor`
    divides first and clips the scale. The two differ on every channel
    whose amax is under 1.27e-6 (an all-zero channel included). `w` is
    the checkpoint's stored values (cast to f32 here, as the loader
    does), never a bf16-rounded copy of f32 ones."""
    wf = w.float()
    amax = wf.abs().amax(dim=contract_axis, keepdim=True).clamp(min=1e-8)
    s = div127(amax)
    q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return QuantizedTensor(q, s.squeeze(contract_axis))


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w where w is a plain tensor or a QuantizedTensor."""
    if not isinstance(w, QuantizedTensor):
        return x @ w
    if x.device.type == "cpu":
        return x @ w.q.to(x.dtype) * w.s.to(x.dtype)
    if w.q.ndim != 2:
        raise ValueError(f"mm: a stacked QuantizedTensor {tuple(w.shape)} "
                         f"reached the K6 kernel; slice one layer first")
    K, M = w.q.shape
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    return int8_matmul(x2, w.q, w.s).reshape(*x.shape[:-1], M)


# Weight names quantized in the Llama parameter tree. The embedding stays
# in the model dtype (a lookup, not a matmul); norms are vectors.
LLAMA_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_stacked(w: torch.Tensor) -> QuantizedTensor:
    """quantize_tensor over [L, in, out], one layer at a time: the f32
    working copy is one layer's matrix, never the whole stack."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32,
                    device=w.device)
    for layer in range(w.shape[0]):
        part = quantize_tensor(w[layer])
        q[layer].copy_(part.q)
        s[layer].copy_(part.s)
    return QuantizedTensor(q, s)


def quantize_llama_params(params: Dict[str, Any],
                          device: DeviceLike = None) -> Dict[str, Any]:
    """Model-dtype Llama tree -> weight-only int8 tree, IN PLACE and leaf
    by leaf: each stacked weight is replaced in `params` as soon as its
    codes exist, so the bf16 stack is freed before the next is quantized
    and the model never holds both forms of one stack (the JAX version
    returns a new tree). `params` must live on `device` (CUDA unless the
    caller asks for the CPU). Returns `params`."""
    dev = resolve_device(device)
    if params["tok_emb"].device.type != dev.type:
        raise ValueError(f"params on {params['tok_emb'].device}, asked to "
                         f"quantize on {dev}")
    layers = params["layers"]
    for key in LLAMA_QUANT_KEYS:
        if not isinstance(layers[key], QuantizedTensor):
            layers[key] = _quantize_stacked(layers[key])
    if "lm_head" in params and not isinstance(params["lm_head"],
                                              QuantizedTensor):
        params["lm_head"] = quantize_tensor(params["lm_head"])
    return params


def is_quantized(params: Dict[str, Any]) -> bool:
    """True when the tree's projections are int8 (quantize_llama_params
    output)."""
    return isinstance(params["layers"]["wq"], QuantizedTensor)
