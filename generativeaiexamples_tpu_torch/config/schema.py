"""Engine configuration for the port's serving slice.

The port's own copy of the slice of generativeaiexamples_tpu's
`EngineConfig` (config/schema.py) that this package honours, with the
same defaults. Flags of the JAX engine that the port does not have yet
are listed in `UNSUPPORTED` with the ROADMAP item that brings them;
`EngineConfig.coerce` refuses any of them set away from its default.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Tuple


@dataclass(frozen=True)
class EngineConfig:
    dtype: str = "bfloat16"       # model weights / activations
    kv_dtype: str = "bfloat16"    # page pool; int8 waits for ROADMAP A.12
    max_batch_size: int = 8
    max_seq_len: int = 8192
    page_size: int = 128          # tokens per KV page
    prefill_buckets: Tuple[int, ...] = (128, 512, 1024, 2048, 4096)
    # Largest number of admissions batched into one prefill dispatch
    # (0 = max_batch_size).
    max_prefill_group: int = 64
    decode_steps_per_dispatch: int = 8
    # Decode blocks kept in flight ahead of the host's read of the oldest.
    pipeline_depth: int = 2
    # First tokens are sampled inside the prefill dispatch. The port has
    # only that form (the chunked-prefill finish tails it also covers in
    # the JAX engine are not ported yet), so False is refused.
    fused_sampling: bool = True

    @staticmethod
    def coerce(cfg: Any = None) -> "EngineConfig":
        """An EngineConfig from None, an EngineConfig, a mapping, or any
        object with the JAX engine config's attributes. Raises ValueError
        naming the ROADMAP item for a flag this port does not support."""
        if cfg is None:
            return EngineConfig()
        if isinstance(cfg, EngineConfig):
            out = cfg
        else:
            get = (cfg.get if isinstance(cfg, Mapping)
                   else lambda k, d=None: getattr(cfg, k, d))
            for name, (default, item) in UNSUPPORTED.items():
                value = get(name, default)
                if value != default:
                    raise ValueError(
                        f"engine.{name}={value!r} is not supported by the "
                        f"PyTorch port yet ({item})")
            known = {f.name for f in dataclasses.fields(EngineConfig)}
            if isinstance(cfg, Mapping):
                unknown = set(cfg) - known - set(UNSUPPORTED)
                if unknown:
                    raise ValueError(f"unknown engine config keys {unknown}")
            kw = {n: get(n) for n in known if get(n) is not None}
            if "prefill_buckets" in kw:
                kw["prefill_buckets"] = tuple(kw["prefill_buckets"])
            out = EngineConfig(**kw)
        if out.kv_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"engine.kv_dtype={out.kv_dtype!r}: only "
                             f"bfloat16/float32 pools are ported (int8 KV "
                             f"is ROADMAP A.12)")
        if out.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"engine.dtype={out.dtype!r}: bfloat16 or "
                             f"float32")
        if not out.fused_sampling:
            raise ValueError("engine.fused_sampling=False (the unfused "
                             "finish tails) is not ported; they come with "
                             "chunked prefill (ROADMAP A.7)")
        return out


# JAX EngineConfig flags outside this slice: name -> (default, where the
# port will gain it).
UNSUPPORTED = {
    "weights_path": ("", "ROADMAP A.10: HF checkpoint loading"),
    "quantize_weights": ("none", "ROADMAP A.12: int8 weights"),
    "speculative_k": (0, "ROADMAP A.13: speculation"),
    "speculative_tree_branches": (0, "ROADMAP A.13: speculation"),
    "step_plans": (False, "ROADMAP A.14: step plans"),
    "fused_prefill": (False, "ROADMAP A.14: fused prefill"),
    "prefix_cache": (False, "ROADMAP A.15: prefix cache"),
    "kv_pager": (False, "ROADMAP A.15: KV pager"),
    "qos": (False, "ROADMAP A.16: QoS"),
    "multihost": (False, "ROADMAP A.17: multi-host"),
    "auto_pool_pages": (False, "ROADMAP A.17: memory planner"),
}
