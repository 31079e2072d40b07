# %% [markdown]
# # 02 — The serving engine on the card
#
# What the reference outsources to NIM/TRT-LLM, driven directly:
# continuous batching, paged KV cache, device-side sampling. On the card
# (the default) the engine serves a bf16 model of Llama-3.2-1B geometry
# (random weights, head_dim 64) through the port's hand-written kernels:
# flash prefill attention (K1, `csrc/flash_attention.cu`) for the
# bucketed and the chunked prefill, paged decode attention (K2,
# `csrc/paged_attention.cu`) for the decode blocks. With `--device cpu`
# it runs the tiny f32 model through the kernels' plain versions, so it
# executes anywhere. The same code serves Llama-3-8B with int8 weights
# (`python -m generativeaiexamples_tpu_torch.serving`; PERF.md has the
# card's numbers).

# %%
import argparse
import os
import sys

# __file__ is undefined inside a Jupyter kernel; fall back to cwd.
_here = (os.path.dirname(os.path.abspath(__file__))
         if "__file__" in globals() else os.getcwd())
sys.path.insert(0, os.path.abspath(os.path.join(_here, "..", "..", "..")))

import torch

from generativeaiexamples_tpu_torch import kernels
from generativeaiexamples_tpu_torch.config.schema import EngineConfig
from generativeaiexamples_tpu_torch.device import resolve_device
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

# The card unless `--device cpu`; without CUDA that raises (no fallback).
# parse_known_args lets a notebook kernel's own argv pass through.
_ap = argparse.ArgumentParser()
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
DEVICE = resolve_device(_ap.parse_known_args()[0].device)

# %% [markdown]
# ## Build and warm an engine
# The kernels take bf16 and a head_dim of 64 or 128, so the card gets a
# bf16 geometry; the CPU the tiny f32 one. `warmup()` runs every
# (bucket, group-size) prefill variant once and, on the card, captures
# each decode K-bucket as a CUDA graph that later blocks replay, so live
# traffic never waits on a first launch; from then on the engine picks
# only the block lengths it warmed. The kernel launch counts the
# metrics print are then zeroed, so they count the served traffic
# alone.

# %%
if DEVICE.type == "cuda":
    cfg = llama.LlamaConfig.llama3_2_1b()
    dtypes = {"dtype": "bfloat16", "kv_dtype": "bfloat16"}
else:
    cfg = llama.LlamaConfig.tiny()
    dtypes = {"dtype": "float32", "kv_dtype": "float32"}
params = llama.init_params(
    cfg, DEVICE, torch.Generator(device=DEVICE).manual_seed(0))
ecfg = EngineConfig(max_batch_size=4, max_seq_len=128, page_size=16,
                    prefill_buckets=(32,), decode_steps_per_dispatch=4,
                    **dtypes)
engine = LLMEngine(params, cfg, ByteTokenizer(), ecfg, device=DEVICE)
engine.warmup()
kernels.reset_launches()
engine.start()

# %% [markdown]
# ## Stream tokens
# `generate_stream` yields per-token events — the same stream the
# OpenAI-compatible server re-emits as SSE.

# %%
for ev in engine.generate_stream([10, 11, 12, 13], max_new_tokens=6):
    print(ev["token_id"], end=" ")
print()

# %% [markdown]
# ## Long prompts: chunked prefill
# Prompts beyond the largest prefill bucket run bucket-size chunks into
# a scratch cache and scatter into pages once — up to the full page
# capacity of the sequence.

# %%
long_prompt = [(i * 3) % cfg.vocab_size for i in range(70)]  # > bucket 32
out = [ev["token_id"] for ev in
       engine.generate_stream(long_prompt, max_new_tokens=4)
       if ev["token_id"] >= 0]
print("long-prompt continuation:", out)

# %%
print("metrics:", engine.metrics.snapshot())
engine.stop()

# %% [markdown]
# ## Speculative decoding
# `speculative_k > 0` turns on greedy self-speculation: an on-device
# n-gram drafter proposes k tokens from the sequence's own history and
# ONE verify forward checks them — up to k+1 committed tokens per
# weight read. Output is exactly the greedy continuation (acceptance
# only changes speed); sampled requests serve through a per-request
# non-speculative fallback plan (they just don't speculate), and
# `speculative_tree_branches` widens the draft into a multi-branch
# tree verified in one step (see docs/architecture.md).

# %%
import dataclasses

spec_engine = LLMEngine(params, cfg, ByteTokenizer(),
                        dataclasses.replace(ecfg, speculative_k=2),
                        device=DEVICE).start()
prompt = [7, 8, 9]
spec_out = [ev["token_id"] for ev in
            spec_engine.generate_stream(prompt, max_new_tokens=12)
            if ev["token_id"] >= 0]
snap = spec_engine.metrics.snapshot()
print("speculative tokens:", spec_out)
print("committed tokens per verify step:",
      round(snap.get("spec_tokens_per_step", 1.0), 2))
spec_engine.stop()

# Equality guarantee: same tokens as the plain greedy engine. (This
# comparison is deterministic on one device and software stack; in bf16
# the verify forward projects a row's k + 1 positions together where
# plain decode projects one, so the GEMMs round differently, and on
# random weights a near-tie between the top two logits could flip a
# token. If this assert ever fails on the card after a toolchain or
# kernel change, check the logit gap at the first divergent position
# before suspecting the engine.)
plain = LLMEngine(params, cfg, ByteTokenizer(), ecfg, device=DEVICE).start()
plain_out = [ev["token_id"] for ev in
             plain.generate_stream(prompt, max_new_tokens=12)
             if ev["token_id"] >= 0]
plain.stop()
print("greedy tokens:", plain_out)
assert spec_out == plain_out, (spec_out, plain_out)
print("speculative == greedy ✓")

# %% [markdown]
# ## Several cards
# Tensor parallelism runs one engine per rank process over a mesh:
# `python -m generativeaiexamples_tpu_torch.serving --devices cuda:0,cuda:1`
# (`serving/sharding.py` cuts the weights; `serving/multihost.py`
# replays rank 0's dispatches on the followers). See
# `tests/test_torch_tp.py`.
