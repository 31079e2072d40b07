# %% [markdown]
# # 03 — Fine-tuning: SFT, LoRA, retriever customization
#
# The reference ships fine-tuning as NeMo notebooks (models/Gemma etc.);
# here every recipe is a train step of the port's `training/` package,
# through the models' differentiable route (`attention="plain"`), on the
# card unless `--device cpu`. Tiny geometries keep this quick anywhere.

# %%
import argparse
import os
import sys

# __file__ is undefined inside a Jupyter kernel; fall back to cwd.
_here = (os.path.dirname(os.path.abspath(__file__))
         if "__file__" in globals() else os.getcwd())
sys.path.insert(0, os.path.abspath(os.path.join(_here, "..", "..", "..")))

import torch

from generativeaiexamples_tpu_torch.device import resolve_device
from generativeaiexamples_tpu_torch.models import bert, llama
from generativeaiexamples_tpu_torch.training import lora as lora_lib
from generativeaiexamples_tpu_torch.training import retriever_ft as rft
from generativeaiexamples_tpu_torch.training import trainer
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

# The card unless `--device cpu`; without CUDA that raises (no fallback).
# parse_known_args lets a notebook kernel's own argv pass through.
_ap = argparse.ArgumentParser()
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
DEVICE = resolve_device(_ap.parse_known_args()[0].device)


def seeded(seed):
    return torch.Generator(device=DEVICE).manual_seed(seed)


# %% [markdown]
# ## Full SFT step

# %%
cfg = llama.LlamaConfig.tiny()
params = llama.init_params(cfg, DEVICE, seeded(0))
tcfg = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=2)
opt = trainer.make_optimizer(tcfg)
step = trainer.make_train_step(cfg, tcfg, opt)
# Over several cards: trainer.shard_train_state(params, cfg, opt, mesh)
# places params/optimizer with the TP/FSDP specs before stepping.
opt_state = opt.init(params)
batch = trainer.synthetic_batch(cfg, batch=4, seq=16, device=DEVICE)
params, opt_state, metrics = step(params, opt_state, batch)
print("sft loss:", float(metrics["loss"]))

# %% [markdown]
# ## LoRA: adapter-only training, merge for serving

# %%
lcfg = lora_lib.LoraConfig(rank=4, targets=("wq", "wv"))
adapters = lora_lib.init_lora(cfg, lcfg, seeded(1), device=DEVICE)
lopt = trainer.AdamW(1e-2, weight_decay=0.0)  # plain Adam
lstep = lora_lib.make_lora_train_step(cfg, lcfg, lopt)
lopt_state = lopt.init(adapters)
for _ in range(3):
    adapters, lopt_state, m = lstep(adapters, lopt_state, params, batch)
print("lora loss:", float(m["loss"]))
served_params = lora_lib.merge(params, adapters, lcfg)  # LoRA-free serving

# %% [markdown]
# ## Retriever customization (contrastive InfoNCE)

# %%
bcfg = bert.BertConfig.tiny(vocab_size=256)
bparams = bert.init_params(bcfg, DEVICE, seeded(2))
pairs = [("what cards serve llama", "llama serves on h100 cards"),
         ("how big is the memory", "eighty gigabytes of hbm3 per card"),
         ("what links the cards", "nvlink connects cards in a node"),
         ("what compiles kernels", "nvcc compiles custom cuda kernels")]
tuned = rft.finetune(bparams, bcfg, ByteTokenizer(), pairs, epochs=3,
                     batch_size=4,
                     ft=rft.RetrieverFTConfig(learning_rate=1e-3),
                     device=DEVICE)
print("retriever fine-tune done")
