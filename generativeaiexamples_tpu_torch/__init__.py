"""PyTorch / CUDA port of generativeaiexamples_tpu for NVIDIA Hopper.

Mirrors the JAX package path for path (`serving/engine.py` here is the
counterpart of `generativeaiexamples_tpu/serving/engine.py`). It imports
torch and never jax, and nothing of the JAX package. Dense projections
run through torch; every kernel the JAX package wrote in Pallas is a
hand-written CUDA kernel under `csrc/`, built by `kernels.py`.

Entry points run on CUDA unless the caller passes `device="cpu"`; on a
CPU tensor each kernel wrapper runs its plain PyTorch version.
"""
