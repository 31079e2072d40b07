"""The engine's decode blocks captured as CUDA graphs, on one CUDA device.

The JAX package has no file of this name: there `jax.jit` compiles each
step function of generativeaiexamples_tpu/serving/engine_model.py
(`decode_multi_step`, `decode_spec_multi_step`,
`decode_plain_spec_state_multi_step`) once per lattice point, and
`LLMEngine.warmup` compiles the lattice before serving, so a block is one
program launch. This module is the port's counterpart: `LLMEngine.warmup`
captures each decode lattice point it warms as one `torch.cuda.CUDAGraph`,
and `engine_model.plan_step` replays it, so a block costs one graph
launch and one input copy instead of its ~1,580 host launches a token.

- One graph per (StepPlan, sampling flags): a plain block per (K, flags),
  a verify block (linear or tree) per K, the sampled fallback's plain
  block over a speculative engine's state per K. Riders, chunks and
  prefill stay eager.
- Inputs are static device buffers. The host arrays of a dispatch (page
  tables, lengths, active mask, temperatures, top-p, top-k) are packed
  into one pinned host buffer and copied in with one non-blocking copy;
  the pinned block is held by PyTorch's host allocator until that copy
  has run. The device state (the current token per slot, a speculative
  engine's device lengths) lives in static buffers that each graph reads
  and writes back in place; the token history and the page pool are
  updated in place by the steps themselves.
- The graphs of one engine share one memory pool and are captured on one
  dedicated stream, each after one eager run of the same step on that
  stream: the kernels' one-time attributes and their split tickets
  (`kernels.tickets`, keyed by stream) then exist before the capture, and
  the split workspaces the wrappers allocate come from the graphs' pool,
  so the TMA tensor maps encoded at capture stay valid.
- Launch counts stay honest: `kernels.LAUNCHES` counts host launches, and
  a capture launches nothing while a replay launches every kernel it
  captured without a call through `kernels.launch`. The capturing
  thread's launches are counted apart (`kernels.capture_launches`) and
  recorded with the graph, and each replay adds them (`add_launches`);
  another engine's thread launching meanwhile counts as it always does.
- A sampled block registers the engine's generator with its graph, so
  every replay draws fresh numbers from it.

A capture that fails raises out of `LLMEngine.warmup`: nothing falls back.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch import kernels
from generativeaiexamples_tpu_torch.serving import engine_model

GREEDY = (True, False, False)
SAMPLED = (False, True, True)

# The packed input fields: (name, numpy dtype, torch dtype, per-row
# count: None for one value a row, "pages" for a page-table row, the
# value of a field the dispatch record lacks: a verify block's record
# has no lengths or sampling arrays). The one-byte field comes last, so
# every 4-byte field's offset is aligned.
_FIELDS = (("tables", np.int32, torch.int32, "pages", 0),
           ("lengths", np.int32, torch.int32, None, 1),
           ("temps", np.float32, torch.float32, None, 0.0),
           ("top_ps", np.float32, torch.float32, None, 1.0),
           ("top_ks", np.int32, torch.int32, None, 0),
           ("active_mask", np.bool_, torch.bool, None, False))


def graph_key(plan: engine_model.StepPlan,
              flags: Optional[Tuple[bool, bool, bool]]):
    """The lattice point of a decode plan: a verify block ignores the
    sampling flags (it is greedy); a plain one has a variant per flag
    set."""
    return plan, (None if plan.spec_k else tuple(bool(f) for f in flags))


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    outputs: Dict[str, torch.Tensor]  # "block", or "targets" and "counts"
    launches: Dict[str, int]          # kernel -> launches a replay makes


class StepGraphs:
    """The captured decode lattice of one engine: `capture` at warmup,
    `replay` behind engine_model.plan_step. `pool`, `history` and the
    generator are the engine's; `last_tokens` and `dev_lengths` are
    copied into static buffers (the attributes of those names) that the
    engine adopts as its own. The pool is held weakly: an engine whose
    pool is dropped frees it, and no graph replays over another pool."""

    def __init__(self, params, cfg, pool, generator: torch.Generator,
                 batch: int, max_pages: int, last_tokens: torch.Tensor,
                 history: Optional[torch.Tensor] = None,
                 dev_lengths: Optional[torch.Tensor] = None):
        dev = last_tokens.device
        if dev.type != "cuda":
            raise ValueError(f"StepGraphs: CUDA graphs need a CUDA engine, "
                             f"not {dev}")
        self.params, self.cfg = params, cfg
        self._pool = weakref.ref(pool)
        self.generator = generator
        self.device = dev
        self.batch, self.max_pages = batch, max_pages
        self.stream = torch.cuda.Stream(dev)
        self.mempool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, _Graph] = {}
        self.capture_s = 0.0
        # The packed inputs: byte offsets, and device views of one buffer.
        self._layout = []
        off = 0
        for name, np_dt, t_dt, per, fill in _FIELDS:
            n = batch * (max_pages if per == "pages" else 1)
            nb = n * np.dtype(np_dt).itemsize
            self._layout.append((name, np_dt, t_dt, per, fill, off, nb))
            off += nb
        self._nbytes = off
        self._inputs = torch.zeros(off, dtype=torch.uint8, device=dev)
        self.views: Dict[str, torch.Tensor] = {}
        for name, _, t_dt, per, _, o, nb in self._layout:
            v = self._inputs[o:o + nb].view(t_dt)
            self.views[name] = v.view(batch, max_pages) if per else v
        self.last_tokens = last_tokens.clone()
        self.history = history
        self.dev_lengths = (dev_lengths.clone() if dev_lengths is not None
                            else None)

    def load_inputs(self, arrays: Dict[str, np.ndarray]) -> None:
        """Pack a dispatch's host arrays into one pinned buffer and copy
        it into the static inputs with one non-blocking copy, queued on
        the current stream."""
        host = torch.empty(self._nbytes, dtype=torch.uint8, pin_memory=True)
        h = host.numpy()
        for name, np_dt, _, _, fill, o, nb in self._layout:
            a = arrays.get(name)
            h[o:o + nb].view(np_dt)[:] = (
                fill if a is None else np.asarray(a, np_dt).reshape(-1))
        self._inputs.copy_(host, non_blocking=True)

    def _body(self, plan: engine_model.StepPlan, flags) -> Dict:
        """One decode block over the static buffers (what a graph holds):
        the step through engine_model._plan_step, then the chained state
        written back into the static state buffers."""
        v = self.views
        kw = dict(pool=self._pool(), last_tokens=self.last_tokens,
                  page_tables=v["tables"], active=v["active_mask"])
        if self.history is not None:
            kw.update(history=self.history, dev_lengths=self.dev_lengths)
        if not plan.spec_k:
            kw.update(lengths=v["lengths"], temperature=v["temps"],
                      top_p=v["top_ps"], top_k=v["top_ks"],
                      generator=self.generator, sampling_flags=flags)
        res = engine_model._plan_step(self.params, self.cfg, plan, **kw)
        self.last_tokens.copy_(res["last_tokens"])
        if "dev_lengths" in res:
            self.dev_lengths.copy_(res["dev_lengths"])
        return {k: res[k] for k in ("block", "targets", "counts")
                if k in res}

    def capture(self, plan: engine_model.StepPlan, flags) -> None:
        """Capture one decode lattice point: the step once eagerly on the
        capture stream over inactive rows (every write lands in sink page
        0), then the same step under capture into this engine's pool. A
        point already captured (a second warmup) is kept as it is."""
        key = graph_key(plan, flags)
        if plan.rider_width or not plan.decode_k:
            raise ValueError(f"StepGraphs: {plan} is not a decode block")
        if key in self.graphs:
            return
        t0 = time.perf_counter()
        self.load_inputs({})  # every row inactive on sink page 0
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self._body(plan, key[1])
        self.stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        if key[1] is not None and not key[1][0]:
            # Each replay then draws from the generator's current offset.
            graph.register_generator_state(self.generator)
        with torch.cuda.stream(self.stream), \
                kernels.capture_launches() as launches:
            # thread_local: other engines of the process (fleet replicas)
            # may launch from their own threads meanwhile.
            graph.capture_begin(pool=self.mempool,
                                capture_error_mode="thread_local")
            try:
                outputs = self._body(plan, key[1])
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.graphs[key] = _Graph(graph, outputs, launches)
        self.capture_s += time.perf_counter() - t0

    def covers(self, plan: engine_model.StepPlan, flags) -> bool:
        return graph_key(plan, flags) in self.graphs

    def replay(self, plan: engine_model.StepPlan, *, pool, last_tokens,
               arrays: Dict[str, np.ndarray], history=None,
               dev_lengths=None, sampling_flags=GREEDY) -> Dict:
        """Replay the graph of (plan, sampling_flags) on the current
        stream: the engine's state copied into the static buffers where
        it is not already them, the host arrays copied in, the graph
        launched and its recorded launches counted. Returns plan_step's
        dict; its tensors are the graph's static buffers (a block's host
        copy must be queued before the next replay, as the engine does)."""
        g = self.graphs[graph_key(plan, sampling_flags)]
        if pool is not self._pool() or history is not self.history:
            raise ValueError("StepGraphs.replay: the pool and history must "
                             "be the ones captured")
        if last_tokens is not self.last_tokens:
            self.last_tokens.copy_(last_tokens)
        if dev_lengths is not None and dev_lengths is not self.dev_lengths:
            self.dev_lengths.copy_(dev_lengths)
        self.load_inputs(arrays)
        g.graph.replay()
        kernels.add_launches(g.launches)
        out = dict(g.outputs, last_tokens=self.last_tokens, pool=pool)
        if self.history is not None:
            out.update(history=self.history, dev_lengths=self.dev_lengths)
        return out

    def pool_bytes(self) -> int:
        """The device bytes this engine's graph pool holds: the caching
        allocator's segments that belong to that pool, on this device
        (no other engine's memory)."""
        pool = tuple(self.mempool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool
                   and seg["device"] == self.device.index)

    def stats(self) -> Dict:
        """Graphs captured, the seconds their captures took (each with its
        eager run) and the device bytes their pool holds."""
        return {"graphs": len(self.graphs), "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes()}
