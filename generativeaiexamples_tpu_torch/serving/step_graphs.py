"""The engine's warmed lattice captured as CUDA graphs, on one CUDA device.

The JAX package has no file of this name: there `jax.jit` compiles each
step function of generativeaiexamples_tpu/serving/engine_model.py once
per lattice point, and `LLMEngine.warmup` compiles the lattice before
serving, so a dispatch is one program launch. This module is the port's
counterpart: `LLMEngine.warmup` captures each lattice point it warms as
one `torch.cuda.CUDAGraph`, and the engine replays it, so a dispatch
costs a graph launch and one input copy instead of its host launches
(~1,580 a decode token at 8B; a prefill group or a chunk one forward's).

Three families, each with a memory pool of its own (`stats()` reports
graphs, replays and pool bytes by family):

- decode: one graph per (StepPlan, sampling flags): a plain block per
  (K, flags), a verify block (linear or tree) per K, the sampled
  fallback's plain block over a speculative engine's state per K.
- prefill: one graph per warmed (bucket, group size N, flags):
  `prefill_batch_step`, the first-token scatter `set_last_tokens` and,
  on a speculative engine, `set_history_rows`. Both scatters take the
  group's slot indices as a device vector and drop padding rows (index
  len(slots)) on the device, so the graph holds them.
- chunk: the chunked lane and the prefix-hit chain. One graph per warmed
  (scratch length, chunk width): `prefill_chunk_step`, and per flags the
  prompt-completing `prefill_chunk_sample_step`; per scratch length the
  hit's gather `pool_to_cache` (seed) and the finish's scatter
  `cache_to_pool` (commit); per flags the commit's first-token sampler
  `sample_token_into` (finish), which reads the last chunk's logits from
  one static buffer every chunk graph writes; on a speculative engine
  the commit's history row (`set_history_rows`, its first token read
  from the slot's current token).

The scratch cache. Every chunk runs in ONE static scratch of the
engine's full length (max_pages x page_size rows; the memory planner's
`long_prefill_scratch` line) plus one sink row, and a prompt of scratch
length S_total uses its first S_total rows (`engine_model.scratch_view`):
views that share the store's memory and its lengths tensor, advanced in
place by each chunk. A chunk dispatches the JAX engine's width even
where it passes S_total (a prefix hit's suffix from the cached length);
its rows past S_total are written to the sink row (`KVCache.store`),
where the JAX scatter drops them, with no host read, so a graph holds
the write. K1 therefore sees exactly the keys a fresh S_total scratch
gives it (its TMA maps are encoded over S_total rows), so replayed and
eager streams are byte-identical by construction, and it loads no key
tile past min(lengths, the causal limit) either way: the alternative, a
max_seq_len view for every width, is as cheap and would be as exact
(K1 splits no key range, so the masked tiles past `lengths` are never
read), but a scratch per warmed length would multiply the memory the
planner reserves once. The cost of the views: one graph per (S_total,
width) instead of one per width. Rows past a prompt's length keep an
earlier prompt's finite values, which K1 and the plain attention weigh
exactly 0, and which decode overwrites before it reads them.

Riders and composed plans have no graph of their own: a plan with a
chunk and a block (`fused_decode_prefill_step`, `fused_spec_prefill_step`)
replays the chunk's graph and then the block's, on one stream. The
chunk draws nothing, so a sampled block draws in the same order as on
the eager path.

- Inputs are static device buffers. A dispatch's host arrays (page
  tables, lengths, active mask, sampling parameters; a group's tokens,
  rows and slot indices; a chunk's tokens, valid count, slot and
  sampling scalars, a hit's or a finish's page row) are packed into one
  pinned host buffer per family and copied in with one non-blocking
  copy; the pinned block is held by PyTorch's host allocator until that
  copy has run. The device state (the current token per slot, a
  speculative engine's device lengths) lives in static buffers that the
  graphs read and write in place; the token history, the page pool and
  the scratch are updated in place by the steps themselves.
- Outputs are static too: a replay's block, first tokens or chunk
  logits are overwritten by the next replay of the same graph. Every
  reader queues on the replay's stream before that: the engine's
  `HostCopy` of a block or of a group's first tokens is queued right
  after the replay, and the commit that samples from a chunk's logits
  right after the prompt's last chunk.
- The graphs are captured on one dedicated stream, each after one eager
  run of the same step on that stream over sink rows (page 0, slot
  index len(slots)): the kernels' one-time attributes and their split
  tickets (`kernels.tickets`, keyed by stream) then exist before the
  capture, and the split workspaces the wrappers allocate come from the
  family's pool, so the TMA tensor maps encoded at capture stay valid.
  A decode block is then replayed once over the same sink rows: its
  first launch uploads it to the device, which warmup pays instead of
  the first served requests, whose first tokens wait behind it. The
  captures run from the largest shape down, so a smaller graph of a
  family takes its memory from the blocks a larger one freed.
- Launch counts stay honest: `kernels.LAUNCHES` counts host launches, and
  a capture launches nothing while a replay launches every kernel it
  captured without a call through `kernels.launch`. The capturing
  thread's launches are counted apart (`kernels.capture_launches`) and
  recorded with the graph, and each replay adds them (`add_launches`);
  another engine's thread launching meanwhile counts as it always does.
  A capture's eager run over sink inputs launches for real and counts;
  a live capture's record also keeps those launches apart
  (`warm_launches`), as they serve no token.
- A sampled point registers the engine's generator with its graph, so
  every replay draws fresh numbers from it.

First sight. The warmup captures the lattice it warms; a long prompt
or a prefix hit at a scratch length it left out (the default server
warms no long prompts) has its points captured when it is admitted
(`capture_first_sight` over `first_sight_keys`: its chunk at the
largest bucket's width, with a prefix cache the hit's seed, its
commit), where the JAX engine compiles them cold once, on first sight,
and reuses them. Admission is the one safe moment: a capture's eager
run zeroes the scratch's lengths and writes its first rows, and no
prefill holds the scratch then. Before each such capture the device's
free bytes are read against the memory planner's headroom line; a point
that would take the engine into it stays eager and is counted
(`stats()`: `live_graphs`, `live_capture_s`, `live_refused` by family,
and a `live` record per capture with the pool's bytes after it).
A live capture comes in any order, not largest first: the chunk pool
then grows where a smaller graph came first, and stays safe, since
every graph holds its outputs, its temporaries live only inside its own
replay and one engine replays on one stream.

What stays eager, and why: a mesh engine (its all-reduces are gloo
collectives on the host, which a stream capture cannot hold); an engine
never warmed, and a point the device cannot afford beside the planner's
headroom (`covers` is then false); the KV pager's page moves (their
widths follow the pages a demotion or a promotion finds); and
in-process fleet replicas still share the default stream, so their
replays serialize there. A capture that fails raises, out of
`LLMEngine.warmup` or out of the admission: nothing falls back.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch import kernels
from generativeaiexamples_tpu_torch.models.llama import KVCache
from generativeaiexamples_tpu_torch.serving import engine_model

GREEDY = (True, False, False)
SAMPLED = (False, True, True)

FAMILIES = ("decode", "prefill", "chunk")

_I32, _F32 = (np.int32, torch.int32), (np.float32, torch.float32)


class _Inputs:
    """One family's static device inputs: named fields (numpy and torch
    dtypes, shape, the value a dispatch record lacking the field gets)
    packed into one device buffer, 4-byte fields first so every offset is
    aligned, with a device view of each. `load` copies a dispatch's host
    arrays in with one non-blocking copy; a shorter array fills the
    field's head (a chunk narrower than the widest) and the rest takes
    the fill value."""

    def __init__(self, fields, device):
        self._layout = []
        off = 0
        for name, (np_dt, t_dt), shape, fill in sorted(
                fields, key=lambda f: f[1][0] == np.bool_):
            n = int(np.prod(shape))
            nb = n * np.dtype(np_dt).itemsize
            self._layout.append((name, np_dt, t_dt, shape, fill, off, nb))
            off += nb
        self._nbytes = off
        self._buf = torch.zeros(off, dtype=torch.uint8, device=device)
        self.views: Dict[str, torch.Tensor] = {
            name: self._buf[o:o + nb].view(t_dt).view(shape)
            for name, _, t_dt, shape, _, o, nb in self._layout}

    def load(self, arrays) -> None:
        """Pack the host arrays into one host buffer (pinned for a CUDA
        buffer) and copy it into the static inputs, queued on the current
        stream."""
        host = torch.empty(self._nbytes, dtype=torch.uint8,
                           pin_memory=self._buf.is_cuda)
        h = host.numpy()
        for name, np_dt, _, _, fill, o, nb in self._layout:
            dst = h[o:o + nb].view(np_dt)
            dst[:] = fill
            a = arrays.get(name)
            if a is not None:
                flat = np.asarray(a, np_dt).reshape(-1)
                dst[:flat.size] = flat
        self._buf.copy_(host, non_blocking=True)


def prefill_inputs(n: int, bucket: int, page_size: int, batch: int,
                   device) -> _Inputs:
    """The static inputs of a prefill group of n prompts at `bucket`: the
    fields of a `prefill` dispatch record, each padding row's fill
    making it a sink row (length 1, page 0, slot index `batch`)."""
    return _Inputs((("tokens", _I32, (n, bucket), 0),
                    ("lengths", _I32, (n,), 1),
                    ("rows", _I32, (n, bucket // page_size), 0),
                    ("temps", _F32, (n,), 0.0),
                    ("top_ps", _F32, (n,), 1.0),
                    ("top_ks", _I32, (n,), 0),
                    ("idxs", _I32, (n,), batch)), device)


def graph_key(plan: engine_model.StepPlan,
              flags: Optional[Tuple[bool, bool, bool]]):
    """The lattice point of a decode plan: a verify block ignores the
    sampling flags (it is greedy); a plain one has a variant per flag
    set."""
    return plan, (None if plan.spec_k else tuple(bool(f) for f in flags))


def _flags(flags) -> Optional[Tuple[bool, bool, bool]]:
    return None if flags is None else tuple(bool(f) for f in flags)


def _family(key) -> str:
    return "decode" if isinstance(key[0], engine_model.StepPlan) else (
        "prefill" if key[0] == "prefill" else "chunk")


def first_sight_keys(s_total: int, chunk: int, seed: bool
                     ) -> Tuple[tuple, ...]:
    """The chunk-family points a prompt of scratch length s_total
    dispatches where the warmup captured none, in dispatch order: with a
    prefix cache (`seed`) the hit's gather, so a later hit at s_total
    finds it as the long-prompt warmup leaves it; the chunk at `chunk`,
    the width `_pick_chunk_width` gives with no width warmed at s_total;
    the commit scatter. The JAX engine compiles these cold the first
    time it dispatches them."""
    return ((("seed", s_total),) if seed else ()) + (
        ("chunk", s_total, chunk, None), ("commit", s_total))


def capture_bytes(cfg, key) -> int:
    """A chunk-family capture's device bytes, estimated before it runs:
    a chunk of width W, the memory planner's activation estimate for W
    tokens (~4 hidden-width and 2 MLP-width live copies, plus the f32
    logits row); a seed or a commit, one model-dtype copy of the k and v
    rows of its scratch length (the gather, or the reshaped rows the
    scatter writes). Doubled: the eager run's transients stay cached for
    the capture stream beside the graph's pool."""
    item = torch.empty((), dtype=cfg.dtype).element_size()
    if key[0] == "chunk":
        w = key[2]
        one = (w * (4 * cfg.dim + 2 * cfg.mlp_dim) * item
               + cfg.vocab_size * 4)
    else:
        one = 2 * cfg.n_layers * cfg.n_kv_heads * key[1] * cfg.head_dim \
            * item
    return 2 * one


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    outputs: Dict[str, torch.Tensor]  # the static outputs a replay writes
    launches: Dict[str, int]          # kernel -> launches a replay makes


class StepGraphs:
    """The captured lattice of one engine: `capture_*` at warmup, the
    replays behind `engine_model.plan_step` and the engine's executors.
    `pool`, `history`, the generator and the static scratch `scratch`
    (the engine's full-length KVCache) are the engine's; `last_tokens`
    and `dev_lengths` are copied into static buffers (the attributes of
    those names) that the engine adopts as its own. The pool is held
    weakly: an engine whose pool is dropped frees it, and no graph
    replays over another pool."""

    def __init__(self, params, cfg, pool, generator: torch.Generator,
                 batch: int, max_pages: int, last_tokens: torch.Tensor,
                 history: Optional[torch.Tensor] = None,
                 dev_lengths: Optional[torch.Tensor] = None,
                 scratch: Optional[KVCache] = None, max_chunk: int = 0):
        dev = last_tokens.device
        if dev.type != "cuda":
            raise ValueError(f"StepGraphs: CUDA graphs need a CUDA engine, "
                             f"not {dev}")
        self.params, self.cfg = params, cfg
        self._pool = weakref.ref(pool)
        self.page_size = pool.page_size
        self.generator = generator
        self.device = dev
        self.batch, self.max_pages = batch, max_pages
        self.stream = torch.cuda.Stream(dev)
        self.mempools = {f: torch.cuda.graph_pool_handle() for f in FAMILIES}
        self.graphs: Dict[tuple, _Graph] = {}
        self.capture_s = dict.fromkeys(FAMILIES, 0.0)
        # First-sight captures after warmup (capture_first_sight): graphs,
        # seconds and points refused for want of memory, by family, and
        # one record per capture.
        self.live_graphs = dict.fromkeys(FAMILIES, 0)
        self.live_capture_s = dict.fromkeys(FAMILIES, 0.0)
        self.live_refused = dict.fromkeys(FAMILIES, 0)
        self.live: list = []
        # The host seconds of the decode blocks' first launches (their
        # upload), part of capture_s.
        self.first_launch_s = dict.fromkeys(FAMILIES, 0.0)
        self.replays = dict.fromkeys(FAMILIES, 0)
        self._decode_in = _Inputs((
            ("tables", _I32, (batch, max_pages), 0),
            ("lengths", _I32, (batch,), 1),
            ("temps", _F32, (batch,), 0.0),
            ("top_ps", _F32, (batch,), 1.0),
            ("top_ks", _I32, (batch,), 0),
            ("active_mask", (np.bool_, torch.bool), (batch,), False)), dev)
        self._prefill_in: Dict[Tuple[int, int], _Inputs] = {}
        # The chunk family's inputs; a slot index of `batch` (the fill)
        # is dropped by the scatters, so a warm run writes no slot.
        self._chunk_in = _Inputs((
            ("chunk_tokens", _I32, (max(1, max_chunk),), 0),
            ("chunk_valid", _I32, (1,), 1),
            ("slot", _I32, (1,), batch),
            ("r_temp", _F32, (1,), 0.0),
            ("r_top_p", _F32, (1,), 1.0),
            ("r_top_k", _I32, (1,), 0),
            ("row", _I32, (max_pages,), 0),
            ("m", _I32, (1,), 0)), dev)
        # A speculative engine's commit: the prompt's history row.
        self._history_in = None if history is None else _Inputs((
            ("h_ids", _I32, (history.shape[1],), 0),
            ("h_len", _I32, (1,), 1),
            ("slot", _I32, (1,), batch)), dev)
        self.last_tokens = last_tokens.clone()
        self.history = history
        self.dev_lengths = (dev_lengths.clone() if dev_lengths is not None
                            else None)
        self.scratch = scratch
        # The last chunk's logits, which every chunk graph writes and the
        # finish graphs read.
        self.chunk_logits = torch.zeros(cfg.vocab_size, dtype=torch.float32,
                                        device=dev)

    # -- the bodies: what each graph holds ---------------------------------

    def _block_body(self, plan: engine_model.StepPlan, flags) -> Dict:
        """One decode block over the static buffers: the step through
        engine_model._plan_step, then the chained state written back into
        the static state buffers."""
        v = self._decode_in.views
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

    def _prefill_body(self, bucket: int, n: int, flags) -> Dict:
        """One bucketed prefill group with its first-token scatter and, on
        a speculative engine, its history rows."""
        v = self._prefill_in[(bucket, n)].views
        toks = engine_model.prefill_batch_step(
            self.params, self.cfg, self._pool(), v["tokens"], v["lengths"],
            v["rows"], v["temps"], v["top_ps"], v["top_ks"], self.generator,
            sampling_flags=flags)
        engine_model.set_last_tokens(self.last_tokens, v["idxs"], toks)
        if self.history is not None:
            engine_model.set_history_rows(self.history, self.dev_lengths,
                                          v["idxs"], v["tokens"],
                                          v["lengths"], toks)
        return {"toks": toks}

    def _chunk_body(self, s_total: int, width: int, flags) -> Dict:
        """One chunk through the first s_total rows of the static scratch;
        with `flags`, the prompt-completing chunk with its first-token
        sample into the slot the chunk input names."""
        v = self._chunk_in.views
        cache = engine_model.scratch_view(self.scratch, s_total)
        tokens = v["chunk_tokens"][:width].view(1, width)
        if flags is None:
            logits, _ = engine_model.prefill_chunk_step(
                self.params, self.cfg, cache, tokens, v["chunk_valid"])
            self.chunk_logits.copy_(logits)
            return {"chunk_logits": self.chunk_logits}
        tok0, _, _ = engine_model.prefill_chunk_sample_step(
            self.params, self.cfg, cache, tokens, v["chunk_valid"],
            self.last_tokens, v["slot"], v["r_temp"], v["r_top_p"],
            v["r_top_k"], self.generator, sampling_flags=flags)
        return {"tok0": tok0}

    def _seed_body(self, s_total: int) -> Dict:
        """A prefix hit's gather of its pages into the scratch's first
        s_total rows, lengths set to the cached count `m`."""
        v = self._chunk_in.views
        engine_model.pool_to_cache(
            self._pool(), self.cfg, v["row"][:s_total // self.page_size],
            v["m"], out=engine_model.scratch_view(self.scratch, s_total))
        return {}

    def _commit_body(self, s_total: int) -> Dict:
        """The finish's scatter of the scratch's first s_total rows into
        the pages the row names (sink page 0 for the rest)."""
        v = self._chunk_in.views
        engine_model.cache_to_pool(
            self._pool(), engine_model.scratch_view(self.scratch, s_total),
            self.cfg, v["row"][:s_total // self.page_size])
        return {}

    def _finish_body(self, flags) -> Dict:
        """The commit's first-token sample from the last chunk's logits
        into the slot the chunk input names."""
        v = self._chunk_in.views
        tok0, _ = engine_model.sample_token_into(
            self.last_tokens, v["slot"], self.chunk_logits, v["r_temp"],
            v["r_top_p"], v["r_top_k"], self.generator, *flags)
        return {"tok0": tok0}

    def _history_body(self) -> Dict:
        """A finished chunked prompt's history row and device length, its
        first token read from the slot's current token (which the
        prompt's last chunk or the finish sampler wrote)."""
        v = self._history_in.views
        slot = v["slot"].long().clamp(0, self.batch - 1)
        engine_model.set_history_rows(
            self.history, self.dev_lengths, v["slot"], v["h_ids"].view(1, -1),
            v["h_len"], self.last_tokens.index_select(0, slot))
        return {}

    # -- capture -------------------------------------------------------------

    def _capture(self, key, inputs: _Inputs, body,
                 sampled: bool) -> Dict[str, int]:
        """Capture `body` as the graph of `key`: once eagerly on the
        capture stream over the inputs' fill values (sink page 0, slot
        index `batch`: every write lands where nothing reads it), then
        under capture into its family's pool; a decode block is then
        replayed once over the same inputs. A point already captured (a
        second warmup) is kept as it is. Returns the kernel launches of
        the eager run (counted in `kernels.LAUNCHES` too; none for a
        point kept)."""
        if key in self.graphs:
            return {}
        family = _family(key)
        t0 = time.perf_counter()
        inputs.load({})
        if self.scratch is not None:
            self.scratch.lengths.zero_()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream), \
                kernels.capture_launches() as warm:
            body()
        kernels.add_launches(warm)
        self.stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        if sampled:
            # Each replay then draws from the generator's current offset.
            graph.register_generator_state(self.generator)
        with torch.cuda.stream(self.stream), \
                kernels.capture_launches() as launches:
            # thread_local: other engines of the process (fleet replicas)
            # may launch from their own threads meanwhile.
            graph.capture_begin(pool=self.mempools[family],
                                capture_error_mode="thread_local")
            try:
                outputs = body()
            finally:
                graph.capture_end()
        if family == "decode":
            # A graph's first launch uploads it to the device, ~23 ms for
            # a block (K up to 8 steps of 32 layers, H100): paid here, over
            # the same sink inputs, not while a served group's first
            # tokens wait behind the block's dispatch. A prefill group's
            # or a chunk's first launch is ~2 ms and not worth a second
            # forward at warmup.
            t1 = time.perf_counter()
            with torch.cuda.stream(self.stream):
                graph.replay()
            self.first_launch_s[family] += time.perf_counter() - t1
            self.stream.synchronize()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.graphs[key] = _Graph(graph, outputs, launches)
        self.capture_s[family] += time.perf_counter() - t0
        return warm

    def capture(self, plan: engine_model.StepPlan, flags) -> None:
        """Capture one decode lattice point (a block: no chunk)."""
        if plan.rider_width or not plan.decode_k:
            raise ValueError(f"StepGraphs: {plan} is not a decode block")
        key = graph_key(plan, flags)
        self._capture(key, self._decode_in,
                      lambda: self._block_body(plan, key[1]),
                      key[1] is not None and not key[1][0])

    def capture_prefill(self, bucket: int, n: int, flags) -> None:
        """Capture the prefill group of n prompts at `bucket`."""
        flags = _flags(flags)
        if (bucket, n) not in self._prefill_in:
            self._prefill_in[(bucket, n)] = prefill_inputs(
                n, bucket, self.page_size, self.batch, self.device)
        self._capture(("prefill", bucket, n, flags),
                      self._prefill_in[(bucket, n)],
                      lambda: self._prefill_body(bucket, n, flags),
                      not flags[0])

    def capture_chunk(self, s_total: int, width: int,
                      flags=None) -> Dict[str, int]:
        """Capture a chunk of `width` at scratch length s_total; with
        `flags`, the prompt-completing chunk that samples under them."""
        flags = _flags(flags)
        return self._capture(("chunk", s_total, width, flags),
                             self._chunk_in,
                             lambda: self._chunk_body(s_total, width, flags),
                             flags is not None and not flags[0])

    def capture_seed(self, s_total: int) -> Dict[str, int]:
        return self._capture(("seed", s_total), self._chunk_in,
                             lambda: self._seed_body(s_total), False)

    def capture_commit(self, s_total: int) -> Dict[str, int]:
        return self._capture(("commit", s_total), self._chunk_in,
                             lambda: self._commit_body(s_total), False)

    def capture_history(self) -> None:
        """On a speculative engine, the commit's history row."""
        if self._history_in is not None:
            self._capture(("history",), self._history_in,
                          self._history_body, False)

    def capture_finish(self, flags) -> None:
        flags = _flags(flags)
        self._capture(("finish", flags), self._chunk_in,
                      lambda: self._finish_body(flags), not flags[0])

    def capture_first_sight(self, keys, headroom_bytes: int) -> list:
        """Capture each of `keys` (`first_sight_keys`) that has no graph
        yet, after the warmup: the device's free bytes less the capture's
        estimate (`capture_bytes`) must stay at or above the memory
        planner's headroom line, else the point stays eager and counts
        in `live_refused`. Call only while no prefill holds the scratch
        (at a prompt's admission). Returns the keys captured."""
        done = []
        for key in keys:
            if key in self.graphs:
                continue
            family = _family(key)
            free, _ = torch.cuda.mem_get_info(self.device)
            est = capture_bytes(self.cfg, key)
            if free - est < headroom_bytes:
                self.live_refused[family] += 1
                continue
            t0 = time.perf_counter()
            if key[0] == "chunk":
                warm = self.capture_chunk(key[1], key[2], key[3])
            elif key[0] == "seed":
                warm = self.capture_seed(key[1])
            elif key[0] == "commit":
                warm = self.capture_commit(key[1])
            else:
                raise ValueError(f"StepGraphs: {key} is not a first-sight "
                                 f"point")
            dt = time.perf_counter() - t0
            self.live_graphs[family] += 1
            self.live_capture_s[family] += dt
            self.live.append({"key": key, "capture_s": dt, "est_bytes": est,
                              "free_bytes": free,
                              "pool_bytes": self.pool_bytes(family),
                              "warm_launches": warm})
            done.append(key)
        return done

    # -- replay --------------------------------------------------------------

    def _run(self, key, inputs: _Inputs, arrays) -> Dict:
        """Copy the host arrays in and replay the graph of `key` on the
        current stream; its recorded launches are counted."""
        g = self.graphs[key]
        inputs.load(arrays)
        g.graph.replay()
        kernels.add_launches(g.launches)
        self.replays[_family(key)] += 1
        return dict(g.outputs)

    @staticmethod
    def _block_of(plan: engine_model.StepPlan) -> engine_model.StepPlan:
        return plan._replace(rider_width=0, rider_s_total=0,
                             rider_sample=False)

    def covers(self, plan: engine_model.StepPlan, flags,
               chunk_flags=None) -> bool:
        """Whether every part of `plan` has a graph: its chunk at
        (rider_s_total, rider_width) (a rider_sample chunk under
        `chunk_flags`) and its block under `flags`."""
        if plan.rider_width and ("chunk", plan.rider_s_total,
                                 plan.rider_width,
                                 _flags(chunk_flags) if plan.rider_sample
                                 else None) not in self.graphs:
            return False
        return not plan.decode_k or graph_key(
            self._block_of(plan), flags) in self.graphs

    def has(self, key) -> bool:
        """Whether the prefill, seed, commit, finish or history point
        `key` has a graph (("prefill", bucket, n, flags), ("seed",
        s_total), ("commit", s_total), ("finish", flags), ("history",))."""
        return key in self.graphs

    def replay(self, plan: engine_model.StepPlan, *, pool, last_tokens,
               arrays: Dict[str, np.ndarray], history=None,
               dev_lengths=None, cache: Optional[KVCache] = None,
               sampling_flags=GREEDY, chunk_flags=None) -> Dict:
        """Replay `plan` on the current stream: its chunk's graph, then
        its block's (a rider or composed plan is the two back to back),
        each after its inputs' copy; the engine's state copied into the
        static buffers where it is not already them. Returns plan_step's
        dict; its tensors are the graphs' static buffers (a block's host
        copy must be queued before the next replay, as the engine does)."""
        if pool is not self._pool() or history is not self.history:
            raise ValueError("StepGraphs.replay: the pool and history must "
                             "be the ones captured")
        if last_tokens is not self.last_tokens:
            self.last_tokens.copy_(last_tokens)
        if dev_lengths is not None and dev_lengths is not self.dev_lengths:
            self.dev_lengths.copy_(dev_lengths)
        out: Dict = {}
        if plan.rider_width:
            if cache is None or cache.lengths is not self.scratch.lengths:
                raise ValueError("StepGraphs.replay: a chunk runs in the "
                                 "static scratch")
            out.update(self._run(
                ("chunk", plan.rider_s_total, plan.rider_width,
                 _flags(chunk_flags) if plan.rider_sample else None),
                self._chunk_in, arrays), cache=cache)
        if plan.decode_k:
            out.update(self._run(
                graph_key(self._block_of(plan), sampling_flags),
                self._decode_in, arrays))
        out.update(last_tokens=self.last_tokens, pool=pool)
        if self.history is not None:
            out.update(history=self.history, dev_lengths=self.dev_lengths)
        return out

    def replay_prefill(self, arrays: Dict[str, np.ndarray], flags
                       ) -> torch.Tensor:
        """Replay the prefill group of the record's shape; returns its
        first tokens [N] (a static buffer)."""
        n, bucket = np.shape(arrays["tokens"])
        return self._run(("prefill", bucket, n, _flags(flags)),
                         self._prefill_in[(bucket, n)], arrays)["toks"]

    def replay_point(self, key, arrays: Dict[str, np.ndarray]) -> Dict:
        """Replay a seed, commit, finish or history point (`has`)."""
        return self._run(key, self._history_in if key == ("history",)
                         else self._chunk_in, arrays)

    # -- what the graphs hold ------------------------------------------------

    def pool_bytes(self, family: Optional[str] = None) -> int:
        """The device bytes one family's graph pool holds (all families'
        with None): the caching allocator's segments that belong to that
        pool, on this device (no other engine's memory)."""
        pools = {tuple(self.mempools[f]) for f in (
            [family] if family else FAMILIES)}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in pools
                   and seg["device"] == self.device.index)

    def stats(self) -> Dict:
        """Graphs captured, the seconds their captures took (each with its
        eager run and its first replay) and the device bytes their pools
        hold, in all and by family with the replays each made since (and
        the decode blocks' first launches' host seconds); of those, the
        graphs captured after warmup on first sight and their seconds,
        and the first-sight points refused for want of memory, by family,
        with one record a live capture (`live`: key, seconds, estimate,
        free bytes before, the family's pool bytes after, the kernel
        launches of its eager run over sink inputs); the static
        scratch's bytes apart (it is the engine's, and the planner's)."""
        by = {f: {"graphs": sum(_family(k) == f for k in self.graphs),
                  "replays": self.replays[f],
                  "capture_s": self.capture_s[f],
                  "first_launch_s": self.first_launch_s[f],
                  "pool_bytes": self.pool_bytes(f),
                  "live_graphs": self.live_graphs[f],
                  "live_capture_s": self.live_capture_s[f],
                  "live_refused": self.live_refused[f]} for f in FAMILIES}
        return {"graphs": len(self.graphs),
                "capture_s": sum(self.capture_s.values()),
                "pool_bytes": sum(b["pool_bytes"] for b in by.values()),
                "by_family": by,
                "live": [dict(r) for r in self.live],
                "scratch_bytes": (2 * self.scratch.k.nbytes
                                  if self.scratch is not None else 0)}
