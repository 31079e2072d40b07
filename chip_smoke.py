#!/usr/bin/env python3
"""On-card check of the PyTorch/H100 port (generativeaiexamples_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. env      the card's name and power limit (nvidia-smi), torch / CUDA
  2. build    nvcc builds every kernel (K1-K6) from csrc/, one process
              per source, all in parallel
  3. flash    K1 (csrc/flash_attention.cu) against `mha_reference` run in
              f32 on the same bf16 inputs, at Llama-3-8B prefill shapes
              (and the chunked lane's, a prefix-cache hit's and the fused
              rider's q_offset shapes) plus ragged /
              q_offset / fully-masked / head_dim 64 cases; a second
              launch must give the same bits; SDPA (is_causal, or a
              boolean mask for lengths and q_offset) timed beside it
  4. paged    K2 (csrc/paged_attention.cu) against
              `paged_attention_reference` in f32, at 8B decode shapes
              (B=8 lengths 1…8191, B=1 at 6,000, B=8 at the serving
              phase's 17…129), head_dim 64, pages of 16 and 8 slots,
              and sharp scores whose maximum sits on each row's last page
              (every split and key slice must be rescaled); the sink
              page, poisoned with NaN, must stay unread and a second
              launch must give the same bits (the page axis split);
              loop and device time beside SDPA over pre-gathered K/V
  5. encoder  K3 (csrc/encoder_attention.cu) against
              `encoder_attention_reference` at arctic-embed-l (B=16,
              H=16, S=128/512) and reranker-base (B=8, H=12, S=256/512)
              shapes through the fused-QKV views bert.forward passes,
              ragged lengths with a lengths-0 row (must average V),
              contiguous q/k/v, and sharp scores whose maxima sit in
              each row's last 64 keys (the online softmax must
              rescale); a second launch must give the same bits;
              SDPA with a key-padding mask and K1's head_dim 64
              non-causal form timed beside it (loop and device time)
  5a. tools   (encoders) the port's attribution tools at arctic-embed-l
              (bf16, random weights), B = 32, S = 512:
              scripts/decompose_bert_forward's full, no_attn and
              fused_qkv forwards (least of 5, each with a host read; the
              tool's fused_qkv loop within BF16_ATOL of bert.forward),
              the full forward's device time by kernel class under
              torch.profiler (K3's own must show), and one
              scripts/decompose_encoders batch size (tokenize,
              pack, device chain and sync, readback, docs/s and
              queries/s, against the forward's roofline bound); K3 must
              launch
  6. paged_int8  K4 (csrc/paged_attention_int8.cu) against
              `paged_attention_int8_reference_fused` in f32 on the same
              codes and scales, row by row relative to each row's output,
              over a 2-layer fused pool read at layer 1: the 8B decode
              shape at B=8 and B=128, head_dim 64, a small page size, and
              rows whose largest score sits on their last page (the online
              softmax must rescale the earlier pages); NaN-poisoned scales
              in the sink page and in the table slots past each row's
              pages must not change it. Then its verify forms against
              `paged_attention_int8_rep_reference`, query by query: q_rep
              2 and 4 (linear k = 1, 3) and the (3, 4) tree at B = 8 and
              B = 128, the (3, 4) tree and q_rep 2 at the spec_int8
              burst's lengths, the (2, 8) tree, a late_max tree and a
              head_dim 64 / page 16 tree. A second launch must give the
              same bits (the B = 8 cases split the page axis and merge);
              loop and device time beside the byte bound and SDPA over
              K/V gathered and dequantized beforehand (a yardstick)
  6b. tree    K5 (csrc/paged_attention_tree.cu) against
              `paged_tree_attention_reference` in f32, node by node: the
              8B shape (B=8, lengths 1…8191, (3, 4)), (2, 8) at head_dim
              64 / page 16 (with a length-1 row) and at 8B, (3, 4) at
              page 8, and a late_max case, with a NaN-poisoned sink page
              and tail slots; a second launch must give the same bits;
              loop and device time beside SDPA with a boolean mask over
              pre-gathered K/V
  7. int8_matmul  K6 (csrc/int8_matmul.cu) against
              `int8_matmul_reference` in f32 at every 8B projection shape
              (K, M) and R = 8, 128 (decode), 256, 1664 (linear and tree
              verify at batch 128), 4096 (prefill), plus a ragged R and a
              ragged M; a second launch must give the same bits (split-K
              included); torch.matmul over a pre-dequantized bf16 weight
              timed beside it as a yardstick
  8. model    a 2-layer bf16 model with 8B head geometry, run through the
              engine's prefill and decode steps on the card, against the
              plain f32 forward on the CPU over the same weights; then
              its int8 variant (int8 weights, int8 pool: K6, K4) against
              the same steps in f32 on the CPU over the same codes. In
              both, a linear (k = 3) and a tree ((3, 4)) verify step
              against the same step in f32 on the CPU: logits within the
              tolerance, targets equal wherever the f32 top-2 margin
              exceeds twice it
  9. serving  LLMEngine at Llama-3-8B geometry (random weights from a
              seed, bf16, default engine config) behind the port's
              OpenAI server on a local port: one streaming chat
              completion, one non-streaming completion, 4 concurrent
              64-token completions (one of them sampled with temperature,
              top-k and top-p); K1's and K2's launch counts must rise.
              Then, outside the counted window, torch.profiler over one
              more 32-token completion: device idle share and device
              time by kernel name
  9b. flight  the flight recorder on the same server (on by default):
              /debug/timeline must round-trip as JSON and its spans nest;
              saved under build/ and split into device busy, host gap
              and idle by scripts/analyze_timeline.py --json (a
              subprocess; the attribution must sum to 100%);
              /metrics?format=prometheus must carry the eight hist_*
              histograms, /health its flight_recorder section; then the
              four completions (all greedy, admitted together once all
              are queued) with the recorder on (host time of its
              record_* calls per beat against the mean beat interval)
              and off: tokens/s of both, streams byte-identical
  10. chunked a ~6,000-token completion through the same server (chunked
              prefill beyond the 4096 bucket; K1 must launch), and the
              chunk steps' first-token logits against a one-shot forward;
              then engine.prefill_decode_k_cap: three greedy streams
              decode while the prompt prefills (at the default
              prefill_chunks_per_block and at 1), every decode block
              dispatched while the lane is live must take K <= 2 and the
              streams must equal the same requests run alone
  10b. fused_prefill  engine.fused_prefill over the served bf16 weights:
              five engines of batch 4 in turn (A the chunked lane, B
              the rider at a 512-token budget, C the lane with the
              unfused finish; tree engines, k = 3 and M = 4: D the rider
              knob without step plans, E composed plans, the rider inside
              the verify steps), each with three greedy 32-token streams
              decoding while a 6,000-token prompt prefills; every stream
              must equal the same request run alone (on A for A-C, on D
              for D-E), B and E must ride (fused_steps, rider + lane
              tokens = the prompt), A, C and D must not, C must count no
              fused sample, D and E must launch K5 and not K2; each run's
              flight timeline is attributed as in 9b; the short streams'
              inter-token gap while the prompt prefills (p50, max), its
              TTFT, prefill_stall_beats and K1 / K2 / K5 launches are
              printed
  11. rag     the chain server (developer_rag, device store, ranked
              hybrid retrieval) over the same 8B engine with
              arctic-embed-l and BERT-base reranker encoders: ingest of
              ~2,000 chunks of the repository's prose, /search and a
              1M-row device store against exact host MIPS, two
              knowledge-base /generate answers (tokens generated, no
              error frame); K3's launches must equal encoder layers x
              forwards, K1 and K2 must launch
  11a. chain  over the RAG phase's encoders and 2,001-chunk store and the
              same engine, tracing on: 64 distinct corpus queries to
              /search one at a time with micro-batching off, then all at
              once with serving.microbatch_enabled (results held to exact
              host MIPS, ids equal, fewer forwards, K3 launches = layers x
              forwards, the coalesced query embeddings compared bit for
              bit); 4 concurrent traced knowledge-base answers (one with
              a traceparent; every generate span shares its trace with one
              llm.local and one engine.generate span; the TTFT split from
              the spans; the reranker's batcher must coalesce); 1 answer
              with query augmentation (rewrite, hyde, multi_query: one
              embed_queries forward, one search_batch) and the fact check
              (a "[fact-check] " frame and a verdict); K1, K2, K3 launch
  11f. ann    (right after chain) ANN retrieval, no new kernel: (a) the
              chain over an IVF device store (nlist 64, nprobe 16) of the
              same 2,001 chunks: 64 /search queries one at a time (the
              first trains) and coalesced, ids equal; one knowledge-base
              answer; K3 launches = layers x forwards, K1 and K2 launch;
              (b) 1,000,000 x 1024 f32 unit rows around 4,096 centers
              (noise of norm ~0.5) made on the card: the flat store
              against IVF (nlist 1024, nprobe 16) f32 and int8 on the
              same rows: train s by step, table GB, search ms (1 and 64
              queries), scanned share, recall@10 against exact MIPS
              (>= 0.8), f32 ids equal to a float64 reference over the
              probed partitions, alone = batch, two trainings with one
              seed give equal centroids; (c) the tiered index over the
              same state (1 GB of device memory, 1 GB of RAM, a spill
              file): 4 rounds of 64 queries skewed to 16 centers with a
              pager pass between rounds (hit rate, promotions, ms),
              ids equal to plain IVF's but for near-ties, 4,096 added
              rows found before and after a compaction; (e) the sharded
              indexes over the same 1M rows on a mesh of two entries of
              the card (["cuda:0", "cuda:0"], one process):
              ShardedMIPSIndex against exact MIPS and ShardedIVFIndex
              (the IVF store's training state) against the store's
              index, ids equal but for near-ties, alone = batch, search
              ms (1 and 64 queries)
  11d. pipelines  (right after ann) the other pipelines the chain
              server registers, over the same encoders, store and engine:
              multi_turn_rag over HTTP with its conversation memory a
              device store on the card, 4 concurrent sessions of 2
              16-token turns (the memory holds 4 then 8 rows; every saved
              row bit-identical to the embedder's direct embedding of its
              text; every later history search equal to exact host MIPS
              over the rows it saw; each later prompt carries a saved
              turn; TTFT per turn from the spans; /metrics shows
              conv_store); api_catalog (one answer, the context in the
              user message); multimodal (a PDF with a positioned table and
              a chart, and a deck, through /documents, their images
              enriched by a stub VLM on a local port through
              connectors/vlm.py; the content_type="table" search returns
              the table; one answer; both files deleted again);
              query_decomposition (three sub-questions in one embed
              forward and one search_batch, ids equal to exact MIPS, over
              the corpus store and over a small store of short chunks,
              where all three are answered from their context) and
              knowledge_graph (triples reach the answer prompt) over a
              scripted EchoLLM; K1, K2 and K3 must launch
  12. serving_int8  after the bf16 engine and the stores are released:
              an LLMEngine at Llama-3-8B geometry, random weights from
              seed 0 quantized at load, in the documented int8 deployment
              (int8 weights and KV, batch 128, page 128, max_seq 8192),
              with one cut (4,097 pool pages); 128 concurrent greedy
              64-token completions and one ~6,000-token chunked prompt
              behind the OpenAI server. K6, K4 and K1 must launch, K2
              not. Then, with the engine stopped, four free pages of its
              int8 pool through pool_to_pages, host memory and
              pages_to_pool: codes and scales must come back bit-identical
  12a. tools  (int8) on the same deployment, its engine stopped:
              scripts/ttft_breakdown's stage table of every request the
              phase served (each row whole, no stage negative, its total
              within TTFT_AGREE_MS of the TTFT hist_ttft observed, the
              histogram's count and sum those of the rows, each first
              token's wait on the host after its block landed within
              its stage); with the pool freed,
              scripts/decompose_decode at B = 128, int8 KV: full,
              stub_attn, stub_quant and both, interleaved over
              DECOMPOSE_ROUNDS rounds of one K = 8 block each, plus one
              profiled block each (the full block's tokens equal after
              the stubs' context manager as before it, the bindings the
              same objects; K4 and K6 launch, K4's device time shows);
              scripts/profile_card's dispatch
              overhead and bandwidth rows (bf16 torch.matmul against K6
              at [16, 4096] x [4096, 14336], and K6 over 8 layers)
  12b. tutorial_02  the port's tutorial 02 in a subprocess on the card
              (a bf16 model of Llama-3.2-1B geometry): it must exit 0 and
              its printed metrics show K1 and K2 launches above 0 on its
              served requests (the counts zeroed after warmup); its
              speculative against greedy tokens are printed (bf16
              near-ties may part them)
  11b. spec_bf16  (before the bf16 engine goes) a tree engine (k = 3,
              M = 4, batch 8) over the same bf16 weights: 8 concurrent
              32-token completions, one sampled, so dispatches fall back
              to plain decode while it is live; K5 must launch, K2 only
              through the fallback
  11g. graphs  (after spec_bf16; its int8 legs after fused_prefill_int8)
              the warmed engine: each of four deployments at 8B width,
              the default bf16 engine at batch 8, the int8 deployment at
              batch 128, its speculative tree form (k = 3, M = 4) and
              the int8 deployment with the prefix cache and the rider
              (long-prompt leg), served twice over the same weights by
              two engines warmed alike at K in GRAPH_KS (and the chunked
              lane for a 4,096-token prompt, in the long leg for the
              6,000 and 6,088-token ones): one replays its lattice as
              CUDA graphs
              (serving/step_graphs.py: decode blocks, prefill groups,
              chunks, the hit chain), the other has every graph dropped
              after warmup, each fed the same greedy requests submitted
              before it starts (bf16 8 x 257 tokens, int8 128 x 129, tree
              128 x 65; long: 3 streams of 49 beside a 6,000-token prompt
              in 12 riders, then a hit on its first 5,888 tokens). The
              streams must be byte-identical, K1's, K2's, K4's, K5's and
              K6's launches a token equal (a replay counts what its graph
              captured), and the replayed engine must hold all three
              graph families and dispatch no eager prefill or chunk;
              each prints its graphs and pools by family beside the
              planner's activation_transients, long_prefill_scratch and
              headroom lines, tokens/s, TTFT p50/p95, the host time of a
              prefill dispatch and of a block, the device's idle share
              inside prefill dispatches (a profiled probe after the run)
              and the flight recorder's device-busy share; the long leg
              the prompt's TTFT, the hit's from its admission and the
              streams' worst gap while the prompt prefills. The replayed
              side checks a prefill group's first-token copy against a
              second replay of the same graph. The bf16 leg warms the
              sampled variants too and replays the sampled K = 1 graph
              16 times: every draw inside the top-k / top-p mask of the
              same step's eager logits, not all one token
  11c. prefix  (before the bf16 engine goes) an engine with the prefix
              cache and the KV pager (batch 8, page 128, 257 pool pages,
              a quarter of them cacheable, 512 MB of host tier) over the
              same weights: a 1,536-token shared prefix with 4 questions
              (each hit prefills only its suffix through K1's q_offset
              form; TTFT cold against hits; then all 4 at once), and 12
              1,024-token sessions run twice each, the first three
              resumed from host RAM and the spill file: promoted pages
              must equal their copy taken before demotion bit for bit and
              the resumed streams the resident hits'; K1 and K2 must
              launch
  11e. fleet  (after prefix, before the bf16 engine goes) two replica
              engines over the served weights (prefix cache on, 129 pool
              pages each) behind the port's OpenAI server: 4 greedy
              32-token chats over 4 sessions, each equal to the same
              request alone on the served engine, K1 and K2 launches equal
              to what the replicas' dispatches imply; each session's
              second turn on its replica with a router and an engine
              prefix hit; drain with a stream in flight, evict with a
              queued batch-tier request (requeued, tier and tenant kept);
              disagg (r0 prefill, r1 decode) of a 4,136-token prompt (32
              pages, 537 MB of bf16 KV) over the host bounce, the device
              path and pipelined 8-page windows, ms a page and TTFT
              against colocated, no fallback; r1 behind a second server
              as an HttpReplica (a proxied SSE chat, one /v1/kv transfer
              seating the in-process bytes); then a QoS engine replaying
              qos.bursty_trace(seed=0) off and on (latency TTFT p50/p95,
              preemptions) and the edge's 429s with Retry-After. K1, K2
              launch; K4, K5, K6 not
  13. spec_int8  over serving_int8's quantized weights, two speculative
              engines in turn in the same deployment: k = 3, M = 4 (tree)
              and k = 1 (linear), each with serving_int8's 128-request
              burst; every request must finish with its tokens; K4 and
              K6 must launch, K2 and K5 not; spec_tokens_per_step,
              tokens/s, TTFT, peak memory and the share of streams equal
              to serving_int8's are printed; the tree engine's burst
              runs again (16 tokens a request) under the profiler
              (outside the counted window) for the split of a verify step
              between K4, K6, the other device work and the host
  13c. fused_prefill_int8  run B again over the int8 deployment's
              weights (batch 4, 128 pool pages, buckets up to 1,024): a
              2,000-token prompt rides beside three 32-token streams; the
              streams
              must equal the same requests run alone; K1, K4 and K6 must
              launch, K2 not. Then the int8 tree composition (k = 3,
              M = 4, step plans): the same traffic, the rider inside the
              verify steps; streams equal the same requests alone on
              that engine; K1, K4 and K6 must launch, K2 and K5 not
  13b. checkpoint  serve from disk, after every phase above: the served
              bf16 8B engine's weights (kept when its engine went) written
              as an HF snapshot (4 shards + index, 16.06 GB under the
              ignored build/, free disk checked first) and the RAG
              phase's encoders as two BERT snapshots; load_tokenizer's
              gate on the weights-only snapshot; the encoders loaded
              (trees, embeddings and scores bit-identical to the
              in-memory ones; K3); load_llama in bf16 (time, GB/s, peak
              device memory; every leaf bit-identical), build_engine from
              the path behind the OpenAI server (a streaming chat and 4
              concurrent 32-token greedy completions equal to the served
              engine's tokens; K1, K2), the chain over it (PDF and HTML
              through /documents into a persisted store, reloaded; the
              RAG phase's 2,001-chunk store saved and reloaded, equal
              hits); load_llama(quantize=True) (codes and scales
              bit-identical to the loader's quantizer on the card and, at
              layer 0, to the JAX loader's numpy arithmetic; peak device
              memory at most the int8 tree plus one bf16 layer of the
              largest leaf) and the int8 deployment from the path (K6,
              K4, no K2). The snapshots are removed at the end, after
  13c. tp     tensor-parallel serving over two rank processes on cuda:0
              (gloo; the launcher's rank path: init_ranks, build_mesh,
              build_engine(mesh=...), run_follower) from the same
              snapshot, loaded sharded (time, each rank's peak device
              memory against its shard's bytes), bf16 then int8-at-load
              (each rank's codes and scales bit-identical to the slice of
              the single-device int8 tree, compared over CUDA IPC) with
              the int8 pool; the rank engines' teacher-forced logits
              (the prefill, then TP_TEACHER_STEPS decode steps over the
              pool, fed the single-device engine's tokens) against a
              single-device engine's under the same forcing (within
              TP_LOGIT_RTOL of its largest), and (bf16) a planted fault,
              rank 1's kv heads swapped, that the bound must catch; the
              four checkpoint completions behind rank 0's
              OpenAI server (one prefill group; 16 tokens; tokens
              against the single-device engine's: the share
              equal and the first divergence, a finding), two session
              requests over the prefix cache and pager (hits, demotions,
              a promotion), the longest prompt's pages exported whole
              (every rank's kv heads) against the forward's k/v, then a
              second engine whose 4 tokens must equal the first run's;
              the ranks start when the
              checkpoint phase does, behind its snapshot write; each rank's
              launches (K1, K2 bf16; K1, K4, K6 int8; K2/K4 at least
              layers x decode steps), the records rank 0 published equal
              to those rank 1 read, no divergence, tokens/s beside the
              single-device engine's and the collectives' time per decode
              step. Then the speculative leg over the int8 shards (no new
              load): tree speculation (k = 3, M = 4) with composed step
              plans and the fused rider at batch 8; the four completions
              (12 tokens) and a 512-token prompt admitted in one pass, the
              prompt's 128-token chunks riding the verify steps, then a
              sampled request alone (the plain fallback); each rank
              launches K1, K4 (tree form) and K6, neither K2 nor K5; the
              plans replayed by kind equal those run; the token chain,
              history and device lengths equal across the ranks; a
              second engine's tokens bit-identical; the tokens equal to a
              single-device engine of the same config (a share, a
              finding). Both ranks exit 0 after the stop record
  14. timing  the seconds of each phase and the total
  15. kernels one line {"kernels": [...]} with each kernel's parity,
              launches on its path (K1, K2: serving; K3: rag; K4, K6:
              serving_int8; K5: spec_bf16), times and bound; K1's rider
              chunk case; K1, K2, K4 and K6 their launches on the rider
              runs (fused_launches), K1, K4, K5 and K6 theirs on the
              rider beside verify steps (spec_rider_launches: run E and
              the int8 tree composition); K1-K3 also
              their launches on the chain and pipelines phases; every
              kernel its fleet launches (fleet_launches); K4's entry
              also carries its verify cases and its spec_int8 launches,
              K1's and K2's their prefix launches, every kernel its
              launches on the checkpoint phase's loaded models, and K1,
              K2, K4 and K6 their launches in each tensor-parallel rank
              (tp_launches), and every kernel its launches by the
              attribution tools and tutorial 02 (tools_launches)
  16. the card's name and power limit, then the last line
              {"ok": true, "device": {...}}

It imports neither jax nor the JAX package. Without CUDA, or without the
port's package beside it, it exits non-zero and prints no result.

    python3 chip_smoke.py --compare-parent DIR

times K1-K6 (AB_FLASH, K2's, K3's, K4's and K5's timed cases, every K6
case) through the public wrappers of the tree at DIR and of this one, in
turns (DIR, this, this, DIR), each in its own process on the same card,
and prints the four times per case.

    python3 chip_smoke.py --variants

times K4, K2 and K5 under other launch plans (key slices, stage size,
pages per split) beside the shipped plan, each checked against its plain
version, in one process.

    python3 chip_smoke.py --graphs

runs the graphs phase (11g) alone, over the same random weights, and
exits non-zero unless every deployment's leg passed.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib


# bf16 parity tolerance for unit-scale inputs: the kernels round their
# output to bf16 (half an ulp is 2^-9 ~ 2e-3 at |x| < 1) and K1 also
# rounds the softmax probabilities to bf16 before the P.V product; 2e-2
# leaves a 5-10x margin over that while still catching any indexing or
# masking fault (those give O(1) errors).
BF16_ATOL = 2e-2

# First-token logits of the chunked lane against the one-shot forward
# (phase_chunked): both sides bf16 on the card, same weights and kernels;
# see phase_chunked for why they can differ at all.
CHUNK_LOGIT_ATOL = 5e-2

K1_REPLACES = "generativeaiexamples_tpu/ops/attention.py:233 (_flash_kernel)"
K2_REPLACES = ("generativeaiexamples_tpu/serving/paged_attention.py:266 "
               "(_paged_kernel)")
K3_REPLACES = ("generativeaiexamples_tpu/ops/encoder_attention.py:96 "
               "(_encoder_kernel)")
K4_REPLACES = ("generativeaiexamples_tpu/serving/paged_attention_int8.py:386 "
               "(_int8_kernel)")
K5_REPLACES = ("generativeaiexamples_tpu/serving/paged_attention_tree.py:283 "
               "(_tree_kernel)")
K6_REPLACES = ("generativeaiexamples_tpu/ops/int8_matmul.py:91,109 "
               "(_kernel_fullk, _kernel)")

# K6 parity, relative to max |y| of the case: the kernel rounds its output
# to bf16 once (half an ulp is at most 2^-8 ~ 3.9e-3 of |y|) and sums in
# another order than the f32 reference; 1e-2 leaves a 2.5x margin while
# an indexing or scale fault gives O(1).
INT8_MM_RTOL = 1e-2

# K4 parity, per batch row and relative to that row's max |out|: the
# kernel rounds its output to bf16 once (half an ulp is at most 2^-8 ~
# 3.9e-3 of the value) and sums in another order than the f32 reference;
# 1e-2 leaves a 2.5x margin, while a wrong rescale of earlier pages by the
# online softmax is off by O(1) of the row. A fixed absolute tolerance
# would not do: under flat scores a long row's output is a mean over
# thousands of values, as small as 1e-2, and such a fault hides in it.
PAGED_INT8_RTOL = 1e-2
# q is scaled up so that the scores are sharp (std ~5 over the keys) and
# each row's output stays O(1) at every length, not a near-uniform mean.
PAGED_INT8_Q_SCALE = 8.0

# The int8 model's logits on the card (bf16 activations) against the same
# steps in f32 on the CPU over the same codes: the bf16 budget of phase
# model (5e-2), plus int8 KV codes that move by one where a bf16 k or v
# differs by a bf16 ulp from the f32 one and crosses a rounding boundary
# (one quantization step, amax / 127 of that row, in one element).
INT8_MODEL_ATOL = 1e-1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


_T0 = time.perf_counter()
# (label, seconds since the script started) at the steps that take the
# time inside a phase; the timing line prints them.
_MARKS: list = []


def time_mark(label: str) -> None:
    _MARKS.append([label, round(time.perf_counter() - _T0, 3)])


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi rc {out.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def n_sms() -> int:
    """The card's SM count, as the K2, K4 and K5 wrappers pass it to
    their plans."""
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def _shared():
    """The port's attribution-tools package, the one owner of the
    roofline peaks and bound rule, the kernels' CUDA function names and
    the profiler's device rows. Imported when first needed, not with
    this file, so `--time-kernels DIR` loads DIR's package (a tree from
    the tools' first slice on)."""
    from generativeaiexamples_tpu_torch import scripts
    return scripts


def bound(n_bytes: float, flops: float):
    """(least ms, "bytes" or "operations"): scripts.bound_ms."""
    return _shared().bound_ms(n_bytes, flops)


def _kernel_fn(name: str) -> str:
    """A port kernel's CUDA function name, as a profile shows it."""
    return _shared().KERNEL_FUNCTIONS[name]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, calls: int = 50, batches: int = 5) -> float:
    """Host time of one call of `fn`: the least, over `batches` runs of
    `calls` calls (the card synchronised before each run), of the wall
    time per call. Where the card takes less time a call than the host,
    this is what the host spends in it; the least of the runs leaves out
    the other tenants of a shared host."""
    import torch

    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return best * 1e3


def host_profile(fn, calls: int = 100, top: int = 8) -> list:
    """Where the host's time in a call of `fn` goes: torch.profiler's CPU
    activities over `calls` calls, the `top` by self CPU time, as [µs a
    call, occurrences a call, name]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_cpu_time_total / calls, e.count / calls, e.key)
                   for e in prof.key_averages()), reverse=True)[:top]
    return [[us, n, key[:60]] for us, n, key in rows]


def device_ms(fn, kernel_function: str = "", iters: int = 10) -> float:
    """Device time of one call of `fn`, from torch.profiler: the self
    device time of the activities whose name holds `kernel_function`
    (all of them by default), over `iters` calls. Unlike time_ms it does
    not count host gaps between launches, so the two differ when the
    host, not the card, sets the pace of a launch loop."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if kernel_function in e.key:
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
    return us / 1e3 / iters


# -- phase 3: K1 ------------------------------------------------------------


def flash_case(name, B, H, KH, Sq, Sk, D, lengths, q_offset, causal=True,
               seed=0, timed=False, nan_tail=0):
    """K1 against `mha_reference` in f32 on the same bf16 inputs. With
    `nan_tail`, k and v are the first Sk rows of buffers `nan_tail` rows
    longer whose rows past Sk hold NaN (a scratch view and the store's
    rows past it): a kernel that read past Sk would give NaN."""
    import torch

    from generativeaiexamples_tpu_torch.ops import attention as attn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, Sq, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, KH, Sk + nan_tail, D), generator=g,
                    device=dev).bfloat16()
    v = torch.randn((B, KH, Sk + nan_tail, D), generator=g,
                    device=dev).bfloat16()
    k[:, :, Sk:] = float("nan")
    v[:, :, Sk:] = float("nan")
    k, v = k[:, :, :Sk], v[:, :, :Sk]
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    off = torch.tensor(q_offset, dtype=torch.int32, device=dev)
    got = attn.flash_attention(q, k, v, causal=causal, lengths=ln,
                               q_offset=off)
    # A second launch on the same inputs must give the same bits.
    repeat_identical = bool(torch.equal(got, attn.flash_attention(
        q, k, v, causal=causal, lengths=ln, q_offset=off)))
    want = attn.mha_reference(q.float(), k.float(), v.float(), causal=causal,
                              lengths=ln, q_offset=off)
    torch.cuda.synchronize()
    # Rows with no valid key: the kernel writes zeros, the reference
    # averages V (documented in ops/attention.py); held separately.
    # Visible keys per query row: min(lengths, row position + 1).
    n_valid = ln.long().clamp(0, Sk)[:, None].expand(B, Sq)
    if causal:
        q_pos = torch.arange(Sq, device=dev)[None, :] + off.long()[:, None]
        n_valid = torch.minimum(n_valid, q_pos + 1)
    has_key = (n_valid > 0)[:, None, :, None]           # [B, 1, Sq, 1]
    diff = (got.float() - want).abs()
    err = float(torch.where(has_key, diff, torch.zeros_like(diff)).max())
    masked_nonzero = float(torch.where(has_key, torch.zeros_like(diff),
                                       got.float().abs()).max())
    finite = bool(torch.isfinite(got.float()).all())
    ok = (finite and err <= BF16_ATOL and masked_nonzero == 0.0
          and repeat_identical)
    rec = {"phase": "flash", "case": name, "B": B, "H": H, "KH": KH,
           "Sq": Sq, "Sk": Sk, "D": D, "q_offset": q_offset,
           "nan_tail": nan_tail, "max_abs_err": err, "tol": BF16_ATOL,
           "masked_rows_max_abs": masked_nonzero, "finite": finite,
           "repeat_identical": repeat_identical, "ok": ok}
    if timed:
        # Work this input needs: every (query row, visible key) pair costs
        # 4 * D flops per head (QK^T and PV); q read once, the output
        # written once, and the k/v rows below `lengths` read once.
        pairs = float(n_valid.clamp(min=0).sum())
        flops = 4.0 * D * H * pairs
        kv_rows = float(ln.long().clamp(0, Sk).sum())
        n_bytes = 2.0 * (2 * q.numel() + 2 * kv_rows * KH * D) + 8.0 * B
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)
        rec["ms"] = time_ms(lambda: attn.flash_attention(
            q, k, v, causal=causal, lengths=ln, q_offset=off))
        rec["device_ms"] = device_ms(lambda: attn.flash_attention(
            q, k, v, causal=causal, lengths=ln, q_offset=off),
            "flash_fwd_kernel")
        rec["plain_ms"] = time_ms(lambda: attn.mha_reference(
            q, k, v, causal=causal, lengths=ln, q_offset=off), iters=5)
        rec["library_ms"], rec["library"] = flash_library_ms(
            q, k, v, causal, ln, off)
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    del got, want, diff
    torch.cuda.empty_cache()
    return rec


def flash_library_ms(q, k, v, causal, lengths, q_offset):
    """(ms, call) of one SDPA call computing the same function on the
    same inputs: `is_causal` where lengths are full and there is no
    offset, else a boolean attn_mask [B, 1, Sq, Sk] holding lengths and
    the q_offset-shifted diagonal (built once, outside the timing). A row
    with no visible key differs (SDPA gives NaN there, K1 zeros), which
    does not change the work."""
    import torch
    import torch.nn.functional as F

    B, _, Sq, _ = q.shape
    Sk = k.shape[2]
    if causal and bool((lengths == Sk).all()) and not bool(q_offset.any()):
        return time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)), \
            "SDPA is_causal"
    kv_pos = torch.arange(Sk, device=q.device)[None, None, None, :]
    mask = kv_pos < lengths.long()[:, None, None, None]
    if causal:
        q_pos = (torch.arange(Sq, device=q.device)[None, None, :, None]
                 + q_offset.long()[:, None, None, None])
        mask = mask & (kv_pos <= q_pos)
    ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))
    del mask
    return ms, "SDPA with a boolean attn_mask"


def phase_flash():
    cases = [
        # The serving phase's own prefill shape: a group of four short
        # prompts in the 128 bucket.
        flash_case("8b_s128_served", 4, 32, 8, 128, 128, 128,
                   [23, 41, 17, 30], [0] * 4, seed=8, timed=True),
        flash_case("8b_s512", 4, 32, 8, 512, 512, 128, [512] * 4, [0] * 4,
                   seed=1, timed=True),
        flash_case("8b_s2048", 4, 32, 8, 2048, 2048, 128, [2048] * 4,
                   [0] * 4, seed=2, timed=True),
        # The chunked lane's second chunk of a 6,000-token prompt: 1,904
        # valid queries in a 2,048-wide chunk at q_offset 4,096 over an
        # 8,192-row scratch cache.
        flash_case("8b_chunk_q_offset", 1, 32, 8, 2048, 8192, 128, [6000],
                   [4096], seed=9, timed=True),
        # A prefix-cache hit on a fully cached 1,536-token prompt: capped
        # at plen - 1, one suffix token at q_offset 1,535 (mid-tile) in a
        # 128-wide chunk over a 2,048-row scratch cache.
        flash_case("8b_hit_q_offset", 1, 32, 8, 128, 2048, 128, [1536],
                   [1535], seed=10, timed=True),
        # The fused prefill rider's chunk (phase_fused_prefill, run B): a
        # 512-wide chunk at q_offset 5,120 of a 6,000-token prompt over
        # the 8,192-row scratch cache.
        flash_case("8b_rider_q_offset", 1, 32, 8, 512, 8192, 128, [5632],
                   [5120], seed=11, timed=True),
        # Chunks whose padded rows pass the scratch's end (q_offset + Sq
        # > Sk; the graphs phase's bf16_hits leg), over views of buffers
        # whose rows past Sk hold NaN: a long hit's 200-token suffix in
        # a 4,096-wide chunk at q_offset 5,888 of an 8,192-row scratch
        # (1,792 rows past it), and an exact repeat's one token in a
        # 128-wide chunk at q_offset 1,023 of a 1,024-row scratch.
        flash_case("8b_hit_past_end", 1, 32, 8, 4096, 8192, 128, [6088],
                   [5888], seed=14, nan_tail=1),
        flash_case("8b_repeat_past_end", 1, 32, 8, 128, 1024, 128, [1024],
                   [1023], seed=15, nan_tail=129),
        flash_case("ragged", 4, 32, 8, 200, 200, 128, [200, 137, 1, 64],
                   [0] * 4, seed=3),
        flash_case("q_offset", 4, 32, 8, 128, 512, 128, [512, 128, 228, 328],
                   [384, 0, 100, 200], seed=4),
        flash_case("masked_row", 2, 32, 8, 128, 128, 128, [0, 100], [0, 0],
                   seed=5),
        flash_case("hd64", 2, 32, 8, 256, 256, 64, [256, 77], [0, 0], seed=6),
        flash_case("noncausal", 2, 8, 8, 96, 160, 128, [160, 33], [0, 0],
                   causal=False, seed=7),
        # A tensor-parallel rank's prefill group at 8B, tensor 2
        # (phase_tp): 16 query and 4 kv heads.
        flash_case("8b_tp2_s128", 4, 16, 4, 128, 128, 128,
                   [66, 94, 38, 99], [0] * 4, seed=12),
        # The same rank's rider (phase_tp's speculative leg): the last
        # 128-wide chunk, at q_offset 384, of a 512-token prompt over its
        # scratch cache.
        flash_case("8b_tp2_rider_q_offset", 1, 16, 4, 128, 512, 128, [512],
                   [384], seed=13),
    ]
    for c in cases:
        emit(c)
    return cases


# -- phase 4: K2 ------------------------------------------------------------


def _paged_inputs(B, H, KH, Hd, ps, maxp, lengths, seed, q_scale=1.0,
                  late_max=False):
    """K2's inputs: bf16 q [B, H, Hd], two layers of bf16 pages [2, KH,
    P, ps, Hd] (k and v), a table naming shuffled pages with its tail
    slots at sink page 0, int32 lengths. `late_max` gives each row's last
    slot (on its last page) a k that matches its query group, so that the
    row's largest score comes last and every earlier page, split and key
    slice must be rescaled."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = B * maxp + 1
    q = (torch.randn((B, H, Hd), generator=g, device=dev)
         * q_scale).bfloat16()
    kp = torch.randn((2, KH, n_pages, ps, Hd), generator=g,
                     device=dev).bfloat16()
    vp = torch.randn((2, KH, n_pages, ps, Hd), generator=g,
                     device=dev).bfloat16()
    perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    table = torch.zeros((B, maxp), dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-n // ps)
        table[b, :need] = perm[used:used + need].int()
        used += need
    if late_max:
        group_q = q.float().reshape(B, KH, H // KH, Hd).sum(2)
        for b, n in enumerate(lengths):
            page = int(table[b, (n - 1) // ps])
            kp[:, :, page, (n - 1) % ps] = (
                torch.sign(group_q[b]) * 4).bfloat16()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, ln


def paged_case(name, B, H, KH, Hd, ps, maxp, lengths, seed=0, timed=False,
               q_scale=1.0, late_max=False):
    """K2 against `paged_attention_reference` in f32 on the same bf16
    inputs (layer 1 of a two-layer pool), within BF16_ATOL. Tail table
    slots point at sink page 0; after the parity check the sink is
    poisoned with NaN and the kernel's result must not change (it never
    reads those slots). A second launch must give the same bits (the
    page axis split across CTAs and merged included)."""
    import torch

    from generativeaiexamples_tpu_torch.serving import paged_attention as pa

    q, kp2, vp2, table, ln = _paged_inputs(B, H, KH, Hd, ps, maxp, lengths,
                                           seed, q_scale, late_max)
    kp, vp = kp2[1], vp2[1]
    got = pa.paged_attention(q, kp, vp, table, ln)
    repeat = bool(torch.equal(got, pa.paged_attention(q, kp, vp, table, ln)))
    want = pa.paged_attention_reference(q.float(), kp.float(), vp.float(),
                                        table, ln)
    # Tail slots point at sink page 0: poison it and require a
    # bit-identical result, i.e. the kernel never reads those slots.
    kp_sink, vp_sink = kp[:, 0].clone(), vp[:, 0].clone()
    kp[:, 0] = float("nan")
    vp[:, 0] = float("nan")
    poisoned = pa.paged_attention(q, kp, vp, table, ln)
    kp[:, 0], vp[:, 0] = kp_sink, vp_sink
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max())
    sink_unread = bool(torch.equal(poisoned, got))
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and sink_unread and repeat and err <= BF16_ATOL
    plan = pa.paged_bf16_plan(B, KH, H // KH, Hd, ps, maxp, n_sms())
    rec = {"phase": "paged", "case": name, "B": B, "H": H, "KH": KH,
           "Hd": Hd, "ps": ps, "maxp": maxp, "lengths": lengths,
           "q_scale": q_scale, "late_max": late_max,
           "max_abs_err": err, "tol": BF16_ATOL,
           "max_abs_out": float(want.abs().max()),
           "sink_unread": sink_unread, "repeat_identical": repeat,
           "plan": plan._asdict(), "finite": finite, "ok": ok}
    if timed:
        tokens = float(sum(lengths))
        # K/V of the tokens this input attends (not whole pages), the
        # query and output once, plus the table and lengths.
        n_bytes = 2.0 * (2 * tokens * KH * Hd + 2 * q.numel()) \
            + 4.0 * (table.numel() + B)
        flops = 4.0 * Hd * H * tokens
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)
        # Alternate the two layers so that one call's pages are not in L2
        # for the next (the decode path reads another layer every call).
        turn = [0]

        def alternating():
            turn[0] ^= 1
            pa.paged_attention(q, kp2[turn[0]], vp2[turn[0]], table, ln)

        rec["ms"] = time_ms(alternating)
        rec["device_ms"] = device_ms(alternating,
                                     _kernel_fn("paged_attention"))
        rec["host_ms"] = host_ms(alternating)
        rec["host_profile"] = host_profile(alternating)
        rec["plain_ms"] = time_ms(lambda: pa.paged_attention_reference(
            q, kp, vp, table, ln), iters=5)
        # No single torch call takes a page table; SDPA over K/V gathered
        # beforehand (gather not timed) is kept as a dense yardstick only.
        rec["library_ms"] = None
        rec["sdpa_gathered_ms"], rec["sdpa_gathered_device_ms"] = \
            paged_sdpa_gathered_ms(q, kp, vp, table, ln)
        rec["gbytes_per_s"] = n_bytes / (rec["device_ms"] * 1e-3) / 1e9
    del kp2, vp2, got, poisoned, want
    torch.cuda.empty_cache()
    return rec


def paged_sdpa_gathered_ms(q, kp, vp, table, ln):
    """(loop ms, device ms) of SDPA with a lengths mask over K/V gathered
    through the table beforehand (the gather is not timed)."""
    import torch
    import torch.nn.functional as F

    B, H, Hd = q.shape
    KH, _, ps, _ = kp.shape
    maxp = table.shape[1]
    t = table.long()
    k = kp[:, t].permute(1, 0, 2, 3, 4).reshape(B, KH, maxp * ps, Hd)
    v = vp[:, t].permute(1, 0, 2, 3, 4).reshape(B, KH, maxp * ps, Hd)
    mask = (torch.arange(maxp * ps, device=q.device)[None, :]
            < ln[:, None])[:, None, None, :]

    def sdpa():
        F.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                       attn_mask=mask, enable_gqa=True)

    return time_ms(sdpa), device_ms(sdpa)


# K2's timed cases at the 8B shape (H = 32, KH = 8, head_dim 128, page
# 128, 64 table slots): (name, B, lengths, seed).
K2_TIMED = (
    ("8b_decode", 8, [1, 17, 128, 129, 1000, 4096, 7000, 8191], 11),
    # The decode that follows the chunked phase's 6,000-token prompt.
    ("8b_b1_6000", 1, [6000], 14),
    # The serving phase's rows: short prompts and up to 64 new tokens;
    # the loop time is the host's.
    ("8b_short", 8, [17, 23, 30, 41, 64, 81, 100, 129], 15))


def phase_paged():
    cases = [paged_case(name, B, 32, 8, 128, 128, 64, lengths, seed=seed,
                        timed=True)
             for name, B, lengths, seed in K2_TIMED]
    cases += [
        paged_case("hd64", 4, 32, 8, 64, 128, 16, [1, 300, 1024, 2047],
                   seed=12),
        paged_case("ps16", 3, 8, 2, 128, 16, 32, [5, 16, 511], seed=13),
        # The smallest page the engine admits: a 16-key step holds two
        # pages, a ring stage eight; the page axis is split.
        paged_case("ps8", 4, 32, 8, 128, 8, 128, [1, 9, 300, 1023],
                   seed=16),
        # Sharp scores whose maximum sits on each row's last page: every
        # earlier page, key slice and split must be rescaled when merged.
        paged_case("sharp_late_max", 8, 32, 8, 128, 128, 64,
                   [129, 700, 1500, 2048, 3000, 4097, 6000, 8191], seed=17,
                   q_scale=PAGED_INT8_Q_SCALE, late_max=True),
        # A tensor-parallel rank's decode at 8B, tensor 2 (phase_tp): 16
        # query and 4 kv heads, batch 4, pages of 16 up to 1,024 tokens.
        paged_case("8b_tp2_ps16", 4, 16, 4, 128, 16, 64, [67, 130, 203, 1024],
                   seed=18),
    ]
    for c in cases:
        emit(c)
    return cases


# -- phase 5: K3 ------------------------------------------------------------


def _encoder_inputs(B, H, S, lengths, seed, fused, sharp=False):
    """K3's bf16 q, k, v [B, H, S, 64] (views of one [B, S, 3, H, 64]
    buffer when `fused`, as bert.forward passes them) and lengths.
    `sharp`: q and each row's last 64 keys below its length x 4 (exact
    in bf16), so scores there have std ~16 against ~4 before them: every
    query row's largest score lies in its last one or two key tiles,
    ~25 above the earlier tiles' running max, and the online softmax
    must rescale everything it has summed. V x 1/4 keeps the output, a
    mix of a few V rows, under 2 in magnitude, where a bf16 ulp (2^-7)
    stays well inside the absolute tolerance."""
    import torch

    D = 64
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    if fused:  # the q/k/v views bert.forward hands the kernel
        qkv = torch.randn((B, S, 3, H, D), generator=g, device=dev).bfloat16()
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q, k, v = (torch.randn((B, H, S, D), generator=g,
                               device=dev).bfloat16() for _ in range(3))
    if sharp:
        q.mul_(4)
        v.mul_(0.25)
        for b, n in enumerate(lengths):
            n = min(max(n, 1), S)
            k[b, :, max(n - 64, 0):n].mul_(4)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def encoder_case(name, B, H, S, lengths, seed=0, fused=False, timed=False,
                 sharp=False):
    """K3 against `encoder_attention_reference` on the same bf16 inputs
    (the plain version rounds P and the output to bf16 where the kernel
    does). A lengths-0 row must average V like the plain version, and a
    second launch must give the same bits. `sharp`: see _encoder_inputs."""
    import torch
    import torch.nn.functional as F

    from generativeaiexamples_tpu_torch.ops import attention as attn
    from generativeaiexamples_tpu_torch.ops import encoder_attention as ea

    D = 64
    q, k, v, ln = _encoder_inputs(B, H, S, lengths, seed, fused, sharp)
    got = ea.encoder_attention(q, k, v, ln)
    want = ea.encoder_attention_reference(q, k, v, ln)
    repeat = bool(torch.equal(got, ea.encoder_attention(q, k, v, ln)))
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    zero_rows = [b for b, n in enumerate(lengths) if n <= 0]
    zero_err = max((float((got[b].float() - v[b].float().mean(
        dim=1, keepdim=True)).abs().max()) for b in zero_rows), default=None)
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and repeat and err <= BF16_ATOL and (
        zero_err is None or zero_err <= BF16_ATOL)
    rec = {"phase": "encoder", "case": name, "B": B, "H": H, "S": S,
           "D": D, "fused_qkv_view": fused, "sharp": sharp,
           "max_abs_out": float(want.float().abs().max()), "max_abs_err": err,
           "zero_length_rows": zero_rows, "zero_row_vs_v_mean": zero_err,
           "tol": BF16_ATOL, "repeat_identical": repeat, "finite": finite,
           "ok": ok}
    if timed:
        # Work this input needs: every query row against the keys below
        # its lengths (all S for a lengths-0 row); q and the output once,
        # k/v rows below lengths once.
        keys = [S if n <= 0 else min(n, S) for n in lengths]
        flops = 4.0 * D * H * S * sum(keys)
        n_bytes = 2.0 * (2 * q.numel() + 2 * H * D * sum(keys)) + 4.0 * B
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)

        def kernel():
            ea.encoder_attention(q, k, v, ln)

        rec["ms"] = time_ms(kernel)
        rec["device_ms"] = device_ms(kernel, _kernel_fn(
            "encoder_attention"))
        rec["plain_ms"] = time_ms(
            lambda: ea.encoder_attention_reference(q, k, v, ln), iters=5)
        mask = (torch.arange(S, device=q.device)[None, :]
                < ln[:, None])[:, None, None, :]

        def library():
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        rec["library_ms"] = None if zero_rows else time_ms(library)
        rec["library_device_ms"] = None if zero_rows else device_ms(library)
        # K1's head_dim 64 non-causal form with lengths, for information
        # (it writes zeros on a lengths-0 row, so it is no substitute).
        rec["k1_d64_ms"] = time_ms(lambda: attn.flash_attention(
            q, k, v, causal=False, lengths=ln))
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    del got, want
    torch.cuda.empty_cache()
    return rec


# K3's timed cases: (name, B, H, S, lengths, seed), all through the
# fused-QKV views. arctic-embed-l (B=16, H=16): the ingest shape and a
# short one; reranker-base (B=8, H=12): its RAG shape (a query plus a
# ~508-token chunk mostly fill the 512 bucket, shorter tails do not) and
# a shorter bucket.
def _encoder_timed_cases():
    import numpy as np

    rng = np.random.default_rng(5)
    rng.integers(1, 513, 16)  # the ragged case's draw comes first
    rerank_lengths = [512] * 5 + rng.integers(1, 512, 3).tolist()
    return (("arctic_s512", 16, 16, 512, [512] * 16, 1),
            ("arctic_s128", 16, 16, 128, [128] * 16, 2),
            ("reranker_s512", 8, 12, 512, rerank_lengths, 7),
            ("reranker_s256", 8, 12, 256, [256] * 8, 3))


def phase_encoder():
    import numpy as np

    rng = np.random.default_rng(5)
    ragged = rng.integers(1, 513, 16).tolist()
    ragged[3] = 0
    cases = [encoder_case(name, B, H, S, ln, seed=seed, fused=True,
                          timed=True)
             for name, B, H, S, ln, seed in _encoder_timed_cases()]
    cases += [
        # Contiguous q/k/v (the wrapper takes any strides).
        encoder_case("ragged_zero_row", 16, 16, 512, ragged, seed=4),
        encoder_case("fused_qkv_view", 8, 12, 256,
                     [256, 0, 1, 100, 17, 255, 64, 200], seed=5, fused=True),
        encoder_case("odd_s", 2, 2, 33, [0, 20], seed=6),
        # Sharp scores whose maximum lies in each row's last key tile.
        encoder_case("sharp_late_max", 8, 4, 512,
                     [512, 449, 300, 65, 130, 511, 64, 200], seed=8,
                     fused=True, sharp=True),
    ]
    for c in cases:
        emit(c)
    return cases


# -- phase 6: K4 ------------------------------------------------------------


def _verify_pairs(lengths, R, tree, cap):
    """(query row, visible kv slot) pairs per query head, and kv slots
    read, of a verify form over these lengths: query j of row b sees
    len - 1 prefix slots plus its ancestor-or-self nodes (j + 1 of them
    for the linear form); the span read is min(len + R - 1, cap)."""
    import numpy as np

    from generativeaiexamples_tpu_torch.serving.paged_attention_tree import (
        _canonical_tree)

    seen = (_canonical_tree(*tree).sum(1) if tree is not None
            else np.arange(1, R + 1))
    pairs = sum(R * (max(n, 1) - 1) + int(seen.sum()) for n in lengths)
    slots = sum(min(max(n, 1) + R - 1, cap) for n in lengths)
    return float(pairs), float(slots)


def _paged_int8_inputs(B, H, KH, Hd, ps, maxp, lengths, L, layer, seed,
                       late_max, R):
    """K4's inputs: bf16 q [B, H, Hd] ([B, R, H, Hd] for R > 1), the full
    L-layer fused pool and f32 scales, a table naming shuffled pages
    (tail slots at page P - 1, never assigned), int32 lengths."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * maxp + 2              # page P - 1: never assigned, poisoned
    q = (torch.randn((B, R, H, Hd), generator=g, device=dev)
         * PAGED_INT8_Q_SCALE).bfloat16()
    if R == 1:
        q = q[:, 0]
    kv = torch.randint(-127, 128, (2, L, KH, P, ps, Hd), generator=g,
                       device=dev, dtype=torch.int8)
    sc = (torch.rand((2, L, KH, P, ps), generator=g, device=dev) + 0.5) / 127
    perm = torch.randperm(P - 2, generator=g, device=dev) + 1
    table = torch.full((B, maxp), P - 1, dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lengths):
        need = min(-(-(max(n, 1) + R - 1) // ps), maxp)
        table[b, :need] = perm[used:used + need].int()
        used += need
    if late_max:
        group_q = q.float().reshape(B, R, KH, H // KH, Hd).sum((1, 3))
        for b, n in enumerate(lengths):
            t = max(n, 1) - 1
            page = int(table[b, t // ps])
            kv[0, layer, :, page, t % ps] = (
                torch.sign(group_q[b]) * 127).to(torch.int8)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kv, sc, table, ln, P


def paged_int8_case(name, B, H, KH, Hd, ps, maxp, lengths, L=2, layer=1,
                    seed=0, timed=False, late_max=False, q_rep=1, tree=None):
    """K4 against its plain version in f32 on the same codes and scales,
    over the full L-layer fused pool read at `layer`, query by query
    (PAGED_INT8_RTOL of each (row, verify position)'s max |out|). With
    q_rep = R > 1 the R verify positions of each row (the packed nodes
    of `tree`) go through the kernel at once. Tail table slots point at
    an unused page; after the parity check the scales of that page and
    of sink page 0 are poisoned with NaN and the kernel's result must not
    change (it never reads them). A second launch must give the same
    bits (the page axis split across CTAs and merged included). `late_max`
    gives the slot every position sees last (the root, len - 1) a k that
    matches its query group, so the running max rises on the row's last
    page and the earlier pages' sums must be rescaled."""
    import torch

    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_int8 as pa8)

    R = q_rep
    q, kv, sc, table, ln, P = _paged_int8_inputs(
        B, H, KH, Hd, ps, maxp, lengths, L, layer, seed, late_max, R)

    def kernel(lay=layer):
        return pa8.paged_attention_int8(q, kv, sc, table, ln, lay, q_rep=R,
                                        tree=tree)

    def plain(qq):
        if R == 1:
            return pa8.paged_attention_int8_reference_fused(
                qq, kv[:, layer], sc[:, layer], table, ln.clamp(min=1))
        return pa8.paged_attention_int8_rep_reference(
            qq, kv[:, layer], sc[:, layer], table, ln.clamp(min=1),
            tree=tree)

    got = kernel()
    want = plain(q.float())
    repeat = bool(torch.equal(got, kernel()))
    torch.cuda.synchronize()
    diff = (got.float() - want).abs().reshape(B * R, -1).amax(1)
    row_max = want.abs().reshape(B * R, -1).amax(1)
    err = float(diff.max())
    row_rel = float((diff / row_max).max())
    out_min = float(row_max.min())
    del want
    saved = sc[:, :, :, [0, P - 1]].clone()
    sc[:, :, :, [0, P - 1]] = float("nan")
    poisoned = kernel()
    sc[:, :, :, [0, P - 1]] = saved
    torch.cuda.synchronize()
    unread = bool(torch.equal(poisoned, got))
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and unread and repeat and row_rel <= PAGED_INT8_RTOL
    plan = pa8.paged_int8_plan(B, KH, (H // KH) * R, Hd, ps, maxp,
                               n_sms())
    rec = {"phase": "paged_int8", "case": name, "B": B, "H": H, "KH": KH,
           "Hd": Hd, "ps": ps, "maxp": maxp, "L": L, "layer": layer,
           "q_rep": R, "tree": list(tree) if tree else None,
           "lengths": lengths if len(lengths) <= 16 else
           {"n": len(lengths), "min": min(lengths), "max": max(lengths),
            "sum": sum(lengths)},
           "late_max": late_max, "max_abs_err": err,
           "max_row_rel_err": row_rel, "rtol": PAGED_INT8_RTOL,
           "min_row_max_abs_out": out_min,
           "sink_and_tail_unread": unread, "repeat_identical": repeat,
           "plan": plan._asdict(), "finite": finite, "ok": ok}
    if timed:
        pairs, slots = _verify_pairs(lengths, R, tree, maxp * ps)
        # Codes and scales of the slots read (k and v: 2 Hd bytes + 2 f32
        # a token and kv head), q and the output once (bf16), the table
        # and lengths.
        n_bytes = slots * KH * (2 * Hd + 8) + 2.0 * 2 * q.numel() \
            + 4.0 * (table.numel() + B)
        flops = 4.0 * Hd * H * pairs
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)
        # Alternate the two layers so that one call's pages are not in L2
        # for the next (the decode path reads another layer every call).
        turn = [0]

        def alternating():
            turn[0] ^= 1
            kernel(turn[0])

        rec["ms"] = time_ms(alternating)
        rec["device_ms"] = device_ms(alternating, _kernel_fn(
            "paged_attention_int8"))
        rec["plain_ms"] = time_ms(lambda: plain(q), iters=3, warmup=1)
        # No single torch call takes a page table and int8 pages; SDPA
        # over K/V gathered and dequantized beforehand (neither timed) is
        # kept as a dense yardstick only, as for K2 and K5.
        rec["library_ms"] = None
        rec["sdpa_gathered_ms"], rec["sdpa_gathered_device_ms"] = \
            paged_int8_sdpa_gathered_ms(q, kv[:, layer], sc[:, layer], table,
                                        ln, R, tree)
        rec["gbytes_per_s"] = n_bytes / (rec["ms"] * 1e-3) / 1e9
    del kv, sc, got, poisoned
    torch.cuda.empty_cache()
    return rec


def paged_int8_sdpa_gathered_ms(q, kv, sc, table, ln, R, tree):
    """(loop ms, device ms) of SDPA over one layer's K/V gathered through
    the table and dequantized to bf16 beforehand (neither is timed), with
    K4's visibility as a boolean mask: lengths for q_rep 1, `pos < len +
    j` for query j of the linear verify form, the prefix and the
    ancestor chain for a tree (`_tree_keep`, K4's plain version's)."""
    import torch
    import torch.nn.functional as F

    from generativeaiexamples_tpu_torch.serving.paged_attention import (
        _gather_pages)
    from generativeaiexamples_tpu_torch.serving.paged_attention_int8 import (
        _tree_keep)

    def deq(i):
        return (_gather_pages(kv[i], table).float()
                * _gather_pages(sc[i], table)[..., None]).bfloat16()

    k, v = deq(0), deq(1)                                  # [B, KH, S, Hd]
    S, dev = k.shape[2], q.device
    qq = (q[:, None] if R == 1 else q).transpose(1, 2)     # [B, H, R, Hd]
    pos = torch.arange(S, device=dev)[None, None, :]
    length = ln.long().clamp(min=1)[:, None, None]
    jrow = torch.arange(R, device=dev)[None, :, None]
    keep = (_tree_keep(pos, length, jrow, R, tree) if tree is not None
            else pos < length + jrow)                       # [B, R, S]
    mask = keep[:, None]

    def sdpa():
        F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                       enable_gqa=True)

    out = time_ms(sdpa), device_ms(sdpa)
    del k, v, mask
    return out


def _paged_int8_timed_cases():
    """K4's timed cases: (name, B, maxp, lengths, seed, q_rep, tree) at the
    8B shape (H = 32, KH = 8, head_dim 128, page 128)."""
    import numpy as np

    b128 = np.linspace(1, 4096, 128).astype(int).tolist()
    b8 = [1, 17, 128, 129, 1000, 4096, 7000, 8191]
    # The spec_int8 burst's rows midway through their 64 tokens: each
    # prompt's tokens (its bytes and BOS) plus 32, in the engine's
    # 64-slot table.
    burst = [len(p) + 1 + 32 for p in _int8_prompts(128)]
    cases = [
        # K2's 8B decode case, on the int8 pool.
        ("8b_decode", 8, 64, b8, 21, 1, None),
        # The documented int8 deployment's batch.
        ("8b_b128", 128, 32, b128, 22, 1, None)]
    # The verify forms: linear k = 1 (R = 2, the r05 config) and k = 3
    # (R = 4), and the (3, 4) tree (R = 13), at B = 8 (one more page of
    # table so the deepest node fits) and B = 128.
    for tag, R, tree in (("qrep2", 2, None), ("qrep4", 4, None),
                         ("tree34", 13, (3, 4))):
        cases.append((f"{tag}_b8", 8, 65, b8, 26, R, tree))
        cases.append((f"{tag}_b128", 128, 33, b128, 27, R, tree))
    cases += [("tree34_burst", 128, 64, burst, 31, 13, (3, 4)),
              ("qrep2_burst", 128, 64, burst, 32, 2, None)]
    return cases


def phase_paged_int8():
    cases = [paged_int8_case(name, B, 32, 8, 128, 128, maxp, ln, seed=seed,
                             timed=True, q_rep=R, tree=tree)
             for name, B, maxp, ln, seed, R, tree in _paged_int8_timed_cases()]
    cases += [
        paged_int8_case("hd64", 4, 32, 8, 64, 128, 16, [1, 300, 1024, 2047],
                        seed=23),
        # A small page, G = 4, and a length-0 row (clamped to 1).
        paged_int8_case("ps16", 3, 8, 2, 128, 16, 32, [0, 16, 511], seed=24),
        # Each row's largest score on its last page: the earlier pages'
        # sums must be rescaled by the online softmax.
        paged_int8_case("late_max", 8, 32, 8, 128, 128, 64,
                        [129, 700, 1500, 2048, 3000, 4097, 6000, 8191],
                        seed=25, late_max=True),
        paged_int8_case("tree28", 8, 32, 8, 128, 128, 65,
                        [1, 17, 128, 129, 1000, 4096, 7000, 8191], seed=28,
                        q_rep=17, tree=(2, 8)),
        paged_int8_case("tree34_late_max", 8, 32, 8, 128, 128, 65,
                        [129, 700, 1500, 2048, 3000, 4097, 6000, 8180],
                        seed=29, late_max=True, q_rep=13, tree=(3, 4)),
        paged_int8_case("tree28_hd64_ps16", 4, 8, 2, 64, 16, 64,
                        [1, 50, 300, 1000], seed=30, q_rep=17, tree=(2, 8)),
        # A tensor-parallel rank's decode at 8B, tensor 2 (phase_tp).
        paged_int8_case("8b_tp2_ps16", 4, 16, 4, 128, 16, 64,
                        [67, 130, 203, 1024], seed=31),
        # The same rank's (3, 4) tree verify at batch 8 (phase_tp's
        # speculative leg).
        paged_int8_case("8b_tp2_tree34_ps16", 8, 16, 4, 128, 16, 64,
                        [1, 50, 67, 130, 203, 512, 900, 1011], seed=32,
                        q_rep=13, tree=(3, 4)),
    ]
    for c in cases:
        emit(c)
    return cases


# -- phase 6b: K5 -----------------------------------------------------------

# K5 parity, per (row, node) and relative to that node's max |out|: the
# kernel rounds the probabilities to bf16 before P.V (as K1 does) and its
# output once, each at most 2^-9 relative, and sums in another order than
# the f32 reference; 1e-2 leaves a 2.5x margin, while a wrong ancestor or
# a wrong rescale of earlier chunks is off by O(1) of the node's output.
TREE_RTOL = 1e-2


def _tree_inputs(B, H, KH, Hd, ps, maxp, lengths, tree, seed, late_max):
    """K5's inputs: bf16 q [B, H, r, Hd] scaled as in the K4 cases, two
    layers of bf16 pages [2, KH, P, ps, Hd] (k and v), a table naming
    shuffled pages with its tail slots at page P - 1 (never assigned),
    int32 lengths. `late_max` puts each row's largest score at its root
    slot."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    r = 1 + tree[0] * tree[1]
    P = B * maxp + 2
    q = (torch.randn((B, H, r, Hd), generator=g, device=dev)
         * PAGED_INT8_Q_SCALE).bfloat16()
    kp = torch.randn((2, KH, P, ps, Hd), generator=g, device=dev).bfloat16()
    vp = torch.randn((2, KH, P, ps, Hd), generator=g, device=dev).bfloat16()
    perm = torch.randperm(P - 2, generator=g, device=dev) + 1
    table = torch.full((B, maxp), P - 1, dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lengths):
        need = min(-(-(max(n, 1) + r - 1) // ps), maxp)
        table[b, :need] = perm[used:used + need].int()
        used += need
    if late_max:
        group_q = q.float().reshape(B, KH, H // KH, r, Hd).sum((2, 3))
        for b, n in enumerate(lengths):
            t = max(n, 1) - 1
            page = int(table[b, t // ps])
            kp[:, :, page, t % ps] = (torch.sign(group_q[b]) * 4).bfloat16()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, ln, P


def tree_case(name, B, H, KH, Hd, ps, maxp, lengths, tree, seed=0,
              timed=False, late_max=False):
    """K5 against `paged_tree_attention_reference` in f32 on the same bf16
    inputs (layer 1 of a two-layer pool), node by node (TREE_RTOL of each
    (row, node)'s max |out|). After the parity check the unused page the
    tail slots name and sink page 0 are poisoned with NaN and the
    kernel's result must not change. A second launch must give the same
    bits (the span split across CTAs and merged included)."""
    import torch
    import torch.nn.functional as F

    from generativeaiexamples_tpu_torch.serving import paged_attention as pa
    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_tree as pt)

    dev = torch.device("cuda")
    r = 1 + tree[0] * tree[1]
    q, kp2, vp2, table, ln, P = _tree_inputs(B, H, KH, Hd, ps, maxp, lengths,
                                             tree, seed, late_max)
    kp, vp = kp2[1], vp2[1]
    anc = pt._canonical_tree(*tree)
    got = pt.paged_tree_attention(q, kp, vp, table, ln, tree)
    repeat = bool(torch.equal(got, pt.paged_tree_attention(
        q, kp, vp, table, ln, tree)))
    want = pa.paged_tree_attention_reference(
        q.float(), kp.float(), vp.float(), table, ln.clamp(min=1), anc)
    torch.cuda.synchronize()
    per_node = lambda t: t.transpose(1, 2).reshape(B * r, -1)  # noqa: E731
    diff = per_node(got.float() - want).abs().amax(1)
    node_max = per_node(want).abs().amax(1)
    err = float(diff.max())
    node_rel = float((diff / node_max).max())
    del want
    saved = (kp[:, [0, P - 1]].clone(), vp[:, [0, P - 1]].clone())
    kp[:, [0, P - 1]] = float("nan")
    vp[:, [0, P - 1]] = float("nan")
    poisoned = pt.paged_tree_attention(q, kp, vp, table, ln, tree)
    kp[:, [0, P - 1]], vp[:, [0, P - 1]] = saved
    torch.cuda.synchronize()
    unread = bool(torch.equal(poisoned, got))
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and unread and repeat and node_rel <= TREE_RTOL
    plan = pa.paged_bf16_plan(B, KH, (H // KH) * r, Hd, ps, maxp, n_sms())
    rec = {"phase": "tree", "case": name, "B": B, "H": H, "KH": KH,
           "Hd": Hd, "ps": ps, "maxp": maxp, "tree": list(tree), "r": r,
           "lengths": lengths, "late_max": late_max, "max_abs_err": err,
           "max_node_rel_err": node_rel, "rtol": TREE_RTOL,
           "min_node_max_abs_out": float(node_max.min()),
           "sink_and_tail_unread": unread, "repeat_identical": repeat,
           "plan": plan._asdict(), "finite": finite, "ok": ok}
    if timed:
        pairs, slots = _verify_pairs(lengths, r, tree, maxp * ps)
        # K/V of the slots read (bf16), q and the output once, the table
        # and lengths.
        n_bytes = 2.0 * 2 * slots * KH * Hd + 2.0 * 2 * q.numel() \
            + 4.0 * (table.numel() + B)
        flops = 4.0 * Hd * H * pairs
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)
        turn = [0]

        def alternating():  # another layer's pages each call, as in K2's
            turn[0] ^= 1
            pt.paged_tree_attention(q, kp2[turn[0]], vp2[turn[0]], table,
                                    ln, tree)

        rec["ms"] = time_ms(alternating)
        rec["device_ms"] = device_ms(alternating,
                                     _kernel_fn("paged_attention_tree"))
        rec["host_ms"] = host_ms(alternating)
        rec["plain_ms"] = time_ms(lambda: pa.paged_tree_attention_reference(
            q, kp, vp, table, ln.clamp(min=1), anc), iters=3, warmup=1)
        # SDPA with a boolean mask over K/V gathered beforehand (the
        # gather is not timed), as a dense yardstick.
        S = maxp * ps
        k = pa._gather_pages(kp, table)
        v = pa._gather_pages(vp, table)
        rel = (torch.arange(S, device=dev)[None, :]
               - (ln.long().clamp(min=1) - 1)[:, None])         # [B, S]
        anc_t = torch.as_tensor(anc, device=dev)
        mask = (rel < 0)[:, None, :] | (
            ((rel >= 0) & (rel < r))[:, None, :]
            & anc_t[:, rel.clamp(0, r - 1)].transpose(0, 1))   # [B, r, S]

        def sdpa():
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None],
                                           enable_gqa=True)

        # No single torch call takes a page table (as for K2): the SDPA
        # time over K/V gathered beforehand is a dense yardstick only.
        rec["library_ms"] = None
        rec["sdpa_gathered_ms"] = time_ms(sdpa)
        rec["sdpa_gathered_device_ms"] = device_ms(sdpa)
        rec["gbytes_per_s"] = n_bytes / (rec["device_ms"] * 1e-3) / 1e9
        del k, v, mask
    del kp2, vp2, got, poisoned
    torch.cuda.empty_cache()
    return rec


# K5's timed cases at the 8B shape (H = 32, KH = 8, head_dim 128, page
# 128): (name, B, maxp, lengths, tree, seed). The bf16 tree engine's
# shape: batch 8, the (3, 4) lattice, lengths up to 8191 (one more table
# page for the tree).
K5_TIMED = (("8b_tree34", 8, 65, [1, 17, 128, 129, 1000, 4096, 7000, 8191],
             (3, 4), 51),)


def phase_tree():
    b8 = [1, 17, 128, 129, 1000, 4096, 7000, 8191]
    cases = [tree_case(name, B, 32, 8, 128, 128, maxp, lengths, tree,
                       seed=seed, timed=True)
             for name, B, maxp, lengths, tree, seed in K5_TIMED]
    cases += [
        tree_case("tree28_hd64_ps16", 4, 8, 2, 64, 16, 64,
                  [1, 50, 300, 1000], (2, 8), seed=52),
        # The smallest page the engine admits, with the span split.
        tree_case("tree34_ps8", 4, 32, 8, 128, 8, 130, [1, 9, 300, 1023],
                  (3, 4), seed=55),
        tree_case("tree28_8b", 8, 32, 8, 128, 128, 65, b8, (2, 8), seed=53),
        tree_case("late_max", 8, 32, 8, 128, 128, 65,
                  [129, 700, 1500, 2048, 3000, 4097, 6000, 8180], (3, 4),
                  seed=54, late_max=True),
        # A tensor-parallel rank's bf16 tree verify at 8B, tensor 2: 16
        # query and 4 kv heads, pages of 16, batch 8.
        tree_case("8b_tp2_tree34_ps16", 8, 16, 4, 128, 16, 64,
                  [1, 50, 67, 130, 203, 512, 900, 1011], (3, 4), seed=56),
    ]
    for c in cases:
        emit(c)
    return cases


# -- phase 7: K6 ------------------------------------------------------------

# Every quantized projection of Llama-3-8B as (K, M): wq and wo, wk/wv,
# w_gate/w_up, w_down, the lm head.
K6_SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024),
             "w_gate_up": (4096, 14336), "w_down": (14336, 4096),
             "lm_head": (4096, 128256)}
# Rows K6 meets on the int8 paths: decode at batch 8 and 128, the linear
# (k = 1) and tree ((3, 4)) verify steps at batch 128, a 4096 prefill.
K6_ROWS = (8, 128, 256, 1664, 4096)
# A tensor-parallel rank's shard of each projection at 8B, tensor 2
# (phase_tp): q, k|v, gate|up and the head split their outputs, wo and
# w_down their inputs; rows of a decode step at batch 4, of the (3, 4)
# tree verify (13 nodes a slot) over 4 and 8 slots, of the rider's
# 128-token chunk, a ragged count in the 256-row tile, and of the
# 4-prompt prefill group in the 128 bucket.
K6_TP_SHAPES = {"wq_tp2": (4096, 2048), "wk_wv_tp2": (4096, 512),
                "w_gate_up_tp2": (4096, 7168), "wo_tp2": (2048, 4096),
                "w_down_tp2": (7168, 4096), "lm_head_tp2": (4096, 64128)}
K6_TP_ROWS = (4, 52, 104, 128, 180, 512)


def int8_mm_case(name, R, K, M, seed=0, timed=True):
    """K6 against `int8_matmul_reference` in f32 (INT8_MM_RTOL of max |y|),
    then, when `timed`, timed with enough copies of the weight in rotation
    that none is in L2 when it is read (the path reads each weight once
    per forward): the kernel, the plain version, and torch.matmul over a
    pre-dequantized bf16 copy (a yardstick that moves twice the weight
    bytes; the port never calls it)."""
    import torch

    from generativeaiexamples_tpu_torch.ops.int8_matmul import (
        int8_matmul, int8_matmul_plan, int8_matmul_reference)
    from generativeaiexamples_tpu_torch.ops.quant import quantize_tensor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((R, K), generator=g, device=dev).bfloat16()
    qt = quantize_tensor(torch.randn((K, M), generator=g, device=dev)
                         * K ** -0.5)
    got = int8_matmul(x, qt.q, qt.s)
    # A second launch on the same inputs must give the same bits (the
    # split-K slices are summed in a fixed order).
    repeat_identical = bool(torch.equal(got, int8_matmul(x, qt.q, qt.s)))
    want = int8_matmul_reference(x, qt.q, qt.s, torch.float32)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got.float() - want).abs().max())
    finite = bool(torch.isfinite(got.float()).all())
    del want
    ok = finite and err <= INT8_MM_RTOL * scale and repeat_identical
    plan = int8_matmul_plan(R, K, M)
    n_bytes = 2.0 * R * K + K * M + 4.0 * M + 2.0 * R * M
    flops = 2.0 * R * K * M
    rec = {"phase": "int8_matmul", "case": name, "R": R, "K": K, "M": M,
           "max_abs_err": err, "y_max_abs": scale,
           "rel_err": err / scale, "tol_rel": INT8_MM_RTOL,
           "finite": finite, "repeat_identical": repeat_identical,
           "regime": plan.regime, "row_tile": plan.row_tile,
           "splits": plan.splits, "ctas": plan.tiles * plan.splits,
           "ok": ok}
    rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)
    if not timed:
        del got, qt, x
        return rec
    copies = [qt.q] + [qt.q.clone() for _ in range(
        min(15, int(150e6 // (K * M))))]
    turn = [0]

    def kernel():
        turn[0] = (turn[0] + 1) % len(copies)
        int8_matmul(x, copies[turn[0]], qt.s)

    rec["ms"] = time_ms(kernel)
    rec["device_ms"] = device_ms(kernel)
    rec["weight_copies"] = len(copies)
    rec["plain_ms"] = time_ms(lambda: int8_matmul_reference(x, qt.q, qt.s),
                              iters=3, warmup=1)
    del copies
    dense = [(qt.q.bfloat16() * qt.s.bfloat16())]
    dense += [dense[0].clone() for _ in range(
        min(15, int(150e6 // (2 * K * M))))]

    def library():
        turn[0] = (turn[0] + 1) % len(dense)
        torch.matmul(x, dense[turn[0]])

    rec["library_ms"] = time_ms(library)
    rec["library_device_ms"] = device_ms(library)
    rec["library"] = "torch.matmul over a pre-dequantized bf16 weight"
    rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    rec["gbytes_per_s"] = n_bytes / (rec["ms"] * 1e-3) / 1e9
    del dense, got, qt, x
    torch.cuda.empty_cache()
    return rec


def phase_int8_matmul():
    cases = []
    for wname, (K, M) in K6_SHAPES.items():
        for i, R in enumerate(K6_ROWS):
            cases.append(int8_mm_case(f"{wname}_r{R}", R, K, M, seed=31 + i))
            emit(cases[-1])
    for name, R, K, M in (("ragged_r37", 37, 4096, 4096),
                          ("ragged_m1000", 128, 4096, 1000)):
        cases.append(int8_mm_case(name, R, K, M, seed=40))
        emit(cases[-1])
    for wname, (K, M) in K6_TP_SHAPES.items():
        for R in K6_TP_ROWS:
            cases.append(int8_mm_case(f"{wname}_r{R}", R, K, M, seed=50,
                                      timed=False))
            emit(cases[-1])
    return cases


# -- phase 8: model steps on the card vs the plain forward ------------------


# The verify steps of phase model: linear k = 3 (r = 4 positions) and the
# (3, 4) tree (r = 13 nodes), both at the length the decode steps reach.
VERIFY_K, VERIFY_TREE = 3, (3, 4)


def _paged_steps(params, cfg, pool, toks, prompt_len, n_decode, dev,
                 bucket=256, ps=128):
    """The engine's prefill step over the first prompt_len tokens, then
    n_decode decode steps, then one linear and one tree verify step over
    the next tokens of `toks` (t0 and its drafts), on `dev`. Returns (the
    prefill and decode logits [V] each, the linear verify logits [r, V],
    the tree verify logits [r, V]), f32 on the CPU."""
    import torch

    from generativeaiexamples_tpu_torch.serving import engine_model
    from generativeaiexamples_tpu_torch.serving.kv_cache import (
        PageAllocator, SequencePages)

    seq = SequencePages(PageAllocator(pool.n_pages), ps, 4)
    seq.ensure(prompt_len)
    padded = torch.zeros((1, bucket), dtype=torch.int64)
    padded[0, :prompt_len] = toks[0, :prompt_len]
    row = torch.zeros((bucket // ps,), dtype=torch.int32)
    row[:len(seq.pages)] = torch.tensor(seq.pages)
    out = [engine_model.prefill_step(params, cfg, pool, padded.to(dev),
                                     prompt_len, row.to(dev)).float().cpu()]
    for t in range(prompt_len, prompt_len + n_decode):
        seq.ensure(t + 1)
        table = torch.tensor(seq.table_row()[None, :], device=dev)
        out.append(engine_model.decode_step(
            params, cfg, pool, toks[:, t].to(dev), table,
            torch.tensor([t + 1], dtype=torch.int32, device=dev))[0]
            .float().cpu())
    # Verify at length L: the committed prefix is the L - 1 tokens above.
    L = prompt_len + n_decode + 1
    k, m = VERIFY_TREE
    seq.ensure(L + k * m)
    table = torch.tensor(seq.table_row()[None, :], device=dev)
    length = torch.tensor([L], dtype=torch.int32, device=dev)
    lin = engine_model._decode_verify_once(
        params, cfg, pool, toks[:, L - 1:L + VERIFY_K].to(dev), table, length)
    anc = engine_model._tree_layout(k, m)[1]
    tree = engine_model._tree_verify_once(
        params, cfg, pool, toks[:, L - 1:L + k * m].to(dev), table, length,
        engine_model._tree_depths(k, m, dev), anc, k, m)
    return out, lin[0].float().cpu(), tree[0].float().cpu()


def _verify_check(got, want, tol):
    """(max |logit diff|, targets equal on every position whose f32 top-2
    margin exceeds 2 tol, positions so checked) for verify logits [r, V]:
    a smaller margin may flip under the card's bf16 rounding."""
    top2 = want.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
    same = got.argmax(-1) == want.argmax(-1)
    return (float((got - want).abs().max()), bool(same[sure].all()),
            int(sure.sum()))


def phase_model():
    """Engine prefill + decode steps (K1, K2) in bf16 on the card against
    the contiguous forward in f32 on the CPU over the same (bf16-rounded)
    weights. Tolerance 5e-2 on logits of scale ~1: the card path rounds
    every activation to bf16 through two layers (each rounding ~2^-9
    relative), the CPU path does not.

    Then the int8 variant: the same weights quantized on the card
    (int8 weights through K6, an int8 pool through K4), against the same
    engine steps in f32 on the CPU over the same codes and scales, with
    an int8 pool there too (tolerance INT8_MODEL_ATOL)."""
    import dataclasses

    import torch

    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.quant import (
        QuantizedTensor, quantize_llama_params)
    from generativeaiexamples_tpu_torch.serving.kv_cache import PagePool

    dev = torch.device("cuda")
    cfg = dataclasses.replace(
        llama.LlamaConfig.llama3_8b(), vocab_size=512, dim=512, n_layers=2,
        n_heads=8, n_kv_heads=2, head_dim=128, mlp_dim=1024, max_seq_len=512,
        dtype=torch.bfloat16)
    params = llama.init_params(cfg, dev, torch.Generator(dev).manual_seed(0))
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = llama.map_params(params, lambda t: t.float().cpu())
    prompt_len, n_decode = 150, 6
    g = torch.Generator().manual_seed(1)
    n_verify = 1 + VERIFY_TREE[0] * VERIFY_TREE[1]
    toks = torch.randint(0, cfg.vocab_size,
                         (1, prompt_len + n_decode + n_verify), generator=g)
    full, _ = llama.forward(cpu_params, cpu_cfg, toks[:, :prompt_len
                                                         + n_decode])
    want = [full[0, t] for t in range(prompt_len - 1, prompt_len + n_decode)]
    # The same verify steps in f32 on the CPU over the same weights.
    _, want_lin, want_tree = _paged_steps(
        cpu_params, cpu_cfg,
        PagePool.zeros(cpu_cfg, 8, 128, dtype=torch.float32, device="cpu"),
        toks, prompt_len, n_decode, "cpu")

    pool = PagePool.zeros(cfg, 8, 128, dtype=torch.bfloat16, device=dev)
    got, lin, tree = _paged_steps(params, cfg, pool, toks, prompt_len,
                                  n_decode, dev)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    verify = {name: dict(zip(("max_abs_err", "targets_equal",
                              "positions_checked"),
                             _verify_check(a, b, 5e-2)))
              for name, a, b in (("linear", lin, want_lin),
                                 ("tree", tree, want_tree))}
    rec = {"phase": "model", "variant": "bf16", "layers": cfg.n_layers,
           "dim": cfg.dim, "head_dim": cfg.head_dim, "prompt": prompt_len,
           "decode_steps": n_decode, "logit_scale": float(full.abs().max()),
           "max_abs_err": err, "tol": 5e-2, "verify": verify,
           "ok": err <= 5e-2 and all(
               v["max_abs_err"] <= 5e-2 and v["targets_equal"]
               for v in verify.values())}
    emit(rec)

    qparams = quantize_llama_params(params, dev)
    cpu_qparams = llama.map_params(qparams, lambda t: QuantizedTensor(
        t.q.cpu(), t.s.cpu()) if isinstance(t, QuantizedTensor)
        else t.float().cpu())
    qpool = PagePool.zeros(cfg, 8, 128, dtype=torch.int8, device=dev)
    cpu_qpool = PagePool.zeros(cpu_cfg, 8, 128, dtype=torch.int8,
                               device="cpu")
    got, lin, tree = _paged_steps(qparams, cfg, qpool, toks, prompt_len,
                                  n_decode, dev)
    want, want_lin, want_tree = _paged_steps(
        cpu_qparams, cpu_cfg, cpu_qpool, toks, prompt_len, n_decode, "cpu")
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    verify = {name: dict(zip(("max_abs_err", "targets_equal",
                              "positions_checked"),
                             _verify_check(a, b, INT8_MODEL_ATOL)))
              for name, a, b in (("linear", lin, want_lin),
                                 ("tree", tree, want_tree))}
    used = slice(1, None)  # page 0 is the sink
    code_diff = (qpool.kv[:, :, :, used].cpu().int()
                 - cpu_qpool.kv[:, :, :, used].int()).abs()
    irec = {"phase": "model", "variant": "int8 weights + int8 KV",
            "layers": cfg.n_layers, "prompt": prompt_len,
            "decode_steps": n_decode,
            "logit_scale": float(max(w.abs().max() for w in want)),
            "max_abs_err": err, "tol": INT8_MODEL_ATOL,
            "kv_codes_moved": int((code_diff > 0).sum()),
            # k and v codes of every layer, kv head and token written
            "kv_codes_written": 2 * cfg.n_layers * cfg.n_kv_heads
            * (prompt_len + n_decode + n_verify) * cfg.head_dim,
            "kv_code_max_move": int(code_diff.max()),
            "argmax_equal": all(int(a.argmax()) == int(b.argmax())
                                for a, b in zip(got, want)),
            "verify": verify,
            "ok": err <= INT8_MODEL_ATOL and all(
                v["max_abs_err"] <= INT8_MODEL_ATOL and v["targets_equal"]
                for v in verify.values())}
    emit(irec)
    rec["ok"] = rec["ok"] and irec["ok"]
    rec["int8"] = irec
    return rec


# -- phase 9: serving ------------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _stream_chat(base, max_tokens):
    """One streaming chat completion. Random weights over a 128256-token
    vocabulary rarely pick one of the byte tokenizer's 256 text ids, so
    most tokens carry no text: the check is the SSE framing and the
    finish reason, and the token count comes from the engine's metrics."""
    n_chunks, finish, text, done = 0, None, "", False
    with _post(base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Say something."}],
            "max_tokens": max_tokens, "stream": True}) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                done = True
                continue
            if not line.startswith("data: "):
                continue
            ch = json.loads(line[6:])["choices"][0]
            n_chunks += 1
            text += ch["delta"].get("content", "")
            if ch.get("finish_reason"):
                finish = ch["finish_reason"]
    return {"sse_chunks": n_chunks, "finish_reason": finish,
            "chars": len(text), "done_marker": done}


def _complete(base, prompt, max_tokens, **sampling):
    t0 = time.perf_counter()
    with _post(base + "/v1/completions", {"prompt": prompt,
                                          "max_tokens": max_tokens,
                                          **sampling}) as resp:
        body = json.loads(resp.read())
    ch = body["choices"][0]
    return {"completion_tokens": body["usage"]["completion_tokens"],
            "finish_reason": ch["finish_reason"],
            "seconds": time.perf_counter() - t0}


# Device function names of the port's kernels, for the profile windows.
# K2 and K5 share one body (csrc/paged_bf16.cuh) under two kernel names.
def _profile_window(run, check_key_averages: bool = False):
    """Where served time goes: torch.profiler around `run()` (which
    returns the completion tokens it produced), after the main path's
    counts were read. Device busy time is the sum of every device
    activity's self time (one stream, so activities do not overlap); the
    idle share is the rest of the window's wall time. `port_kernels_ms`
    sums the device time of each port kernel's instantiations. The rows
    come from the raw kineto events (`scripts.device_rows`);
    `check_key_averages` also builds `key_averages()` (~20 s for the
    serving window, ~40 s for a 128-stream burst) and records whether
    its device-time rows are the same."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tokens = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time_mark("profile_window_run")
    shared = _shared()
    rows = shared.device_rows(prof)
    time_mark("profile_window_processed")
    check = None
    if check_key_averages:
        old = _key_average_rows(prof)
        check = {"names": len(rows), "key_average_names": len(old),
                 "equal": sorted((k, n) for _, n, k in rows)
                 == sorted((k, n) for _, n, k in old) and all(
                     abs(a[0] - b[0]) <= 1e-6 * max(1.0, a[0]) for a, b in
                     zip(sorted(rows, key=lambda r: r[2]),
                         sorted(old, key=lambda r: r[2])))}
        time_mark("profile_window_key_averages")
    busy_ms = sum(ms for ms, _, _ in rows)
    return {"wall_ms": wall_ms, "completion_tokens": tokens,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if rows else None,
            "device_activities": sum(n for _, n, _ in rows),
            "port_kernels_ms": {
                name: sum(ms for ms, _, k in rows if fn in k)
                for name, fn in shared.KERNEL_FUNCTIONS.items()},
            "port_kernel_instances": {
                name: [{"name": k[:120], "ms": ms, "count": n}
                       for ms, n, k in rows if fn in k]
                for name, fn in shared.KERNEL_FUNCTIONS.items()},
            "top": [{"name": k[:90], "ms": ms, "count": n}
                    for ms, n, k in rows[:10]],
            **({"key_averages_check": check} if check else {})}


def _key_average_rows(prof) -> list:
    """The rows of `key_averages()` with device time, as (ms, count,
    key), largest first."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:  # older torch
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    return sorted(rows, reverse=True)


def _recording_server(engine):
    """The port's OpenAIServer over `engine`, which also keeps the last
    request's generated token ids under its prompt ids (`streams`): random
    weights rarely emit text, so streams are compared by token. `times`
    keeps when each token event reached the server's handler thread (where
    its SSE frame would be written), on the host's perf_counter clock."""
    from generativeaiexamples_tpu_torch.serving.openai_server import (
        OpenAIServer)

    class RecordingServer(OpenAIServer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.streams = {}
            self.times = {}

        def _events(self, req):
            ids = self.streams[tuple(req.prompt_ids)] = []
            times = self.times[tuple(req.prompt_ids)] = []
            for ev in OpenAIServer._events(req):
                if ev["token_id"] >= 0:
                    ids.append(ev["token_id"])
                    times.append(time.perf_counter())
                yield ev

    return RecordingServer(engine, model_name="llama3-8b-random")


def _release_engine(engine) -> None:
    """Drop a finished engine's device memory even if something still
    holds the engine: its page pool, its CUDA graphs (their pools) and
    its static scratch."""
    engine.pool = None
    engine._graphs = None
    engine._scratch_store = None


def _release_device_memory() -> dict:
    """Before the rank processes' phase: stop and release every engine
    an earlier phase left alive (its pool, CUDA graphs and scratch), drop
    cuBLAS's per-stream workspaces (one for each capture stream graphs
    were captured on) and return the cached blocks. Returns this
    process's allocated and reserved bytes before and after, the engines
    found and the segments still reserved by memory pool."""
    import torch

    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine

    gib = 2**30
    out = {"allocated_gib_before": torch.cuda.memory_allocated() / gib,
           "reserved_gib_before": torch.cuda.memory_reserved() / gib}
    engines = [o for o in gc.get_objects() if isinstance(o, LLMEngine)]
    out["engines_found"] = len(engines)
    for eng in engines:
        eng.stop()
        _release_engine(eng)
    del engines[:]
    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    pools: dict = {}
    for seg in torch.cuda.memory_snapshot():
        key = str(tuple(seg["segment_pool_id"]))
        n, total, alloc = pools.get(key, (0, 0, 0))
        pools[key] = (n + 1, total + seg["total_size"],
                      alloc + seg["allocated_size"])
    return {**out, "allocated_gib": torch.cuda.memory_allocated() / gib,
            "reserved_gib": torch.cuda.memory_reserved() / gib,
            "segments_by_pool": {k: {"segments": n, "total_gib": t / gib,
                                     "allocated_gib": a / gib}
                                 for k, (n, t, a) in pools.items()}}


class ServedEngine:
    """The 8B engine behind the port's OpenAI server on a local port,
    shared by the serving, chunked-prefill and RAG phases (bf16, default
    engine config) and, on its own, by serving_int8 (`engine_cfg`,
    `n_pages`, warmed at `warmup_buckets` only, and with `sampled` as
    LLMEngine.warmup takes it); the speculative phases hand in an
    `engine` built over weights already on the card. The
    server records each request's token ids (`app.streams`).
    `model_size` and `device` exist so the phases can be rehearsed on
    the CPU at tiny size; the check runs them at 8b on cuda."""

    def __init__(self, model_size: str = "8b", device: str = "cuda",
                 engine_cfg=None, n_pages=None, warmup_buckets=None,
                 engine=None, sampled=None):
        from generativeaiexamples_tpu_torch.serving.__main__ import (
            build_engine)
        from generativeaiexamples_tpu_torch.serving.openai_server import (
            make_http_server)

        t0 = time.perf_counter()
        self.engine = engine or build_engine(
            model_size, device=device, seed=0, warmup=False,
            engine_cfg=engine_cfg, n_pages=n_pages)
        self.build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.engine.warmup(buckets=warmup_buckets, sampled=sampled)
        self.warm_s = time.perf_counter() - t0
        time_mark("served_engine_warm")
        self.engine.start()
        self.app = _recording_server(self.engine)
        self.httpd = make_http_server(self.app, "127.0.0.1", 0)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=30)
        self.engine.stop()
        # The pool stays for the phases that read it after the close.
        self.engine._graphs = None
        self.engine._scratch_store = None


def phase_serving(card: str, served: ServedEngine):
    import torch

    from generativeaiexamples_tpu_torch import kernels

    base, engine = served.base, served.engine
    torch.cuda.synchronize()
    kernels.reset_launches()
    stream = _stream_chat(base, 32)
    single = _complete(base, "The quick brown fox", 32)
    results = [None] * 4

    def run(i):
        # The last one samples (temperature, top-k, top-p on the device),
        # so the batch takes the masked-sampling path.
        sampling = ({"temperature": 0.7, "top_p": 0.9, "top_k": 40}
                    if i == 3 else {})
        results[i] = _complete(base, f"Request number {i}:", 64, **sampling)

    t1 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t1
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        health = json.loads(r.read())
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        metrics = json.loads(r.read())
    profile = _profile_window(lambda: _complete(
        base, "Profile window", 32)["completion_tokens"])
    conc_tokens = sum(r["completion_tokens"] for r in results if r)

    def finished_ok(r, want):
        return r is not None and (r["completion_tokens"] == want
                                  or r["finish_reason"] in ("length", "stop"))

    ok = (stream["finish_reason"] in ("length", "stop")
          and stream["done_marker"]
          and finished_ok(single, 32)
          and all(finished_ok(r, 64) for r in results)
          and health.get("status") == "healthy"
          and launches["flash_attention"] > 0
          and launches["paged_attention"] > 0)
    rec = {"phase": "serving", "model": "llama3_8b random bf16",
           "layers": engine.cfg.n_layers, "card": card,
           "engine_build_s": served.build_s, "warmup_s": served.warm_s,
           "stream": stream, "single": single,
           "concurrent": results, "concurrent_wall_s": wall,
           "concurrent_tokens_per_s": conc_tokens / wall if wall else None,
           "ttft_p50_ms": metrics.get("ttft_p50_ms"),
           "ttft_p95_ms": metrics.get("ttft_p95_ms"),
           "tokens_generated": metrics.get("tokens_generated"),
           "mean_batch_occupancy": metrics.get("mean_batch_occupancy"),
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "profile": profile, "ok": ok}
    emit(rec)
    return rec


# -- phase 9b: the flight recorder at 8B -------------------------------------

ROOT_DIR = os.path.dirname(os.path.abspath(__file__))


def _flight_report(trace: dict, name: str) -> dict:
    """A /debug/timeline payload (Chrome trace JSON): it must survive a
    JSON round trip and its spans must nest; saved as
    build/flight_<name>.json, then split into device busy, host gap and
    idle by `scripts/analyze_timeline.py <file> --json` in a subprocess.
    The attribution must sum to 100% of the timeline's wall time."""
    from generativeaiexamples_tpu_torch.serving.flight import spans_nest

    text = json.dumps(trace)
    round_trip = json.loads(text) == trace
    os.makedirs(os.path.join(ROOT_DIR, "build"), exist_ok=True)
    path = os.path.join("build", f"flight_{name}.json")
    with open(os.path.join(ROOT_DIR, path), "w") as f:
        f.write(text)
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts", "analyze_timeline.py"),
         path, "--json"], cwd=ROOT_DIR, capture_output=True, text=True,
        timeout=120)
    events = trace["traceEvents"]
    rec = {"file": path, "bytes": len(text),
           "beats": sum(e.get("cat") == "beat" for e in events),
           "events": len(events), "round_trip": round_trip,
           "spans_nest": spans_nest(trace), "analyzer_rc": proc.returncode}
    if proc.returncode != 0:
        rec["analyzer_stderr"] = proc.stderr[-2000:]
        rec["ok"] = False
        return rec
    overall = json.loads(proc.stdout)["overall"]
    pct = {c: v["pct"] for c, v in overall["categories"].items()}
    rec.update(wall_ms=overall["wall_ms"],
               attributed_pct=overall["attributed_pct"],
               attribution_pct=pct, top_causes=overall["top_causes"],
               device_busy_pct=pct.get("device_busy", 0.0))
    rec["ok"] = (round_trip and rec["spans_nest"] and rec["beats"] > 0
                 and abs(overall["attributed_pct"] - 100.0) < 0.5)
    return rec


def _get_text(url: str, timeout: float = 60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode(), dict(r.headers)


def _greedy_burst(base, n: int, max_tokens: int) -> float:
    """phase_serving's concurrent completions, all greedy: n at once;
    returns the wall seconds."""
    t0 = time.perf_counter()
    threads = [threading.Thread(target=_complete, args=(
        base, f"Request number {i}:", max_tokens)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return time.perf_counter() - t0


def phase_flight(card: str, served: ServedEngine, n_requests: int = 4,
                 max_tokens: int = 64):
    """The flight recorder (on by default) after the serving phase, on
    the same server: /debug/timeline (round trip, nesting, the analyzer's
    attribution of device busy / host gap / idle, saved under build/),
    /metrics?format=prometheus (the eight hist_* histograms) and
    /health's flight_recorder section. Then its cost: the serving phase's
    concurrent completions (all greedy here) with the recorder on, the
    host time of its record_* calls per beat against the mean beat
    interval, and the same completions with the recorder off: tokens/s
    of both, and the streams must be byte-identical (recording observes,
    never steers). In both runs admission waits until all the burst's
    requests are queued, so both admit them in one batched prefill: the
    streams then depend on the recorder alone, not on how the HTTP
    threads happened to arrive (a prefill of another row count tiles its
    bf16 matmuls otherwise, and random weights flip greedy near-ties)."""
    from generativeaiexamples_tpu_torch.serving.flight import HIST_KEYS

    base, engine = served.base, served.engine
    t_phase = time.perf_counter()
    text, _ = _get_text(base + "/debug/timeline")
    timeline = _flight_report(json.loads(text), "serving")
    prom, headers = _get_text(base + "/metrics?format=prometheus")
    hists_present = {k: f"# TYPE gaie_{k[len('hist_'):]} histogram" in prom
                     for k in HIST_KEYS}
    health = json.loads(_get_text(base + "/health")[0])["flight_recorder"]

    rec_s = [0.0]
    fl = engine.flight

    def timed(fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            fn(*args, **kw)
            rec_s[0] += time.perf_counter() - t0
        return call

    prompts = [tuple(engine.tokenizer.encode(f"Request number {i}:",
                                             add_bos=True))
               for i in range(n_requests)]

    def gated(admit):
        # Opens once the burst is queued (or after 30 s, so a request
        # that never arrives fails the comparison instead of hanging).
        opened, t_gate = [False], time.perf_counter()

        def call():
            opened[0] = (opened[0] or len(engine.waiting) >= n_requests
                         or time.perf_counter() - t_gate > 30.0)
            return admit() if opened[0] else False
        return call

    streams, runs = {}, {}
    for on in (True, False):
        fl.set_enabled(on)
        fl.record_beat, fl.record_event = (timed(fl.record_beat),
                                           timed(fl.record_event))
        engine._admit_waiting = gated(engine._admit_waiting)
        rec_s[0] = 0.0
        beats0, t0 = fl.stats()["flight_beats"], time.perf_counter()
        try:
            wall = _greedy_burst(base, n_requests, max_tokens)
        finally:
            # The class's methods again.
            del fl.record_beat, fl.record_event, engine._admit_waiting
        n_beats = fl.stats()["flight_beats"] - beats0
        streams[on] = [served.app.streams.get(p) for p in prompts]
        tokens = sum(len(x or ()) for x in streams[on])
        runs["on" if on else "off"] = {
            "wall_s": wall, "completion_tokens": tokens,
            "tokens_per_s": tokens / wall if wall else None,
            "beats": n_beats, "record_host_ms": rec_s[0] * 1e3}
        if on:
            ready = [float(b["t_ready"]) for b in fl.snapshot_beats()
                     if b["t_dispatch"] >= t0]
            interval = ((ready[-1] - ready[0]) / (len(ready) - 1)
                        if len(ready) > 1 else None)
            per_beat_us = rec_s[0] * 1e6 / n_beats if n_beats else None
            runs["on"].update(
                record_host_us_per_beat=per_beat_us,
                mean_beat_interval_ms=interval * 1e3 if interval else None,
                record_share_of_beat=(per_beat_us * 1e-6 / interval
                                      if interval and per_beat_us else None))
    fl.set_enabled(True)
    identical = streams[True] == streams[False] and all(streams[True])
    ok = (timeline["ok"] and all(hists_present.values())
          and headers.get("X-Prometheus-Exposition-Version") == "0.0.4"
          and health["enabled"] and health["flight_beats"] > 0
          and runs["off"]["beats"] == 0 and runs["on"]["beats"] > 0
          and identical)
    rec = {"phase": "flight", "card": card, "timeline": timeline,
           "prometheus_bytes": len(prom), "hists_present": hists_present,
           "health": health, "requests": n_requests,
           "max_tokens": max_tokens, "runs": runs,
           "streams_identical_on_off": identical,
           "seconds": time.perf_counter() - t_phase, "ok": ok}
    emit(rec)
    return rec


# -- phase 9c: the emission pacer at 8B --------------------------------------


def _gaps_ms(times):
    """p50, p95 and max of the gaps between a stream's decode tokens (the
    first token's wait is TTFT, not a gap)."""
    gaps = sorted((b - a) * 1e3 for a, b in zip(times[1:], times[2:]))
    if not gaps:
        return {"p50": None, "p95": None, "max": None}
    return {"p50": _pct(gaps, 0.5), "p95": _pct(gaps, 0.95),
            "max": gaps[-1]}


def phase_pacer(card: str, served: ServedEngine, n_streams: int = 4,
                max_tokens: int = 64):
    """The emission pacer on the served engine: n_streams greedy
    max_tokens-token completions at once, with pace_emission_max_streams
    at the JAX default of 16, then at 0 (pacing off) on the same engine
    (`_pace_decide` reads the limit at every block); K1 and K2 must
    launch over the two runs. Admission waits until
    the burst is queued, so both runs prefill it in one group and the
    streams depend on the pacer alone. Each stream's tokens must be equal
    in both runs (same ids, same order); per stream, the gaps between its
    decode tokens where the server's handler receives them (p50, p95,
    max: the SSE cadence) and the time to its first token are printed for
    both, with the blocks the pacer spread (commits with held tokens)."""
    import dataclasses

    import torch

    from generativeaiexamples_tpu_torch import kernels

    base, engine = served.base, served.engine
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launches()
    prompts = [f"Pacer stream {i}:" for i in range(n_streams)]
    keys = [tuple(engine.tokenizer.encode(p, add_bos=True)) for p in prompts]
    original = engine.ecfg
    commits = [0, 0]
    real_commit = engine._pace_commit

    def commit(slot, now):
        commits[0] += 1
        commits[1] += bool(slot.pace_buf)
        real_commit(slot, now)

    limits = (16, 0)
    runs, streams = {}, {}
    try:
        for limit in limits:
            engine.ecfg = dataclasses.replace(
                original, pace_emission_max_streams=limit)
            opened, t_gate = [False], time.perf_counter()
            admit = engine._admit_waiting

            def gated():
                opened[0] = (opened[0] or len(engine.waiting) >= n_streams
                             or time.perf_counter() - t_gate > 30.0)
                return admit() if opened[0] else False

            engine._admit_waiting = gated
            engine._pace_commit = commit
            commits[:] = [0, 0]
            results = [None] * n_streams
            starts = [None] * n_streams

            def run(i):
                starts[i] = time.perf_counter()
                results[i] = _complete(base, prompts[i], max_tokens)

            try:
                threads = [threading.Thread(target=run, args=(i,))
                           for i in range(n_streams)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
            finally:
                del engine._admit_waiting, engine._pace_commit
            streams[limit] = [list(served.app.streams.get(k, ()))
                              for k in keys]
            times = [list(served.app.times.get(k, ())) for k in keys]
            runs[str(limit)] = {
                "pace_emission_max_streams": limit,
                "finish": [r["finish_reason"] if r else None
                           for r in results],
                "tokens": [len(x) for x in streams[limit]],
                "first_token_ms": [(t[0] - s) * 1e3 if t and s else None
                                   for t, s in zip(times, starts)],
                "gap_ms": [_gaps_ms(t) for t in times],
                "commits": commits[0], "paced_commits": commits[1]}
    finally:
        engine.ecfg = original
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    on, off = (str(x) for x in limits)
    identical = (streams[limits[0]] == streams[limits[1]]
                 and all(streams[limits[0]]))
    ok = (identical and runs[on]["paced_commits"] > 0
          and runs[off]["paced_commits"] == 0
          and all(f in ("length", "stop") for r in runs.values()
                  for f in r["finish"])
          and launches["flash_attention"] > 0
          and launches["paged_attention"] > 0)
    rec = {"phase": "pacer", "card": card, "streams": n_streams,
           "max_tokens": max_tokens, "runs": runs, "launches": launches,
           "streams_identical_on_off": identical,
           "seconds": time.perf_counter() - t_phase, "ok": ok}
    emit(rec)
    return rec


# -- phase 10: chunked long prefill at 8B ---------------------------------


def phase_chunked(served: ServedEngine, prompt_len: int = 6000):
    """A ~6k-token prompt (beyond the 4096 bucket) through the server:
    the engine's chunked lane must launch K1 (with q_offset > 0 on the
    second chunk). Then the first-token logits of the engine's chunk
    steps over the same prompt against the port's one-shot forward.
    Tolerance CHUNK_LOGIT_ATOL: both sides are bf16 on the card through
    32 layers; they differ only where cuBLAS tiles the two matmul shapes
    differently, and each such bf16 rounding flip (2^-8 relative) feeds
    the residual stream of every later layer."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.serving import engine_model

    engine = served.engine
    g = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, 256, (prompt_len,), generator=g).tolist()
    torch.cuda.synchronize()
    kernels.reset_launches()
    served_rec = _complete(served.base, prompt, 8)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    # The engine's chunk steps (what _advance_long_prefills dispatches)
    # against one forward over the whole prompt, same weights.
    dev = engine.device
    chunk = engine.buckets[-1]
    s_total = -(-prompt_len // chunk) * chunk
    cache = llama.KVCache.zeros(engine.cfg, 1, max_len=s_total, device=dev)
    t0 = time.perf_counter()
    for pos in range(0, prompt_len, chunk):
        part = prompt[pos:pos + chunk]
        width = engine._pick_chunk_width(len(part), chunk, s_total)
        tok = torch.zeros((1, width), dtype=torch.int32)
        tok[0, :len(part)] = torch.tensor(part)
        chunked, cache = engine_model.prefill_chunk_step(
            engine.params, engine.cfg, cache, tok.to(dev), len(part))
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    with torch.no_grad():
        x, _ = llama.forward_hidden(engine.params, engine.cfg,
                                    torch.tensor([prompt], device=dev))
        oneshot = llama.logits_from_hidden(engine.cfg, engine.params,
                                           x[:, -1:])[0, 0]
    torch.cuda.synchronize()
    err = float((chunked.float() - oneshot.float()).abs().max())
    del cache, x
    k_cap = _k_cap_check(served, prompt, list(served.app.streams[
        tuple(prompt)]))
    ok = (served_rec["completion_tokens"] >= 1
          and launches["flash_attention"] >= 2 * engine.cfg.n_layers
          and err <= CHUNK_LOGIT_ATOL and bool(torch.isfinite(chunked).all())
          and k_cap["ok"])
    rec = {"phase": "chunked", "prompt_tokens": prompt_len, "chunk": chunk,
           "served": served_rec, "launches": launches,
           "chunk_steps_s": chunked_s,
           "logit_scale": float(oneshot.float().abs().max()),
           "first_token_logit_max_abs_err": err, "tol": CHUNK_LOGIT_ATOL,
           "argmax_equal": int(chunked.argmax()) == int(oneshot.argmax()),
           "prefill_decode_k_cap": k_cap, "ok": ok}
    emit(rec)
    return rec


def _k_cap_run(served, prompt, shorts, chunks_per_block: int,
               max_tokens: int):
    """The short greedy prompts admitted one at a time (each its own
    prefill group, as when run alone), then `prompt` through the chunked
    lane while they decode, with engine.prefill_chunks_per_block set to
    `chunks_per_block` for the run. Returns each plain decode block's K
    with whether a chunked prefill was in progress at its dispatch (a spy
    on engine_model.plan_step, which sees every block, replayed as a
    CUDA graph or not; removed after) and the streams' tokens (shorts,
    then prompt)."""
    import dataclasses

    from generativeaiexamples_tpu_torch.serving import engine_model

    engine, streams = served.engine, served.app.streams
    real = engine_model.plan_step
    log = []

    def spy(params, cfg, plan, **kw):
        if plan.decode_k and not plan.spec_k:
            log.append((plan.decode_k, bool(engine._long_prefills)))
        return real(params, cfg, plan, **kw)

    saved = engine.ecfg
    engine.ecfg = dataclasses.replace(
        saved, prefill_chunks_per_block=chunks_per_block)
    engine_model.plan_step = spy
    threads = []
    try:
        for p in shorts:
            streams.pop(tuple(p), None)
            t = threading.Thread(target=_complete,
                                 args=(served.base, p, max_tokens))
            t.start()
            threads.append(t)
            deadline = time.time() + 60
            while len(streams.get(tuple(p), ())) < 2 \
                    and time.time() < deadline:
                time.sleep(0.001)
        long_rec = _complete(served.base, prompt, 8)
        for t in threads:
            t.join(timeout=600)
    finally:
        engine_model.plan_step = real
        engine.ecfg = saved
    live = [k for k, lv in log if lv]
    return {"chunks_per_block": chunks_per_block,
            "blocks": len(log), "blocks_while_prefilling": len(live),
            "k_while_prefilling": sorted(set(live)),
            "k_otherwise": sorted({k for k, lv in log if not lv}),
            "long_completion_tokens": long_rec["completion_tokens"]
            }, [list(streams[tuple(p)]) for p in (*shorts, prompt)]


def _k_cap_check(served, prompt, long_alone, n_short: int = 3,
                 max_tokens: int = 32):
    """engine.prefill_decode_k_cap on the card: `n_short` greedy streams
    decode while the ~6k-token prompt prefills in chunks. Three streams,
    not two: at most a quarter of the batch decoding already caps K at 2
    (the low-occupancy rule), which would hide the rule under test. Run
    at the default prefill_chunks_per_block (2: the prompt's two chunks
    go out in one beat, so no decode block is dispatched in between),
    then at 1, where the blocks between the chunks must take K <= the
    cap. The streams must equal the same requests run alone."""
    import torch

    cap = served.engine.ecfg.prefill_decode_k_cap
    g = torch.Generator().manual_seed(7)
    shorts = [torch.randint(0, 256, (48 + 16 * i,), generator=g).tolist()
              for i in range(n_short)]
    alone = []
    for p in shorts:
        _complete(served.base, p, max_tokens)
        alone.append(list(served.app.streams[tuple(p)]))
    alone.append(long_alone)
    runs = []
    for cpb in (served.engine.ecfg.prefill_chunks_per_block, 1):
        run, got = _k_cap_run(served, prompt, shorts, cpb, max_tokens)
        run["streams_equal_alone"] = [g == w for g, w in zip(got, alone)]
        runs.append(run)
    ok = (cap == 2 and runs[-1]["blocks_while_prefilling"] >= 1
          and all(max(r["k_while_prefilling"], default=0) <= cap
                  and all(r["streams_equal_alone"]) for r in runs))
    return {"cap": cap, "short_streams": n_short,
            "short_max_tokens": max_tokens, "runs": runs, "ok": ok}


# -- phase 10b: the fused prefill rider at 8B ------------------------------

# The engines of phase_fused_prefill: the chunked lane alone (A), the
# rider at a 512-token budget (B), and the lane with the unfused finish
# (C: sample_token + set_last_token after the last chunk); then two tree
# engines (k = 3, M = 4): the rider knob without step plans (D: the lane
# carries every chunk) and composed plans (E: the chunks ride inside the
# verify steps).
FUSED_RUNS = (("A_lane", {}),
              ("B_rider", {"fused_prefill": True, "fused_token_budget": 512}),
              ("C_unfused_finish", {"fused_sampling": False}))
SPEC_TREE = {"speculative_k": 3, "speculative_tree_branches": 4}
# The rider is judged by the short streams' gaps while a prompt prefills,
# which the emission pacer would spread: its engines run unpaced, as
# they did before the pacer came.
UNPACED = {"pace_emission_max_streams": 0}
SPEC_FUSED_RUNS = (
    ("D_spec_lane", {**SPEC_TREE, **dict(FUSED_RUNS)["B_rider"]}),
    ("E_spec_rider", {**SPEC_TREE, **dict(FUSED_RUNS)["B_rider"],
                      "step_plans": True}))


def _timed_stream(engine, prompt, max_tokens, out: dict) -> None:
    """One greedy request through engine.submit; `out` gets its token ids
    and the host time each reached the stream."""
    from generativeaiexamples_tpu_torch.serving.engine import GenRequest

    req = engine.submit(GenRequest(prompt_ids=list(prompt),
                                   max_new_tokens=max_tokens))
    out.update(submit=req.submit_time, tokens=[], times=[])
    while True:
        ev = req.stream.get()
        if ev["token_id"] >= 0:
            out["times"].append(time.perf_counter())
            out["tokens"].append(ev["token_id"])
        if ev["finished"]:
            out["finish"] = ev["finish_reason"]
            return


def _alone(engine, prompt, max_tokens) -> list:
    out = {}
    _timed_stream(engine, prompt, max_tokens, out)
    return out["tokens"]


def _fused_run(engine, prompt, shorts, max_tokens: int, long_tokens: int):
    """The short greedy prompts admitted one at a time (each its own
    prefill group, as when run alone), then `prompt` while they decode.
    A spy on engine_model.plan_step counts the prompt tokens each kind of
    plan fed (riders: decode_k > 0; the chunked lane: chunk-only plans).
    Returns the run's record and the streams (shorts, then prompt)."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving import engine_model

    fed = {"rider": 0, "lane": 0}
    real = engine_model.plan_step

    def spy(params, cfg, plan, **kw):
        if plan.rider_width:
            fed["rider" if plan.decode_k else "lane"] += kw["chunk_valid"]
        return real(params, cfg, plan, **kw)

    before = engine.metrics.snapshot()
    outs = [{} for _ in range(len(shorts) + 1)]
    threads = []
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    engine_model.plan_step = spy
    try:
        for i, p in enumerate(shorts):
            t = threading.Thread(target=_timed_stream,
                                 args=(engine, p, max_tokens, outs[i]))
            t.start()
            threads.append(t)
            deadline = time.time() + 60
            while len(outs[i].get("tokens", ())) < 2 \
                    and time.time() < deadline:
                time.sleep(0.001)
        _timed_stream(engine, prompt, long_tokens, outs[-1])
        for t in threads:
            t.join(timeout=600)
    finally:
        engine_model.plan_step = real
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    after = engine.metrics.snapshot()
    delta = {k: after[k] - before[k] for k in (
        "fused_steps", "fused_prefill_tokens", "prefill_stall_beats",
        "fused_sample_dispatches", "prefill_tokens")}
    long_out = outs[-1]
    t_sub, t_first = long_out["submit"], long_out["times"][0]
    # Every inter-token gap of a short stream that overlaps the prompt's
    # prefill (its submission to its first token).
    gaps = [(b - a) * 1e3 for o in outs[:-1]
            for a, b in zip(o["times"], o["times"][1:])
            if b > t_sub and a < t_first]
    rec = {"ttft_ms": (t_first - t_sub) * 1e3,
           "short_gaps_while_prefilling": len(gaps),
           "short_gap_p50_ms": float(np.percentile(gaps, 50)) if gaps
           else None,
           "short_gap_max_ms": max(gaps) if gaps else None,
           "tokens_fed": fed, **delta,
           "launches": {k: launches[k] for k in (
               "flash_attention", "paged_attention", "paged_attention_tree",
               "paged_attention_int8", "int8_matmul")},
           "finish": [o["finish"] for o in outs]}
    return rec, [o["tokens"] for o in outs]


def _fused_checks(name, rec, got, alone, prompt_len, need, never) -> bool:
    """The run's streams against the same requests run alone, the
    kernels that must (`need`) and must not (`never`) launch, and the
    counters of its engine kind: a run named *rider must ride, any other
    must not; C counts no fused sample."""
    rec["streams_equal_alone"] = [g == w for g, w in zip(got, alone)]
    rec["first_divergence"] = [_first_divergence(g, w)
                               for g, w in zip(got, alone)]
    fed, lc = rec["tokens_fed"], rec["launches"]
    ok = (all(rec["streams_equal_alone"])
          and fed["rider"] + fed["lane"] == prompt_len
          and rec["fused_prefill_tokens"] == fed["rider"]
          and all(lc[k] > 0 for k in need)
          and all(lc[k] == 0 for k in never))
    if name.endswith("rider"):
        ok = ok and rec["fused_steps"] >= 1 and fed["rider"] > 0
    else:
        ok = ok and rec["fused_steps"] == 0 and fed["rider"] == 0
    if name.startswith("C"):
        ok = ok and rec["fused_sample_dispatches"] == 0
    return ok and rec["flight"]["ok"]


# The kernels each kind of fused-prefill run must launch, and must not.
BF16_KERNELS = (("flash_attention", "paged_attention"),
                ("paged_attention_int8", "int8_matmul"))
SPEC_BF16_KERNELS = (("flash_attention", "paged_attention_tree"),
                     ("paged_attention", "paged_attention_int8"))
INT8_KERNELS = (("flash_attention", "paged_attention_int8", "int8_matmul"),
                ("paged_attention", "paged_attention_tree"))


def _fused_traffic(seed: int, prompt_len: int, n_short: int):
    """The long prompt and the short prompts (48, 64, ... tokens) of a
    fused-prefill run, random bytes from `seed`."""
    import torch

    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, 256, (prompt_len,), generator=g).tolist()
    shorts = [torch.randint(0, 256, (48 + 16 * i,), generator=g).tolist()
              for i in range(n_short)]
    return prompt, shorts


def _fused_engine_run(name, params, cfg, tokenizer, ecfg, n_pages, device,
                      prompt, shorts, max_tokens, long_tokens, alone=None):
    """An engine at `ecfg` over `params`, started; the streams of each
    request alone on it unless `alone` is given; _fused_run's traffic
    with a fresh flight recorder, whose timeline (the engine's
    /debug/timeline payload) _flight_report saves and attributes; the
    engine stopped and its pool freed. Returns (record, streams,
    alone)."""
    import torch

    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
    from generativeaiexamples_tpu_torch.serving.flight import FlightRecorder
    from generativeaiexamples_tpu_torch.serving.openai_server import (
        OpenAIServer)

    engine = LLMEngine(params, cfg, tokenizer, ecfg, n_pages=n_pages,
                       device=device).start()
    try:
        if alone is None:
            alone = [_alone(engine, p, max_tokens) for p in shorts]
            alone.append(_alone(engine, prompt, long_tokens))
        # The timeline covers this run only, not the runs alone.
        engine.flight = FlightRecorder(engine.ecfg.flight_ring_size)
        engine.metrics.flight_stats = engine.flight.stats
        rec, got = _fused_run(engine, prompt, shorts, max_tokens,
                              long_tokens)
        rec["flight"] = _flight_report(
            OpenAIServer(engine).timeline()[1], f"fused_{name}")
        rec["rider_width"] = engine._fused_width
    finally:
        engine.stop()
        _release_engine(engine)
        del engine
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return rec, got, alone


def phase_fused_prefill(card: str, served: ServedEngine,
                        device: str = "cuda", prompt_len: int = 6000,
                        n_short: int = 3, max_tokens: int = 32,
                        long_tokens: int = 8, engine_cfg=None):
    """engine.fused_prefill over the served bf16 8B weights: unpaced
    engines of batch 4 with a pool for the prompt and three 256-token streams,
    built and closed in turn (FUSED_RUNS): A the chunked lane, B the
    rider (512-token budget: 12 riders of 512 in place of two chunks of
    4,096), C the lane with the unfused finish. In each, `n_short` greedy
    streams decode while a `prompt_len`-token prompt prefills
    (_k_cap_check's traffic). Every stream must equal the same request
    run alone (on engine A, before the runs); B must ride (fused_steps,
    and fused_prefill_tokens equal to the tokens its riders fed, which
    with the lane's make the prompt); C must count no fused sample.
    Prints each run's inter-token gap of the short streams while the
    prompt prefills (p50, max), the prompt's TTFT, prefill_stall_beats
    and the launches of K1 and K2."""
    src = served.engine
    ps = src.ecfg.page_size
    n_pages = -(-(prompt_len + n_short * 256) // ps) + 1
    # A tree engine reserves pages for the worst case of two blocks in
    # flight (K x (k + 1) tokens and the packed nodes of a step).
    spec_pages = -(-(prompt_len + n_short * 384) // ps) + 4
    base_cfg = {"max_batch_size": 4, **UNPACED, **(engine_cfg or {})}
    prompt, shorts = _fused_traffic(11, prompt_len, n_short)
    t0 = time.perf_counter()
    runs = {}
    for group, pages, kernels_of in ((FUSED_RUNS, n_pages, BF16_KERNELS),
                                     (SPEC_FUSED_RUNS, spec_pages,
                                      SPEC_BF16_KERNELS)):
        alone = None  # each group's streams alone on its first engine
        for name, knobs in group:
            time_mark(f"fused_{name}")
            rec, got, alone = _fused_engine_run(
                name, src.params, src.cfg, src.tokenizer,
                {**base_cfg, **knobs}, pages, device, prompt, shorts,
                max_tokens, long_tokens, alone)
            rec["n_pages"] = pages
            rec["ok"] = _fused_checks(name, rec, got, alone, prompt_len,
                                      *kernels_of)
            rec["long_first_tokens"] = got[-1]
            runs[name] = rec
    firsts_equal = {
        label: all(runs[n]["long_first_tokens"]
                   == runs[names[0]]["long_first_tokens"] for n in names)
        for label, names in (("A-C", [n for n, _ in FUSED_RUNS]),
                             ("D-E", [n for n, _ in SPEC_FUSED_RUNS]))}
    rec = {"phase": "fused_prefill", "card": card,
           "model": "llama3_8b random bf16 (the served weights)",
           "engine": base_cfg, "spec_engine": SPEC_TREE,
           "prompt_tokens": prompt_len, "short_streams": n_short,
           "short_max_tokens": max_tokens, "runs": runs,
           "long_first_tokens_equal": firsts_equal,
           "seconds": time.perf_counter() - t0,
           "ok": (all(r["ok"] for r in runs.values())
                  and all(firsts_equal.values()))}
    emit(rec)
    return rec


def phase_fused_prefill_int8(card: str, params, cfg, tokenizer,
                             device: str = "cuda", prompt_len: int = 2000,
                             n_short: int = 3, max_tokens: int = 24,
                             long_tokens: int = 8, n_pages: int = 128,
                             engine_cfg=None):
    """Run B of phase_fused_prefill at a smaller size over the int8
    deployment's weights (int8 weights, int8 pool), so K6 and K4 run
    under a rider: batch 4, `n_pages` pool pages, buckets up to 1,024 (a
    2,000-token prompt then goes chunked: 4 riders of 512 where the lane
    runs two chunks of 1,024). The streams must equal the same requests
    run alone on the same engine (the lane carries an idle engine's
    chunks); K1, K4 and K6 must launch, K2 not. Then the int8 tree
    composition (`spec_rider`): the same traffic on a tree engine (k = 3,
    M = 4) with step plans, the rider inside the verify steps (K4's tree
    form); its streams against the same requests alone on it; K1, K4 and
    K6 must launch, K2 and K5 not."""
    ecfg = {**INT8_DEPLOYMENT, "max_batch_size": 4,
            "prefill_buckets": [128, 512, 1024], **dict(FUSED_RUNS)["B_rider"],
            **UNPACED, **(engine_cfg or {})}
    prompt, shorts = _fused_traffic(12, prompt_len, n_short)
    t0 = time.perf_counter()
    rec, got, alone = _fused_engine_run(
        "int8_B_rider", params, cfg, tokenizer, ecfg, n_pages, device,
        prompt, shorts, max_tokens, long_tokens)
    rec["ok"] = _fused_checks("B_rider", rec, got, alone, prompt_len,
                              *INT8_KERNELS[0:1], ("paged_attention",))
    # The int8 tree composition: the same traffic on a tree engine with
    # composed plans, its streams against the same requests alone on it.
    spec_cfg = {**ecfg, **SPEC_TREE, "step_plans": True}
    spec, got, alone = _fused_engine_run(
        "int8_spec_rider", params, cfg, tokenizer, spec_cfg, n_pages, device,
        prompt, shorts, max_tokens, long_tokens)
    spec["ok"] = _fused_checks("spec_rider", spec, got, alone, prompt_len,
                               *INT8_KERNELS)
    spec["engine"] = spec_cfg
    rec["spec_rider"] = spec
    rec["ok"] = rec["ok"] and spec["ok"]
    rec.update(phase="fused_prefill_int8", card=card,
               model="llama3_8b random (seed 0), int8 weights, int8 KV",
               engine=ecfg, n_pages=n_pages, prompt_tokens=prompt_len,
               short_streams=n_short, short_max_tokens=max_tokens,
               reduced={"n_pages": n_pages,
                        "max_batch_size": ecfg["max_batch_size"],
                        "prefill_buckets": list(ecfg["prefill_buckets"])},
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


# -- phase 11: the developer_rag chain at full width ----------------------


def _rag_corpus(seed: int, n_chunks: int) -> str:
    """English prose from the repository's own documents (docs/*.md and
    README.md): its prose paragraphs (no code, tables or headings),
    sampled with a seed until the default splitter (508 approx-tokens a
    chunk, 200 overlap) gives about n_chunks chunks."""
    import glob

    import numpy as np

    from generativeaiexamples_tpu_torch.rag.splitter import ApproxTokenizer

    root = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(root, "docs", "*.md"))) + [
        os.path.join(root, "README.md")]
    paras = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            for p in fh.read().split("\n\n"):
                p = p.strip()
                if (len(p.split()) >= 8
                        and not p.startswith(("```", "|", "    ", "<", "#"))
                        and sum(c.isalpha() or c.isspace() for c in p)
                        > 0.8 * len(p)):
                    paras.append(p)
    counts = [len(ApproxTokenizer().encode(p)) for p in paras]
    want = (n_chunks - 1) * (508 - 200) + 508
    rng = np.random.default_rng(seed)
    out, n = [], 0
    while n < want:
        i = int(rng.integers(len(paras)))
        out.append(paras[i])
        n += counts[i]
    return "\n\n".join(out)


def _multipart(filename: str, data):
    """A multipart upload of `data` (text, or bytes as they are)."""
    boundary = "gaieboundary7a3f"
    raw = data.encode() if isinstance(data, str) else data
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: text/plain\r\n\r\n"
            ).encode() + raw + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _upload(base, filename, data, timeout=600):
    """POST `data` as `filename` to the chain server's /documents."""
    body, ctype = _multipart(filename, data)
    req = urllib.request.Request(base + "/documents", data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _chain_generate(base: str, query: str, max_tokens: int, history=()):
    """One knowledge-base /generate (after the conversation `history`):
    frames, the [DONE] sentinel, the text, the time to the first frame
    and to the end (host clock)."""
    t0 = time.perf_counter()
    frames, first_s = [], None
    with _post(base + "/generate", {
            "messages": [*history, {"role": "user", "content": query}],
            "use_knowledge_base": True, "max_tokens": max_tokens}) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                first_s = first_s or time.perf_counter() - t0
                frames.append(json.loads(line[6:]))
    last = frames[-1]["choices"][0] if frames else {}
    texts = [f["choices"][0]["message"]["content"] for f in frames]
    return {"frames": len(frames), "done_frame": last.get(
                "finish_reason") == "[DONE]",
            "error_frames": sum("Error from chain server" in t
                                for t in texts),
            "chars": sum(len(t) for t in texts), "text": "".join(texts),
            "first_frame_s": first_s, "seconds": time.perf_counter() - t0}


def _exact_topk_check(rows, queries, got_ids, got_scores, k):
    """Hold device-store results against an exact float64 MIPS on the
    host. Ids must be equal; a swap is accepted only between rows whose
    exact scores tie within 1e-6 (f32 accumulation order)."""
    import numpy as np

    exact = queries.astype(np.float64) @ rows.astype(np.float64).T
    part = np.argpartition(-exact, k - 1, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(exact, part, axis=1), axis=1)
    want = np.take_along_axis(part, order, axis=1)
    want_scores = np.take_along_axis(exact, want, axis=1)
    swaps = 0
    for r in range(len(queries)):
        for j in range(k):
            if got_ids[r][j] != want[r, j]:
                swaps += 1
                if abs(exact[r, got_ids[r][j]] - want_scores[r, j]) > 1e-6:
                    return False, swaps, None
    err = float(np.abs(np.asarray(got_scores) - want_scores).max())
    return err <= 1e-4, swaps, err


def phase_rag(card: str, served: ServedEngine, device: str = "cuda",
              n_chunks: int = 2000, store_rows: int = 1_000_000,
              store_dim: int = 1024, max_tokens: int = 32, keep=None):
    """The port's ChainServer with developer_rag over the device store,
    the served 8B engine, and arctic-embed-l / BERT-base reranker
    encoders (bf16, random from seeds): ingest the repository's prose
    sampled with a seed (~2,000 chunks at the default splitter, all at
    S=512), /search against exact host MIPS, a 1M-row device store
    searched with 64 queries against exact host MIPS, and two
    knowledge-base /generate answers whose prompts exceed the 4096
    bucket. Each answer must generate its tokens with no error frame
    (an engine failure becomes one); K3's launches must equal the
    encoder layers times the forwards made, and K1 and K2 must launch.
    `keep` (a dict), when given, receives the encoders, the ingested
    store and the phase's queries, which the checkpoint phase writes to
    disk and loads back."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.api.server import (
        ChainServer, make_http_server)
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        DeviceVectorStore)
    from generativeaiexamples_tpu_torch.serving.__main__ import (
        build_encoders)

    emb, rr = build_encoders(device, seed=1)
    config = load_config(env={}, overrides={
        "vector_store": {"name": "tpu"}, "reranker": {"enabled": True},
        "embeddings": {"dimensions": emb.dim}})
    hub = EngineHub(config, llm=served.engine, embed=emb, rerank=rr,
                    device=device)
    app = ChainServer(config, hub=hub)
    httpd = make_http_server(app, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    store = app.example.res.store
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        emb.forwards = rr.forwards = 0
        corpus = _rag_corpus(0, n_chunks)
        t0 = time.perf_counter()
        upload = _upload(base, "corpus.txt", corpus, timeout=900)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        stored = len(store)

        query = "Which scheduler keeps the decode batch full of tokens?"
        with _post(base + "/search", {"query": query, "top_k": 5}) as r:
            chunks = json.loads(r.read())["chunks"]

        # Two knowledge-base answers (prompts beyond the 4096 bucket).
        gens = []
        m = served.engine.metrics
        questions = ("How does the prefill scheduler use the page cache?",
                     "What bounds the attention kernel on the device?")
        for q in questions:
            prefill0, tokens0 = m.prefill_tokens, m.tokens_out
            g = _chain_generate(base, q, max_tokens)
            g["prompt_tokens"] = m.prefill_tokens - prefill0
            g["tokens_generated"] = m.tokens_out - tokens0
            g["engine_ttft_ms"] = m.last_ttft_ms
            gens.append(g)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        forwards = {"embed": emb.forwards, "rerank": rr.forwards}
        want_k3 = (emb.forwards * emb.cfg.n_layers
                   + rr.forwards * rr.cfg.n_layers)

        # /search against exact host MIPS over the store's rows (the
        # query's embedding is recomputed after the counts were read).
        qv = emb.embed_query(query)
        texts = [d["text"] for d in store.snapshot_docs()]
        ids = [texts.index(c["content"]) for c in chunks]
        search_ok, search_swaps, search_err = _exact_topk_check(
            store.rows().cpu().numpy(), qv[None, :], [ids],
            [[c["score"] for c in chunks]], 5)
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        app.close()

    # A second device store of seed-made unit rows, searched in batch.
    g = torch.Generator(device=device).manual_seed(2)
    big = DeviceVectorStore(store_dim, device=device)
    vecs = torch.randn((store_rows, store_dim), generator=g, device=device)
    vecs /= torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    big.add([str(i) for i in range(store_rows)], vecs)
    del vecs
    qs = torch.randn((64, store_dim), generator=g, device=device)
    qs = (qs / torch.linalg.vector_norm(qs, dim=1, keepdim=True)).cpu()
    big.search(qs[0].numpy(), top_k=10)  # folds the rows in (not timed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = big.search(qs[0].numpy(), top_k=10)
    one_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch = big.search_batch(qs.numpy(), top_k=10)
    batch_ms = (time.perf_counter() - t0) * 1e3
    store_gb = big.rows().numel() * 4 / 1e9
    big_ok, big_swaps, big_err = _exact_topk_check(
        big.rows().cpu().numpy(), qs.numpy(),
        [[int(h.text) for h in hits] for hits in batch],
        [[h.score for h in hits] for hits in batch], 10)
    big_ok = big_ok and [int(h.text) for h in one] == [
        int(h.text) for h in batch[0]]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del big
    if keep is not None:
        keep.update(emb=emb, rr=rr, store=store,
                    queries=[query, *questions])

    # An answer generates max_tokens tokens, or fewer when it ends on an
    # end-of-sequence token; a request the engine fails streams the error
    # frame (the connector raises on an "error" finish).
    ok = (upload.get("message", "").endswith("uploaded successfully")
          and search_ok and big_ok
          and all(g["done_frame"] and g["error_frames"] == 0
                  and 1 <= g["tokens_generated"] <= max_tokens
                  and g["prompt_tokens"] > served.engine.buckets[-1]
                  for g in gens)
          and launches["encoder_attention"] == want_k3 > 0
          and launches["flash_attention"] > 0
          and launches["paged_attention"] > 0
          and health.get("message") == "Service is up.")
    rec = {"phase": "rag", "card": card, "example": "developer_rag",
           "store": "DeviceVectorStore", "embedder": "arctic_embed_l bf16",
           "reranker": "reranker_base bf16", "nr_pipeline": "ranked_hybrid",
           "corpus": "docs/*.md + README.md prose, seed 0",
           "corpus_bytes": len(corpus), "chunks": stored,
           "ingest_s": ingest_s, "ingest_chunks_per_s": stored / ingest_s,
           "search": {"ok": search_ok, "swaps": search_swaps,
                      "max_score_err": search_err, "top": chunks[:1]},
           "store_1m": {"rows": store_rows, "dim": store_dim,
                        "gb": store_gb, "ok": big_ok, "swaps": big_swaps,
                        "max_score_err": big_err,
                        "search_1_query_ms": one_ms,
                        "search_64_queries_ms": batch_ms},
           "generate": gens, "forwards": forwards,
           "launches": launches, "want_encoder_launches": want_k3,
           "store_metrics": metrics.get("vector_store"),
           "peak_mem_gb": peak_gb, "ok": ok}
    emit(rec)
    return rec


# -- phase 11a: the rest of the chain (micro-batching, tracing, augmentation)


def _pct(vals, p):
    """The p-quantile (0..1) of vals by rank, None when empty."""
    vals = sorted(v for v in vals if v is not None)
    return vals[min(len(vals) - 1, int(p * len(vals)))] if vals else None


def _together(n: int, fn):
    """fn(i) on n threads released at once: [(result, seconds)]."""
    out = [None] * n
    bar = threading.Barrier(n)

    def run(i):
        bar.wait()
        t0 = time.perf_counter()
        try:
            res = fn(i)
        except Exception as e:  # reported, and fails the phase
            res = e
        out[i] = (res, time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return out


def _await_spans(exporter, name: str, n: int, timeout_s: float = 10.0):
    """The exporter's finished spans once at least `n` named `name` have
    ended (or at `timeout_s`, so a missing span fails the check that reads
    them)."""
    deadline = time.perf_counter() + timeout_s
    while True:
        spans = exporter.get_finished_spans()
        if (sum(sp.name == name for sp in spans) >= n
                or time.perf_counter() >= deadline):
            return spans
        time.sleep(0.02)


def _span_s(t):
    """A span or event time in seconds: the built-in tracer keeps
    time.time() floats, the OpenTelemetry SDK integer nanoseconds."""
    return t / 1e9 if isinstance(t, int) else t


def _search(base, query, top_k):
    with _post(base + "/search", {"query": query, "top_k": top_k}) as r:
        return json.loads(r.read())["chunks"]


def _chain_frames(base, query, max_tokens, headers=None):
    """One knowledge-base /generate: the frames' contents, in order."""
    req = urllib.request.Request(
        base + "/generate", data=json.dumps({
            "messages": [{"role": "user", "content": query}],
            "use_knowledge_base": True, "max_tokens": max_tokens}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    frames = []
    with urllib.request.urlopen(req, timeout=900) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                frames.append(json.loads(line[6:])["choices"][0])
    return frames


def _chain_server(config, hub, store):
    """A ChainServer (developer_rag) over `hub`'s engines and the given
    store, on a local port: (app, httpd, base, thread)."""
    from generativeaiexamples_tpu_torch.api.server import (
        ChainServer, make_http_server)
    from generativeaiexamples_tpu_torch.pipelines.base import (
        get_example_class)
    from generativeaiexamples_tpu_torch.pipelines.resources import Resources

    example = get_example_class("developer_rag")(
        Resources(config, hub=hub, store=store))
    app = ChainServer(config, example=example)
    httpd = make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return app, httpd, f"http://127.0.0.1:{httpd.server_address[1]}", th


def _stop_server(app, httpd, th):
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=30)
    app.close()


def phase_chain(card: str, served: ServedEngine, keep: dict,
                device: str = "cuda", n_search: int = 64,
                n_answers: int = 3, n_augmented: int = 1,
                max_tokens: int = 32, top_k: int = 5):
    """The rest of the chain over phase_rag's encoders and 2,001-chunk
    device store (`keep`) and the served 8B engine, tracing on (a
    MemoryExporter):

    1. coalesced search: `n_search` distinct corpus queries to /search
       one at a time on a server with micro-batching off, then all at
       once on one with `serving.microbatch_enabled`; every result held
       to exact host MIPS, the two runs' ids equal, the query embeddings
       made concurrently through the embedder's batcher compared bit for
       bit with the direct ones; K3's launches must equal encoder layers
       x forwards;
    2. traced answers: `n_answers` concurrent knowledge-base /generate
       (ranked_hybrid), one with a W3C traceparent: each `generate` span
       must share its trace with one `llm.local` and one
       `engine.generate` span, the header's trace id must come back, and
       the reranker's batcher must coalesce; the TTFT split is read from
       the spans;
    3. augmented answers: `n_augmented` answers with
       query_augmentation rewrite,hyde,multi_query and fact_check: the
       variants reach the encoder as one embed_queries call (one
       forward) and the store as one search_batch, and each answer ends
       with the "[fact-check] " frame and a verdict the engine
       generated. K1, K2 and K3 must launch.
    The batchers are disabled and tracing turned off at the end, so the
    later phases run as before."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.api.server import sanitize
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.obs import tracing

    emb, rr, store = keep["emb"], keep["rr"], keep["store"]
    base_cfg = {"vector_store": {"name": "tpu"},
                "reranker": {"enabled": True},
                "embeddings": {"dimensions": emb.dim}}
    cfg_off = load_config(env={}, overrides=base_cfg)
    cfg_on = load_config(env={}, overrides={
        **base_cfg, "serving": {"microbatch_enabled": True}})
    cfg_aug = load_config(env={}, overrides={
        **base_cfg, "serving": {"microbatch_enabled": True},
        "retriever": {"query_augmentation": "rewrite,hyde,multi_query",
                      "fact_check": True}})
    hub = EngineHub(cfg_on, llm=served.engine, embed=emb, rerank=rr,
                    device=device)
    exporter = tracing.MemoryExporter()
    tracing.setup(exporter=exporter)
    backend = tracing._BACKEND  # "otel" where the SDK is installed
    docs = store.snapshot_docs()
    texts = [d["text"] for d in docs]
    # Queries the server's input hygiene leaves as they are, so the
    # embeddings made here are those of what /search embeds.
    rng = np.random.default_rng(11)
    queries = []
    for i in rng.permutation(len(docs)):
        q = " ".join(texts[int(i)].split()[:12])
        if sanitize(q) == q and q not in queries:
            queries.append(q)
        if len(queries) == n_search:
            break
    rows = store.rows().cpu().numpy()
    servers = []
    try:
        # 1. /search, direct then coalesced.
        time_mark("chain_search")
        app, httpd, base, th = _chain_server(cfg_off, hub, store)
        servers.append((app, httpd, th))
        torch.cuda.synchronize()
        f0 = emb.forwards
        direct, direct_s = [], []
        for q in queries:
            t0 = time.perf_counter()
            direct.append(_search(base, q, top_k))
            direct_s.append(time.perf_counter() - t0)
        direct_forwards = emb.forwards - f0
        direct_vecs = np.stack([emb.embed_query(q) for q in queries])
        app, httpd, base, th = _chain_server(cfg_on, hub, store)
        servers.append((app, httpd, th))
        torch.cuda.synchronize()
        kernels.reset_launches()
        f0, r0 = emb.forwards, rr.forwards
        coal = _together(n_search, lambda i: _search(base, queries[i],
                                                     top_k))
        torch.cuda.synchronize()
        search_launches = dict(kernels.LAUNCHES)
        coal_forwards = emb.forwards - f0
        want_k3 = (coal_forwards * emb.cfg.n_layers
                   + (rr.forwards - r0) * rr.cfg.n_layers)
        stats = app.example.res.retriever.microbatch_stats()
        coal_vecs = _together(n_search, lambda i: emb.embed_query(
            queries[i]))
        coal_vecs = np.stack([v for v, _ in coal_vecs])
        same_bits = int(sum(np.array_equal(a, b)
                            for a, b in zip(direct_vecs, coal_vecs)))
        vec_err = float(np.abs(direct_vecs - coal_vecs).max())
        search_errors = [c for c, _ in coal if isinstance(c, Exception)]
        coal_hits = [c if not isinstance(c, Exception) else [{
            "content": texts[0], "score": float("nan")}] * top_k
            for c, _ in coal]

        def ids_scores(hits):
            return ([[texts.index(c["content"]) for c in h] for h in hits],
                    [[c["score"] for c in h] for h in hits])

        d_ids, d_scores = ids_scores(direct)
        c_ids, c_scores = ids_scores(coal_hits)
        d_ok, d_swaps, d_err = _exact_topk_check(rows, direct_vecs, d_ids,
                                                 d_scores, top_k)
        c_ok, c_swaps, c_err = _exact_topk_check(rows, direct_vecs, c_ids,
                                                 c_scores, top_k)
        search = {
            "queries": n_search, "top_k": top_k,
            "direct": {"forwards": direct_forwards, "exact_ok": d_ok,
                       "swaps": d_swaps, "max_score_err": d_err,
                       "latency_p50_ms": _pct(direct_s, 0.5) * 1e3,
                       "latency_p99_ms": _pct(direct_s, 0.99) * 1e3},
            "coalesced": {"forwards": coal_forwards, "exact_ok": c_ok,
                          "swaps": c_swaps, "max_score_err": c_err,
                          "errors": [repr(e) for e in search_errors],
                          "latency_p50_ms": _pct([t for _, t in coal],
                                                 0.5) * 1e3,
                          "latency_p99_ms": _pct([t for _, t in coal],
                                                 0.99) * 1e3,
                          "embed_batcher": stats.get("embed"),
                          "search_batcher": stats.get("search")},
            "ids_equal": d_ids == c_ids,
            "embeddings_bit_identical": same_bits,
            "embeddings_max_abs_diff": vec_err,
            "launches": search_launches, "want_encoder_launches": want_k3}
        search_ok = (d_ok and c_ok and d_ids == c_ids and not search_errors
                     and (same_bits == n_search or vec_err <= 2e-2)
                     and coal_forwards < direct_forwards
                     and search_launches["encoder_attention"] == want_k3)

        # 2. traced answers, all at once (one with a traceparent).
        time_mark("chain_traced")
        trace_id = "4bf92f3577b34da6a3ce929d0e0e4736"
        header = {"traceparent": f"00-{trace_id}-00f067aa0ba902b7-01"}
        exporter.clear()
        kernels.reset_launches()
        rr_stats0 = rr.microbatch_stats()
        questions = [f"How does the engine handle request {i} when the "
                     f"page cache is full?" for i in range(n_answers)]
        answers = _together(n_answers, lambda i: _chain_frames(
            base, questions[i], max_tokens, header if i == 0 else None))
        torch.cuda.synchronize()
        answer_launches = dict(kernels.LAUNCHES)
        rr_stats = rr.microbatch_stats()
        # The engine ends a request's span on its scheduler thread just
        # after it delivers the last event, so the client can finish first
        # (as in the JAX engine): wait for the spans, not only the frames.
        spans = _await_spans(exporter, "engine.generate", n_answers)
        by_trace = {}
        for sp in spans:
            by_trace.setdefault(sp.context.trace_id, []).append(sp)
        gens = [sp for sp in spans if sp.name == "generate"]
        splits, linked = [], 0
        for g in gens:
            tree = by_trace[g.context.trace_id]
            llm = [sp for sp in tree if sp.name == "llm.local"]
            eng = [sp for sp in tree if sp.name == "engine.generate"]
            if len(llm) == 1 and len(eng) == 1:
                linked += 1

            def first(sp):
                return next((e for e in sp.events
                             if e.name == "first_token"), None)

            g0 = _span_s(g.start_time)
            e_first = first(eng[0]) if eng else None
            l_first = first(llm[0]) if llm else None
            splits.append({
                # Start of generate to the engine's first token (random
                # weights rarely emit one of the byte tokenizer's text
                # ids, so the first frame, and the spans' text TTFTs,
                # often never come).
                "chain_first_token_ms": (
                    (_span_s(e_first.timestamp) - g0) * 1e3 if e_first
                    else None),
                "retrieval_and_prompt_ms": (
                    (_span_s(llm[0].start_time) - g0) * 1e3 if llm
                    else None),
                "engine_ttft_ms": (e_first.attributes["ttft_ms"]
                                   if e_first else None),
                "chain_first_frame_ms": g.attributes.get("ttft_ms"),
                "llm_first_text_ms": (l_first.attributes["ttft_ms"]
                                      if l_first else None)})
        answer_errors = [a for a, _ in answers if isinstance(a, Exception)]
        good = [a for a, _ in answers if not isinstance(a, Exception)]
        ttft_split = {key: {"p50": _pct([s[key] for s in splits], 0.5),
                            "p95": _pct([s[key] for s in splits], 0.95),
                            "n": sum(s[key] is not None for s in splits)}
                      for key in ("chain_first_token_ms",
                                  "retrieval_and_prompt_ms",
                                  "engine_ttft_ms", "chain_first_frame_ms",
                                  "llm_first_text_ms")}
        rerank_calls = rr_stats["submitted"] - rr_stats0["submitted"]
        rerank_dispatches = rr_stats["dispatches"] - rr_stats0["dispatches"]
        traced = {
            "answers": n_answers, "max_tokens": max_tokens,
            "errors": [repr(e) for e in answer_errors],
            "done_frames": sum(a[-1]["finish_reason"] == "[DONE]"
                               for a in good),
            "error_frames": sum("Error from chain server"
                                in f["message"]["content"]
                                for a in good for f in a),
            "generate_spans": len(gens), "linked_traces": linked,
            "header_trace_back": any(
                g.context.trace_id == int(trace_id, 16) for g in gens),
            "ttft_split": ttft_split,
            "rerank_calls": rerank_calls,
            "rerank_dispatches": rerank_dispatches,
            "rerank_batcher": rr_stats, "launches": answer_launches}
        traced_ok = (not answer_errors and traced["done_frames"] == n_answers
                     and traced["error_frames"] == 0
                     and len(gens) == linked == n_answers
                     and ttft_split["chain_first_token_ms"]["n"] == n_answers
                     and traced["header_trace_back"]
                     and rerank_dispatches < rerank_calls
                     and all(answer_launches[k] > 0 for k in (
                         "flash_attention", "paged_attention",
                         "encoder_attention")))

        # 3. augmented answers with the fact check, one at a time.
        time_mark("chain_augmented")
        app, httpd, base, th = _chain_server(cfg_aug, hub, store)
        servers.append((app, httpd, th))
        res = app.example.res
        calls = []
        real_eq = res.embedder.embed_queries
        # A depth cut: every LLM call of an augmented answer (HyDE,
        # multi-query, the answer, the fact check; 512 tokens each by
        # default, which random weights always fill) stops at max_tokens.
        real_chat = res.llm.stream_chat

        def capped(messages, **kw):
            kw["max_tokens"] = min(kw.get("max_tokens", max_tokens),
                                   max_tokens)
            return real_chat(messages, **kw)

        res.llm.stream_chat = capped

        def counted(texts_):
            calls.append(len(texts_))
            return real_eq(texts_)

        res.embedder.embed_queries = counted
        kernels.reset_launches()
        exporter.clear()
        augmented = []
        for i in range(n_augmented):
            calls.clear()
            f0 = emb.forwards
            b0 = store.stats()["batched_searches"]
            frames = _chain_frames(base, questions[i], max_tokens)
            contents = [f["message"]["content"] for f in frames]
            mark = (contents.index("\n\n[fact-check] ")
                    if "\n\n[fact-check] " in contents else None)
            augmented.append({
                "frames": len(frames),
                "done_frame": frames[-1]["finish_reason"] == "[DONE]",
                "fact_check_frame": mark is not None,
                "verdict_frames": (len(frames) - 2 - mark
                                   if mark is not None else 0),
                "embed_queries_calls": list(calls),
                "embed_forwards": emb.forwards - f0,
                "search_batch_calls": store.stats()["batched_searches"]
                - b0})
        torch.cuda.synchronize()
        aug_launches = dict(kernels.LAUNCHES)
        # Each augmented answer's trace: the hyde, multi_query, answer
        # and fact-check LLM calls (rewrite has no history to resolve).
        aug_traces = {}
        for sp in _await_spans(exporter, "engine.generate",
                               4 * n_augmented):
            aug_traces.setdefault(sp.context.trace_id, []).append(sp)
        verdicts = []
        for tree in aug_traces.values():
            eng = sorted((sp for sp in tree if sp.name == "engine.generate"),
                         key=lambda sp: _span_s(sp.start_time))
            verdicts.append({"llm_calls": len(eng),
                             "verdict_tokens": (eng[-1].attributes.get(
                                 "tokens_generated") if eng else 0)})
        aug_ok = (all(a["done_frame"] and a["fact_check_frame"]
                      and len(a["embed_queries_calls"]) == 1
                      and a["embed_queries_calls"][0] >= 2
                      and a["embed_forwards"] == 1
                      and a["search_batch_calls"] == 1 for a in augmented)
                  and len(verdicts) == n_augmented
                  and all(v["llm_calls"] == 4 and v["verdict_tokens"] >= 1
                          for v in verdicts)
                  and all(aug_launches[k] > 0 for k in (
                      "flash_attention", "paged_attention",
                      "encoder_attention")))
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
    finally:
        for app, httpd, th in servers:
            _stop_server(app, httpd, th)
        for obj in (emb, rr, store):
            obj.disable_microbatch()
        tracing._ENABLED = False  # the later phases run untraced
    ok = search_ok and traced_ok and aug_ok
    rec = {"phase": "chain", "card": card, "store_chunks": len(docs),
           "tracing_backend": backend,
           "search": search, "search_ok": search_ok,
           "traced": traced, "traced_ok": traced_ok,
           "augmented": augmented, "augmented_traces": verdicts,
           "augmented_launches": aug_launches, "augmented_ok": aug_ok,
           "microbatch_metrics": metrics.get("microbatch"), "ok": ok}
    emit(rec)
    return rec


# -- phase 11c: ANN retrieval (IVF, int8 rows, the tiered index) -----------

# phase_ann's 1M-row corpus: unit rows around unit centers, each with
# noise of norm ~0.5, made on the card from a seed.
ANN_ROWS = 1_000_000
ANN_DIM = 1024
ANN_CENTERS = 4096
ANN_NOISE = 0.5
ANN_NLIST = 1024
ANN_NPROBE = 16
# Rows of the tiered part (c): cut from 1,000,000 (the smoke passed 600 s)
# with its device and RAM budgets, 1 GB each at 1M rows, scaled alike, so
# the hot share stays ~1/8 of the partitions.
ANN_TIERED_ROWS = 262_144
# (b)'s f32 recall@10 bound: below the readings of k-means seeds 0-2 on
# this corpus (0.881-0.928), which (b) also prints.
ANN_F32_RECALL = 0.86
ANN_SEEDS = (0,)
# Device bytes a store may hold beyond its index's table (or tiered
# budget) and centroids.
ANN_SLACK_BYTES = 16 << 20


def _unit_rows(x):
    import torch

    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _ann_corpus(device, rows, dim, n_centers, noise, seed):
    """(rows [rows, dim], centers [n_centers, dim]) f32 unit rows on the
    card, made in chunks so the transient stays ~0.5 GB."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    centers = _unit_rows(torch.randn((n_centers, dim), generator=g,
                                     device=device))
    out = torch.empty((rows, dim), device=device)
    sigma = noise / dim ** 0.5
    for lo in range(0, rows, 65536):
        n = min(65536, rows - lo)
        cid = torch.randint(n_centers, (n,), generator=g, device=device)
        out[lo:lo + n] = _unit_rows(centers[cid] + sigma * torch.randn(
            (n, dim), generator=g, device=device))
    return out, centers


def _near(centers, ids, noise, seed):
    """Unit queries near the given centers."""
    import torch

    g = torch.Generator(device=centers.device).manual_seed(seed)
    return _unit_rows(centers[ids] + noise / centers.shape[1] ** 0.5
                      * torch.randn((len(ids), centers.shape[1]),
                                    generator=g, device=centers.device))


def _median_ms(fn, n: int = 3) -> float:
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[n // 2]


def _recall(got, want) -> float:
    """Mean overlap@k of two [Q, k] id arrays."""
    return float(sum(len(set(g) & set(w)) / len(w)
                     for g, w in zip(got.tolist(), want.tolist()))
                 / len(want))


def _same_up_to_ties(ids_a, sc_a, ids_b, sc_b, tol=1e-5):
    """Per query: equal id sets, and equal order except where the scores
    differ by at most `tol` (a near-tie scored on the card vs the host)."""
    for ia, sa, ib, sb in zip(ids_a.tolist(), sc_a.tolist(), ids_b.tolist(),
                              sc_b.tolist()):
        if set(ia) != set(ib):
            return False
        for j, (x, y) in enumerate(zip(ia, ib)):
            if x != y and abs(sa[j] - sb[j]) > tol:
                return False
    return True


def _ann_chain(served, keep, device, n_search, max_tokens, top_k):
    """(a) The chain over an IVF device store: phase_rag's encoders and
    ingested rows behind a ChainServer whose store has index_type=ivf at
    the config defaults."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.api.server import sanitize
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.ops.topk import mips_topk
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        create_vector_store)

    emb, rr, src = keep["emb"], keep["rr"], keep["store"]
    base_cfg = {"vector_store": {"name": "tpu", "index_type": "ivf"},
                "reranker": {"enabled": True},
                "embeddings": {"dimensions": emb.dim}}
    cfg_off = load_config(env={}, overrides=base_cfg)
    cfg_on = load_config(env={}, overrides={
        **base_cfg, "serving": {"microbatch_enabled": True}})
    hub = EngineHub(cfg_on, llm=served.engine, embed=emb, rerank=rr,
                    device=device)
    store = create_vector_store(cfg_off, emb.dim, device=device)
    docs = src.snapshot_docs()
    texts = [d["text"] for d in docs]
    store.add(texts, src.rows(), [d["metadata"] for d in docs])
    rng = np.random.default_rng(17)
    queries = []
    for i in rng.permutation(len(docs)):
        q = " ".join(texts[int(i)].split()[:12])
        if sanitize(q) == q and q not in queries:
            queries.append(q)
        if len(queries) == n_search:
            break
    servers = []
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        f0, r0 = emb.forwards, rr.forwards
        app, httpd, base, th = _chain_server(cfg_off, hub, store)
        servers.append((app, httpd, th))
        t0 = time.perf_counter()
        direct = [_search(base, queries[0], top_k)]  # trains the index
        train_s = time.perf_counter() - t0
        index_after_first = store.stats()["index"]
        direct_s = []
        for q in queries[1:]:
            t0 = time.perf_counter()
            direct.append(_search(base, q, top_k))
            direct_s.append(time.perf_counter() - t0)
        app, httpd, base, th = _chain_server(cfg_on, hub, store)
        servers.append((app, httpd, th))
        coal = _together(n_search, lambda i: _search(base, queries[i],
                                                     top_k))
        search_errors = [c for c, _ in coal if isinstance(c, Exception)]
        m = served.engine.metrics
        prefill0, tokens0 = m.prefill_tokens, m.tokens_out
        gen = _chain_generate(base, "How does the IVF index choose which "
                              "partitions to scan?", max_tokens)
        gen["prompt_tokens"] = m.prefill_tokens - prefill0
        gen["tokens_generated"] = m.tokens_out - tokens0
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        want_k3 = ((emb.forwards - f0) * emb.cfg.n_layers
                   + (rr.forwards - r0) * rr.cfg.n_layers)
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
    finally:
        for app, httpd, th in servers:
            _stop_server(app, httpd, th)
        for obj in (emb, rr, store):
            obj.disable_microbatch()

    def ids(hits):
        return [[texts.index(c["content"]) for c in h] for h in hits]

    d_ids = ids(direct)
    c_ids = ids([c if not isinstance(c, Exception) else [] for c, _ in coal])
    # The store alone: each query's embedding searched alone and in one
    # batch.
    vecs = np.stack([emb.embed_query(q) for q in queries])
    alone = [[h.text for h in store.search(v, top_k=top_k)] for v in vecs]
    batch = [[h.text for h in hits]
             for hits in store.search_batch(vecs, top_k=top_k)]
    st = store.stats()
    rows = store.rows().to(device)  # an ivf store keeps them on the host
    _, exact = mips_topk(torch.from_numpy(vecs).to(device), rows, top_k)
    recall = _recall(np.array([[texts.index(t) for t in a] for a in alone]),
                     exact.cpu().numpy())
    ok = (index_after_first == st["index"] == "ivf"
          and d_ids == c_ids and not search_errors and alone == batch
          and gen["done_frame"] and gen["error_frames"] == 0
          and 1 <= gen["tokens_generated"] <= max_tokens
          and launches["encoder_attention"] == want_k3 > 0
          and launches["flash_attention"] > 0
          and launches["paged_attention"] > 0)
    rec = {"chunks": len(docs), "nlist": st["nlist"], "nprobe": st["nprobe"],
           "first_search_with_training_s": train_s,
           "direct_p50_ms": _pct(direct_s, 0.5) * 1e3,
           "coalesced_p50_ms": _pct([t for _, t in coal], 0.5) * 1e3,
           "ids_equal_alone_and_coalesced": d_ids == c_ids,
           "store_alone_equals_batch": alone == batch,
           "search_errors": [repr(e) for e in search_errors],
           "recall_at_k_vs_exact": recall,
           "ann_recall_est": st["ann_recall_est"],
           "ann_scanned_rows": st["ann_scanned_rows"],
           "ann_probes": st["ann_probes"], "searches": st["searches"],
           "generate": gen, "launches": launches,
           "want_encoder_launches": want_k3,
           "store_metrics": metrics.get("vector_store"), "ok": ok}
    del store, rows
    return rec


def _ann_big(device, rows, dim, n_centers, noise, nlist, nprobe):
    """(b) 1M rows: the flat store against the IVF store (f32), trained
    through its own first search, and an int8 index on the same training
    state; (c) reuses the state."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch.ops import ivf
    from generativeaiexamples_tpu_torch.ops.topk import mips_topk
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        DeviceVectorStore)

    t0 = time.perf_counter()
    x, centers = _ann_corpus(device, rows, dim, n_centers, noise, seed=5)
    qs = _near(centers, torch.arange(64, device=device), noise, seed=6)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    names = [str(i) for i in range(rows)]
    flat = DeviceVectorStore(dim, device=device)
    flat.add(names, x)
    del x
    corpus = flat.rows()
    qn = qs.cpu().numpy()
    flat.search(qn[0], top_k=10)  # folds the rows in (not timed)
    flat_1 = _median_ms(lambda: flat.search(qn[0], top_k=10))
    flat_64 = _median_ms(lambda: flat.search_batch(qn, top_k=10))
    _, exact = mips_topk(qs, corpus, 10)
    exact = exact.cpu().numpy()

    # The IVF store keeps its rows on the host; its first search trains
    # from them, streamed through the card, and installs the index. The
    # recall gauge's cadence is raised so no exact host scan falls inside
    # the timed searches.
    store = DeviceVectorStore(dim, device=device, index_type="ivf",
                              nlist=nlist, nprobe=nprobe)
    store.recall_sample_every = 1 << 30
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    store.add(names, corpus)
    add_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store.search(qn[0], top_k=10)
    torch.cuda.synchronize()
    store_train_s = time.perf_counter() - t0
    index = store._ivf
    device_bytes = torch.cuda.memory_allocated() - base
    index_bytes = index.table_bytes() + index.centroids.numel() * 4
    ivf_1 = _median_ms(lambda: store.search(qn[0], top_k=10))
    ivf_64 = _median_ms(lambda: store.search_batch(qn, top_k=10))
    got = np.array([[int(h.text) for h in hits]
                    for hits in store.search_batch(qn, top_k=10)])
    alone = np.array([[int(h.text) for h in store.search(q, top_k=10)]
                      for q in qn])

    # The training steps one by one on the card-resident rows: the same
    # seed must give the store's centroids and assignments.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cents, near = ivf.kmeans_fit(corpus, nlist, seed=0)
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    order, best = ivf.centroid_candidates(corpus, cents)
    cand_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    assign = ivf.rank_round_assign(order, best, nlist,
                                   int(ivf.BALANCE_CAP * rows / nlist) + 1)
    assign_s = time.perf_counter() - t0
    del order, best
    state = index.state()
    same_centroids = bool(torch.equal(cents, index.centroids))
    same_assign = bool(np.array_equal(assign, state["assignments"]))
    f32 = {"table_gb": index.table_bytes() / 1e9,
           "store_device_gb": device_bytes / 1e9,
           "store_rows_on_host": store.rows().device.type == "cpu",
           "store_search_1_ms": ivf_1, "store_search_64_ms": ivf_64,
           "recall_at_10": _recall(got, exact),
           "alone_equals_batch": bool((alone == got).all())}
    s64, i64, scanned = index.search(qs, 10)
    f32["scanned_share"] = scanned / (64 * rows)
    pids = ivf.coarse_probes(qs, cents, nprobe)
    ref_i, ref_s, bad_probes = _probed_reference(corpus, cents, assign, qs,
                                                 pids, 10)
    f32["same_as_probed_reference"] = _same_up_to_ties(
        i64.cpu().numpy(), s64.cpu().numpy(), ref_i, ref_s)
    f32["probe_mismatches"] = bad_probes
    f32["index_search_1_ms"] = time_ms(lambda: index.search(qs[:1], 10), 10)
    f32["index_search_64_ms"] = time_ms(lambda: index.search(qs, 10), 5)
    # Recall of the probed lists (the float64 reference) by assignment and
    # k-means seed: nearest-centroid lists bound what the balanced
    # assignment gives up; other seeds show the spread of one training.
    near_i, _, _ = _probed_reference(corpus, cents, near.cpu().numpy(), qs,
                                     pids, 10)
    by_seed = {0: _recall(ref_i, exact)}
    for seed in ANN_SEEDS[1:]:
        c_s, _ = ivf.kmeans_fit(corpus, nlist, seed=seed)
        a_s = ivf.balanced_assign(corpus, c_s)
        by_seed[seed] = _recall(_probed_reference(
            corpus, c_s, a_s, qs, ivf.coarse_probes(qs, c_s, nprobe),
            10)[0], exact)
        del c_s, a_s
    recall_probed = {"nearest_assignment": _recall(near_i, exact),
                     "balanced_by_kmeans_seed": by_seed,
                     "spilled_share": float(
                         (near.cpu().numpy() != assign).mean())}
    del near

    t0 = time.perf_counter()
    idx8 = ivf.IVFIndex(corpus, nlist, nprobe=nprobe, quantize_int8=True,
                        centroids=cents, assignments=assign)
    torch.cuda.synchronize()
    table8_s = time.perf_counter() - t0
    s8, i8, scanned8 = idx8.search(qs, 10)
    alone8 = torch.cat([idx8.search(qs[r:r + 1], 10)[1] for r in range(64)])
    int8 = {"table_gb": idx8.table_bytes() / 1e9, "table_build_s": table8_s,
            "recall_at_10": _recall(i8.cpu().numpy(), exact),
            "scanned_share": scanned8 / (64 * rows),
            "alone_equals_batch": bool(torch.equal(alone8, i8)),
            "index_search_1_ms": time_ms(lambda: idx8.search(qs[:1], 10),
                                         10),
            "index_search_64_ms": time_ms(lambda: idx8.search(qs, 10), 5)}
    del idx8
    rec = {"rows": rows, "dim": dim, "centers": n_centers, "noise": noise,
           "nlist": nlist, "nprobe": nprobe, "corpus_gb": rows * dim * 4 / 1e9,
           "make_s": make_s, "store_add_s": add_s,
           "train_s": {"store_first_search": store_train_s,
                       "steps_on_card_rows": {
                           "kmeans": kmeans_s, "candidates": cand_s,
                           "assign": assign_s}},
           "two_trainings_equal_centroids": same_centroids,
           "two_trainings_equal_assignments": same_assign,
           "flat": {"search_1_ms": flat_1, "search_64_ms": flat_64,
                    "gb": corpus.numel() * 4 / 1e9},
           "ivf_f32": f32, "ivf_int8": int8,
           "recall_at_10_probed_reference": recall_probed}
    # The f32 search must equal the plain float64 reference over the
    # probed partitions, and the store must hold only its index on the
    # card. Recall against exact MIPS is the balanced assignment's (JAX's
    # design): the rows it moves off their nearest centroid leave the
    # probed lists, 0.881-0.928 at nprobe 16 by k-means seed on this
    # corpus, so the f32 bound sits below those readings (0.86) and the
    # nearest-centroid lists must reach 0.95; int8 keeps tests/test_ann.py's
    # 0.8 and is no better than f32.
    rec["ok"] = (same_centroids and same_assign
                 and f32["same_as_probed_reference"]
                 and f32["store_rows_on_host"]
                 and device_bytes <= index_bytes + ANN_SLACK_BYTES
                 and f32["recall_at_10"] >= ANN_F32_RECALL
                 and recall_probed["nearest_assignment"] >= 0.95
                 and 0.8 <= int8["recall_at_10"] <= f32["recall_at_10"] + 0.02
                 and f32["alone_equals_batch"] and int8["alone_equals_batch"])
    del flat
    return rec, store, corpus, centers, cents, assign


def _ann_sharded(device, store, corpus, cents, assign, qs, nprobe):
    """(e) The sharded indexes over a mesh of two entries of the card
    (["cuda:0", "cuda:0"]: one process, as JAX runs them): a
    ShardedMIPSIndex (contiguous row blocks) against exact `mips_topk`
    over the same rows, and a ShardedIVFIndex (rows round-robin, one
    table a shard) from the IVF store's training state against that
    store's index; ids equal (in order but for near-ties), scanned rows
    equal, alone equal to batch; search ms for 1 and 64 queries."""
    import torch

    from generativeaiexamples_tpu_torch.config.schema import MeshConfig
    from generativeaiexamples_tpu_torch.ops.ivf import ShardedIVFIndex
    from generativeaiexamples_tpu_torch.ops.topk import (
        ShardedMIPSIndex, mips_topk)
    from generativeaiexamples_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(MeshConfig(ici_tensor=2), [device, device])
    rec = {"devices": [str(d) for d in mesh.devices]}
    t0 = time.perf_counter()
    flat = ShardedMIPSIndex(corpus, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s, i = flat.search(qs, 10)
    ws, wi = mips_topk(qs, corpus, 10)
    alone = torch.cat([flat.search(qs[r:r + 1], 10)[1] for r in range(8)])
    rec["mips"] = {
        "shards": flat.n_shards, "shard_rows": flat.shard_rows,
        "build_s": build_s, "shard_gb": flat.nbytes() / 1e9,
        "same_as_unsharded": _same_up_to_ties(
            i.cpu().numpy(), s.cpu().numpy(), wi.cpu().numpy(),
            ws.cpu().numpy()),
        "alone_equals_batch": bool(torch.equal(alone, i[:8])),
        "search_1_ms": time_ms(lambda: flat.search(qs[:1], 10), 10),
        "search_64_ms": time_ms(lambda: flat.search(qs, 10), 5)}
    del flat
    index = store._ivf
    t0 = time.perf_counter()
    sharded = ShardedIVFIndex(corpus, index.nlist, mesh, nprobe=nprobe,
                              centroids=cents, assignments=assign)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s, i, scanned = sharded.search(qs, 10)
    ws, wi, want_scanned = index.search(qs, 10)
    alone = torch.cat([sharded.search(qs[r:r + 1], 10)[1]
                       for r in range(8)])
    rec["ivf"] = {
        "shards": sharded.n_shards, "max_list_len": sharded.max_list_len,
        "unsharded_max_list_len": index.max_list_len,
        "build_s": build_s, "table_gb": sharded.table_bytes() / 1e9,
        "same_as_unsharded": _same_up_to_ties(
            i.cpu().numpy(), s.cpu().numpy(), wi.cpu().numpy(),
            ws.cpu().numpy()),
        "scanned_equal": scanned == want_scanned,
        "alone_equals_batch": bool(torch.equal(alone, i[:8])),
        "search_1_ms": time_ms(lambda: sharded.search(qs[:1], 10), 10),
        "search_64_ms": time_ms(lambda: sharded.search(qs, 10), 5),
        "unsharded_search_1_ms": time_ms(lambda: index.search(qs[:1], 10),
                                         10)}
    del sharded
    gc.collect()
    torch.cuda.empty_cache()
    rec["ok"] = all(rec[k]["same_as_unsharded"] and rec[k][
        "alone_equals_batch"] for k in ("mips", "ivf")) and rec["ivf"][
        "scanned_equal"]
    return rec


def _ann_stores(device, store_1m, corpus, qs, n_rows, nlist, nprobe,
                budget_mb, spill):
    """(d) The store's int8 and tiered paths as a deployment turns them
    on (`create_vector_store` over a config), on the first `n_rows` rows
    (taken from the 1M store's host rows): the card must hold only the
    index (the int8 table, or the tiered hot table inside
    `hbm_budget_mb`), never the rows."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.ops.topk import mips_topk
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        create_vector_store)

    rows = store_1m.rows()[:n_rows]
    names = [str(i) for i in range(n_rows)]
    _, exact = mips_topk(qs, corpus[:n_rows], 10)
    exact = exact.cpu().numpy()
    qn = qs.cpu().numpy()
    out = {}
    for name, extra in (
            ("int8", {}),
            ("tiered_int8", {"tiered": True, "hbm_budget_mb": budget_mb,
                             "ram_budget_mb": 4 * budget_mb,
                             "spill_dir": spill})):
        cfg = load_config(env={}, overrides={
            "vector_store": {"name": "tpu", "index_type": "ivf",
                             "nlist": nlist, "nprobe": nprobe,
                             "quantize_int8": True, **extra},
            "embeddings": {"dimensions": rows.shape[1]}})
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        store = create_vector_store(cfg, rows.shape[1], device=device)
        store.recall_sample_every = 1 << 30
        t0 = time.perf_counter()
        store.add(names, rows)
        hits = store.search_batch(qn, top_k=10)  # the first trains
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        index = store._ivf
        if hasattr(index, "wait_maintenance"):
            index.wait_maintenance()  # a pager pass the search kicked
        device_bytes = torch.cuda.memory_allocated() - base
        st = store.stats()
        if extra:
            bound = (budget_mb << 20) + index.centroids.numel() * 4
        else:
            bound = index.table_bytes() + index.centroids.numel() * 4
        got = np.array([[int(h.text) for h in hs] for hs in hits])
        rec = {"index": st["index"], "quantize_int8": st["quantize_int8"],
               "first_search_with_training_s": train_s,
               "device_gb": device_bytes / 1e9, "bound_gb": bound / 1e9,
               "rows_gb": n_rows * rows.shape[1] * 4 / 1e9,
               "rows_on_host": store.rows().device.type == "cpu",
               "recall_at_10": _recall(got, exact),
               "hbm_resident_fraction": st["hbm_resident_fraction"]}
        rec["ok"] = (rec["rows_on_host"] and st["quantize_int8"]
                     and st["index"] == ("ivf_tiered" if extra else "ivf")
                     and device_bytes <= bound + ANN_SLACK_BYTES
                     and rec["recall_at_10"] >= 0.8)
        out[name] = rec
        del store, index, hits
        gc.collect()
    out["rows"] = n_rows
    out["ok"] = all(r["ok"] for r in out.values() if isinstance(r, dict))
    return out


def _ann_tiered(device, store, corpus, centers, cents, assign, rows,
                nlist, nprobe, noise, budget_mb):
    """(c) The tiered index over the same corpus and training state, built
    from the IVF store's host rows: `budget_mb` of device memory and of
    RAM, a spill under the run's temporary directory; the card must hold
    no more than the budget and the centroids; 4 rounds of 64 queries
    skewed to 16 centers with a pager pass between rounds, then 4,096
    added rows found before and after a compaction."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch.ops import ivf
    from generativeaiexamples_tpu_torch.ops.tiered import TieredIVFIndex

    sub = corpus[:rows]
    plain = store._ivf if rows == len(corpus) else ivf.IVFIndex(
        sub, nlist, nprobe=nprobe, centroids=cents,
        assignments=assign[:rows])
    host_rows = store.rows()[:rows]
    spill = tempfile.mkdtemp(prefix="ann_spill_")
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tiered = TieredIVFIndex(host_rows, nlist, nprobe=nprobe,
                                hbm_budget_bytes=budget_mb << 20,
                                ram_budget_bytes=budget_mb << 20,
                                spill_dir=spill, centroids=cents,
                                assignments=assign[:rows], device=device)
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        device_bytes = torch.cuda.memory_allocated() - base
        bound = (budget_mb << 20) + cents.numel() * 4
        ts0 = tiered.tier_stats()
        rng = np.random.default_rng(8)
        hot_centers = rng.choice(len(centers), 16, replace=False)
        rounds, same = [], True
        for r in range(4):
            q = _near(centers, torch.as_tensor(
                rng.choice(hot_centers, 64), device=centers.device),
                noise, seed=100 + r)
            before = tiered.tier_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, i, scanned = tiered.search(q, 10)
            ms = (time.perf_counter() - t0) * 1e3
            after = tiered.tier_stats()
            ps, pi, _ = plain.search(q, 10)
            same = same and _same_up_to_ties(
                i, s, pi.cpu().numpy(), ps.cpu().numpy())
            hits = after["pager_probe_hits"] - before["pager_probe_hits"]
            probes = hits + after["pager_probe_misses"] - \
                before["pager_probe_misses"]
            t0 = time.perf_counter()
            tiered.run_maintenance()
            mnt_ms = (time.perf_counter() - t0) * 1e3
            ts = tiered.tier_stats()
            rounds.append({"search_64_ms": ms, "round_hit_rate": hits / probes,
                           "pager_hbm_hit_rate": after["pager_hbm_hit_rate"],
                           "host_rows_scanned": after[
                               "tier_host_scanned_rows"] - before[
                               "tier_host_scanned_rows"],
                           "maintenance_ms": mnt_ms,
                           "promotions": ts["tier_promotions"],
                           "demotions": ts["tier_demotions"]})
        # 4,096 new rows near random centers: each is its own top 1.
        g_ids = torch.as_tensor(rng.choice(len(centers), 4096),
                                device=centers.device)
        new = _near(centers, g_ids, noise, seed=200)
        n0 = tiered.n_rows
        added = tiered.add(new)
        want = list(range(n0, n0 + 64))
        _, found_before, _ = tiered.search(new[:64], 1)
        t0 = time.perf_counter()
        tiered._compact()
        compact_s = time.perf_counter() - t0
        _, found_after, _ = tiered.search(new[:64], 1)
        ts = tiered.tier_stats()
        rec = {"rows": rows, "build_s": build_s,
               "device_gb_after_build": device_bytes / 1e9,
               "bound_gb": bound / 1e9,
               "hot_slots": ts0["tier_hot_slots"],
               "hot_width": ts0["tier_hot_width"],
               "initial_resident_fraction": ts0["hbm_resident_fraction"],
               "spill_gb": ts0["tier_spill_bytes"] / 1e9,
               "rounds": rounds, "ids_match_plain_ivf": same,
               "added": added,
               "added_found_before_compaction":
                   found_before[:, 0].tolist() == want,
               "added_found_after_compaction":
                   found_after[:, 0].tolist() == want,
               "compact_s": compact_s, "compactions": ts["tier_compactions"],
               "tail_rows_after": ts["tier_tail_rows"]}
        rec["ok"] = (same and added and ts["tier_compactions"] == 1
                     and device_bytes <= bound + ANN_SLACK_BYTES
                     and rec["added_found_before_compaction"]
                     and rec["added_found_after_compaction"]
                     and rounds[1]["round_hit_rate"]
                     > rounds[0]["round_hit_rate"])
        del tiered
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    return rec


def _probed_reference(corpus, centroids, assign, qs, pids, k: int):
    """The plain reference of an IVF search: for each query, the exact top
    `k` in float64 among the rows that `assign` puts in its probed
    partitions `pids` [Q, P] (row lists from the assignments, not the
    index's table). Also checks the probes: the float64 coarse scan's
    top-P must equal `pids` as a set, or differ only at a near-tie
    (within 1e-5). Returns (ids [Q, k], scores [Q, k], probe mismatches
    outside a near-tie)."""
    import numpy as np
    import torch

    order = np.argsort(assign, kind="stable")
    bounds = np.searchsorted(assign[order], np.arange(len(centroids) + 1))
    coarse = (qs.double() @ centroids.double().T).cpu().numpy()
    pids = pids.cpu().numpy()
    ids, scores, bad_probes = [], [], 0
    for qi, probe in enumerate(pids):
        want = np.argsort(-coarse[qi], kind="stable")[:len(probe)]
        if set(want) != set(probe.tolist()) and \
                coarse[qi, want[-1]] - coarse[qi, probe].min() > 1e-5:
            bad_probes += 1
        rows = np.concatenate([order[bounds[p]:bounds[p + 1]] for p in probe])
        sc = corpus.index_select(0, torch.from_numpy(rows).to(
            corpus.device)).double() @ qs[qi].double()
        top = torch.topk(sc, min(k, len(rows)))
        ids.append(rows[top.indices.cpu().numpy()])
        scores.append(top.values.cpu().numpy())
    return np.array(ids), np.array(scores), bad_probes


def phase_ann(card: str, served: ServedEngine, keep: dict,
              device: str = "cuda", n_search: int = 16,
              max_tokens: int = 16, top_k: int = 5,
              rows: int = ANN_ROWS, dim: int = ANN_DIM,
              n_centers: int = ANN_CENTERS, nlist: int = ANN_NLIST,
              nprobe: int = ANN_NPROBE, tiered_rows: int = ANN_TIERED_ROWS,
              tier_budget_mb=None):
    """ANN retrieval (ops/ivf.py, ops/tiered.py) on the card:

    (a) the chain over an IVF store (nlist 64, nprobe 16, the config
        defaults) holding phase_rag's ingested chunks: `n_search`
        /search queries one at a time (the first trains the index) and
        then coalesced, with ids equal alone and coalesced, and the store
        alone equal to its batch; one knowledge-base /generate answer
        with no error frame. K3's launches must equal encoder layers x
        forwards, and K1 and K2 must launch.
    (b) `rows` unit rows of width `dim` around `n_centers` centers: the
        flat store against the IVF store (nlist, nprobe) on the same
        rows, the store trained by its first search from its host rows,
        its device bytes within its index's; train s (the store's, and
        by step on the card's rows), table GB, search ms for 1 and 64
        queries, the scanned share and recall@10 against exact
        `mips_topk` (f32 >= ANN_F32_RECALL, int8 >= 0.8 and no better
        than f32, nearest-centroid lists >= 0.95; k-means seeds
        ANN_SEEDS printed); f32 ids equal to the float64 reference over
        the probed partitions; alone equal to batch; the steps on the
        card's rows give the store's centroids and assignments.
    (c) the tiered index over the first `tiered_rows` of those rows and
        the same training (`tier_budget_mb` of device memory and of RAM,
        by default 1 GB for each 1M rows), built from the store's host
        rows: the card's bytes after the build within the budget; pager
        hit rate, promotions and search ms by round; ids equal to the
        plain IVF index's as sets, in order but for near-ties; added
        rows found before and after a compaction.
    (d) the store's int8 and tiered (int8, `tier_budget_mb // 4` of
        device memory) paths as a config turns them on, over the first
        `tiered_rows` rows: the card holds the index's table or its
        budget and the centroids, never the rows; recall@10 >= 0.8.
    (e) the sharded indexes over the same rows on a mesh of two entries
        of the card (`_ann_sharded`), against the unsharded ones.
    No kernel is new: the ANN search is plain torch."""
    import tempfile

    import torch

    if tier_budget_mb is None:
        tier_budget_mb = max(1, 1024 * tiered_rows // ANN_ROWS)
    chain = _ann_chain(served, keep, device, n_search, max_tokens, top_k)
    time_mark("ann_b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    big, store, corpus, centers, cents, assign = _ann_big(
        device, rows, dim, n_centers, ANN_NOISE, nlist, nprobe)
    time_mark("ann_c")
    tiered = _ann_tiered(device, store, corpus, centers, cents, assign,
                         tiered_rows, nlist, nprobe, ANN_NOISE,
                         tier_budget_mb)
    time_mark("ann_d")
    gc.collect()
    spill = tempfile.mkdtemp(prefix="ann_store_spill_")
    try:
        stores = _ann_stores(
            device, store, corpus,
            _near(centers, torch.arange(64, device=device), ANN_NOISE,
                  seed=6),
            tiered_rows, max(1, nlist * tiered_rows // rows), nprobe,
            max(1, tier_budget_mb // 4), spill)
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    time_mark("ann_e")
    sharded = _ann_sharded(
        device, store, corpus, cents, assign,
        _near(centers, torch.arange(64, device=device), ANN_NOISE, seed=6),
        nprobe)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del store, corpus, centers, cents
    gc.collect()
    torch.cuda.empty_cache()
    ok = (chain["ok"] and big["ok"] and tiered["ok"] and stores["ok"]
          and sharded["ok"])
    rec = {"phase": "ann", "card": card, "chain": chain, "store_1m": big,
           "tiered": tiered, "stores": stores, "sharded": sharded,
           "launches": chain["launches"],
           "peak_mem_gb": peak_gb, "ok": ok}
    emit(rec)
    return rec


# -- phase 11b: the other pipelines ---------------------------------------


class _RecordingLLM:
    """A chat connector that records each call's messages and passes the
    call on."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def stream_chat(self, messages, **kw):
        self.calls.append(list(messages))
        yield from self.inner.stream_chat(messages, **kw)

    def chat(self, messages, **kw) -> str:
        return "".join(self.stream_chat(messages, **kw))


PIPELINES_TABLE = (("Quarter", "Revenue", "Margin"), ("Q1", "1.2M", "31%"),
                   ("Q2", "1.5M", "33%"), ("Q3", "1.9M", "35%"))


def _pipelines_pdf() -> bytes:
    """A one-page PDF: a heading, PIPELINES_TABLE set cell by cell at
    column positions, a line of prose and an embedded chart (fake JPEG
    bytes that say CHART)."""
    ops = [b"BT", b"1 0 0 1 72 720 Tm (Quarterly revenue report) Tj"]
    for r, row in enumerate(PIPELINES_TABLE):
        for x, cell in zip((72, 220, 340), row):
            ops.append(b"1 0 0 1 %d %d Tm (%s) Tj"
                       % (x, 660 - 20 * r, cell.encode()))
    ops += [b"1 0 0 1 72 560 Tm (The chart below shows regional growth "
            b"trends.) Tj", b"ET"]
    return _pdf_bytes([ops], image=b"\xff\xd8\xff\xe0FAKECHART\xff\xd9")


_PPTX_NS = ('xmlns:p="http://schemas.openxmlformats.org/presentationml/2006/'
            'main" xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/'
            'main" xmlns:r="http://schemas.openxmlformats.org/'
            'officeDocument/2006/relationships"')


def _pipelines_deck() -> bytes:
    """A one-slide PPTX: two paragraphs, a 2x2 table, a chart image (fake
    JPEG bytes that say CHART) and speaker notes."""
    import io
    import zipfile

    def cell(t):
        return f"<a:tc><a:txBody><a:p><a:r><a:t>{t}</a:t></a:r></a:p>" \
               f"</a:txBody></a:tc>"

    slide = (f'<?xml version="1.0"?><p:sld {_PPTX_NS}><p:cSld><p:spTree>'
             "<p:sp><p:txBody><a:p><a:r><a:t>Serving overview</a:t></a:r>"
             "</a:p><a:p><a:r><a:t>Paged attention streams KV pages.</a:t>"
             "</a:r></a:p></p:txBody></p:sp><p:graphicFrame><a:graphic>"
             "<a:graphicData><a:tbl><a:tr>" + cell("Card") + cell("Memory")
             + "</a:tr><a:tr>" + cell("H100") + cell("80 GB") + "</a:tr>"
             "</a:tbl></a:graphicData></a:graphic></p:graphicFrame><p:pic>"
             '<p:blipFill><a:blip r:embed="rId2"/></p:blipFill></p:pic>'
             "</p:spTree></p:cSld></p:sld>")
    rels = ('<?xml version="1.0"?><Relationships xmlns="http://schemas.'
            'openxmlformats.org/package/2006/relationships">'
            '<Relationship Id="rId2" Target="../media/image1.jpeg"/>'
            '<Relationship Id="rId3" '
            'Target="../notesSlides/notesSlide1.xml"/></Relationships>')
    notes = (f'<?xml version="1.0"?><p:notes {_PPTX_NS}><p:cSld><p:spTree>'
             "<p:sp><p:txBody><a:p><a:r><a:t>Mention the decode throughput."
             "</a:t></a:r></a:p></p:txBody></p:sp></p:spTree></p:cSld>"
             "</p:notes>")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("ppt/slides/slide1.xml", slide)
        zf.writestr("ppt/slides/_rels/slide1.xml.rels", rels)
        zf.writestr("ppt/media/image1.jpeg",
                    b"\xff\xd8\xff\xe0FAKESLIDECHART\xff\xd9")
        zf.writestr("ppt/notesSlides/notesSlide1.xml", notes)
    return buf.getvalue()


def _stub_vlm():
    """An OpenAI-compatible image chat endpoint on a local port, for
    vlm.server_url: "yes" to the chart question for images whose bytes
    say CHART, a data table to the chart-to-table prompt, a description
    otherwise. (httpd, thread, url, the requests' prompts)."""
    import base64
    from http.server import BaseHTTPRequestHandler

    from generativeaiexamples_tpu_torch.serving.openai_server import (
        BurstHTTPServer)

    seen = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            text_part, image_part = body["messages"][0]["content"]
            prompt = text_part["text"]
            seen.append(prompt)
            image = base64.b64decode(
                image_part["image_url"]["url"].split(",", 1)[1])
            if prompt.startswith("Is this image a chart"):
                reply = "Yes." if b"CHART" in image else "No."
            elif prompt.startswith("Generate the underlying data table"):
                reply = "Region | Growth\nEMEA | 12%\nAPAC | 18%"
            else:
                reply = "a photo of a data center"
            data = json.dumps({"choices": [{"message": {
                "role": "assistant", "content": reply}}]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = BurstHTTPServer(("127.0.0.1", 0), Handler)
    httpd.daemon_threads = True
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, th, f"http://127.0.0.1:{httpd.server_address[1]}/v1", seen




def _delete(base, filename):
    req = urllib.request.Request(f"{base}/documents?filename={filename}",
                                 method="DELETE")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _first_token_ms(spans):
    """For each `generate` span: ms from its start to its trace's engine
    first token (None when the engine emitted none)."""
    by_trace = {}
    for sp in spans:
        by_trace.setdefault(sp.context.trace_id, []).append(sp)
    out = []
    for g in (sp for sp in spans if sp.name == "generate"):
        first = next((e for sp in by_trace[g.context.trace_id]
                      if sp.name == "engine.generate" for e in sp.events
                      if e.name == "first_token"), None)
        out.append((_span_s(first.timestamp) - _span_s(g.start_time)) * 1e3
                   if first else None)
    return out


# Scripted replies of the query-decomposition and knowledge-graph checks
# (random weights cannot write the JSON those agents parse).
PIPELINES_SUB_QUESTIONS = (
    "How does the prefill scheduler use the page cache?",
    "What bounds the attention kernel on the device?",
    "Which tokenizer does the chain server use?")
# The short chunks of the query-decomposition check's small store (each
# far under the 400-token sub-answer budget).
PIPELINES_QD_CHUNKS = (
    "The prefill scheduler reuses cached prefix pages from the page cache.",
    "Paged decode attention is bound by the bytes of the KV pages it reads.",
    "The chain server tokenizes prompts with the model's own tokenizer.",
    "Flash prefill attention tiles queries and keys in shared memory.",
    "The reranker scores each retrieved passage against the question.")
PIPELINES_KG_SCRIPT = [
    ("Extract knowledge-graph triples",
     "[('Pallas', 'TOOL', 'Produce', 'TPU Kernels', 'PRODUCT'), "
     "('TPU Kernels', 'PRODUCT', 'Impact', 'Serving Throughput', "
     "'METRIC')]"),
    ("entities", '{"entities": ["Pallas"]}')]


def phase_pipelines(card: str, served: ServedEngine, keep: dict,
                    device: str = "cuda", n_sessions: int = 2,
                    n_turns: int = 2, max_tokens: int = 16):
    """The other pipelines the chain server registers, over phase_rag's
    encoders and 2,001-chunk device store (`keep`) and the served 8B
    engine. Launch counts are reset at the start and read at the end.

    1. multi_turn_rag over HTTP, its conversation memory a
       DeviceVectorStore on the card: `n_sessions` concurrent sessions of
       `n_turns` knowledge-base turns each (`max_tokens`-token answers,
       traced for the time to the engine's first token). The memory must
       grow by n_sessions rows a turn; every saved row must
       equal, bit for bit, the embedder's direct embedding of its text;
       every history search of the later turns must give the ids of an
       exact host MIPS over the rows the memory held then; each later
       turn's prompt must carry a saved turn; /metrics must show
       `conv_store`.
    2. api_catalog: one answer on the engine whose user message carries
       the retrieved context.
    3. multimodal: a PDF (a positioned table and a chart image) and a
       deck uploaded through /documents into the same store, their images
       enriched by a stub VLM on a local port through connectors/vlm.py;
       the content_type="table" search must return the table chunk, one
       answer on the engine; the two files are deleted afterwards.
    4. query_decomposition and knowledge_graph over a scripted EchoLLM:
       three sub-questions must reach the embedder as one forward and the
       store as one search_batch, with the ids of exact MIPS, both over
       the corpus store and over a fresh device store of five short
       chunks, where each sub-question must be answered from its
       retrieved context; the extracted triples of a document uploaded to a fresh device store
       must reach the answer prompt.
    K1, K2 and K3 must launch."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.api.server import (
        ChainServer, make_http_server)
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.connectors.fakes import EchoLLM
    from generativeaiexamples_tpu_torch.obs import tracing
    from generativeaiexamples_tpu_torch.pipelines.base import (
        get_example_class)
    from generativeaiexamples_tpu_torch.pipelines.resources import Resources
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        DeviceVectorStore)

    t_phase = time.perf_counter()
    emb, rr, store = keep["emb"], keep["rr"], keep["store"]
    base_cfg = {"vector_store": {"name": "tpu"},
                "reranker": {"enabled": True},
                "embeddings": {"dimensions": emb.dim}}
    config = load_config(env={}, overrides=base_cfg)
    hub = EngineHub(config, llm=served.engine, embed=emb, rerank=rr,
                    device=device)
    m = served.engine.metrics
    exporter = tracing.MemoryExporter()
    vlm_httpd, vlm_th, vlm_url, vlm_seen = _stub_vlm()
    servers = []

    def serve(example):
        app = ChainServer(example.res.config, example=example)
        httpd = make_http_server(app, "127.0.0.1", 0)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        servers.append((app, httpd, th))
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    n_store = len(store)
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        f0 = emb.forwards

        # 1. multi_turn_rag: concurrent sessions, conversation memory on
        # the card.
        res = Resources(config, hub=hub, store=store)
        res.llm = _RecordingLLM(res.llm)
        conv = res.conv_store
        chat = get_example_class("multi_turn_rag")(res)
        tracing.setup(exporter=exporter)
        base = serve(chat)
        history = []
        real_search = conv.search

        def timed_search(qv, top_k=4, score_threshold=None):
            with conv._lock:  # the rows this search sees: the first n
                n = len(conv)
                t0 = time.perf_counter()
                hits = real_search(qv, top_k=top_k,
                                   score_threshold=score_threshold)
                ms = (time.perf_counter() - t0) * 1e3
            history.append({"qv": np.asarray(qv), "n": n, "hits": hits,
                            "ms": ms})
            return hits

        conv.search = timed_search
        sessions = [[] for _ in range(n_sessions)]
        turns = []
        for t in range(n_turns):
            exporter.clear()
            history.clear()
            n_calls = len(res.llm.calls)
            tokens0 = m.tokens_out
            questions = [f"Session {i}, turn {t}: how does the engine keep "
                         f"page {7 * i + t} of the cache warm?"
                         for i in range(n_sessions)]
            out = _together(n_sessions, lambda i: _chain_generate(
                base, questions[i], max_tokens, sessions[i]))
            torch.cuda.synchronize()
            errors = [repr(r) for r, _ in out if isinstance(r, Exception)]
            good = [r for r, _ in out if not isinstance(r, Exception)]
            for i, (r, _) in enumerate(out):
                if not isinstance(r, Exception):
                    sessions[i] += [{"role": "user", "content": questions[i]},
                                    {"role": "assistant", "content": r["text"]}]
            rows = conv.rows().cpu().numpy()
            texts = [d["text"] for d in conv.snapshot_docs()]
            exact = []
            for h in history:
                k = min(2, h["n"])
                if k == 0:
                    exact.append(h["hits"] == [])
                    continue
                ids = [texts.index(x.text) for x in h["hits"]]
                ok_, _, _ = _exact_topk_check(
                    rows[:h["n"]], h["qv"][None, :], [ids],
                    [[x.score for x in h["hits"]]], k)
                exact.append(ok_ and len(ids) == k)
            prompts = [c[0]["content"] for c in res.llm.calls[n_calls:]]
            carried = sum(any(x in p for x in texts) for p in prompts)
            ttft = _first_token_ms(exporter.get_finished_spans())
            turns.append({
                "turn": t, "errors": errors,
                "done_frames": sum(r["done_frame"] for r in good),
                "error_frames": sum(r["error_frames"] for r in good),
                "tokens_generated": m.tokens_out - tokens0,
                "conv_rows": len(conv),
                "history_searches": len(history),
                "history_exact": sum(exact),
                "history_search_ms_p50": _pct([h["ms"] for h in history],
                                              0.5),
                "history_search_ms_max": max((h["ms"] for h in history),
                                             default=None),
                "prompts_with_history": carried,
                "ttft_ms_p50": _pct(ttft, 0.5),
                "ttft_ms_max": max((x for x in ttft if x is not None),
                                   default=None),
                "ttft_ms_n": sum(x is not None for x in ttft),
                "first_frame_s_p50": _pct([r["first_frame_s"]
                                           for r in good], 0.5)})
        conv.search = real_search
        rows = conv.rows().cpu().numpy()
        texts = [d["text"] for d in conv.snapshot_docs()]
        same_bits = sum(np.array_equal(
            rows[i], np.asarray(res.embedder.embed_documents([x]))[0])
            for i, x in enumerate(texts))
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
        multi_turn = {"sessions": n_sessions, "turns": turns,
                      "saved_rows_bit_identical": same_bits,
                      "conv_store_metrics": metrics.get("conv_store"),
                      "conv_store_device": str(conv.device)}
        multi_ok = (isinstance(conv, DeviceVectorStore)
                    and conv.device.type == torch.device(device).type
                    and same_bits == len(texts) == n_sessions * n_turns
                    and metrics.get("conv_store", {}).get("ntotal")
                    == n_sessions * n_turns
                    and all(tr["errors"] == [] and tr["error_frames"] == 0
                            and tr["done_frames"] == n_sessions
                            and tr["conv_rows"] == n_sessions * (tr["turn"]
                                                                 + 1)
                            and tr["history_searches"] == n_sessions
                            and tr["history_exact"] == n_sessions
                            and tr["tokens_generated"] >= n_sessions
                            for tr in turns)
                    and all(tr["prompts_with_history"] == n_sessions
                            for tr in turns[1:]))
        tracing._ENABLED = False  # the rest of the phase runs untraced

        # 2. api_catalog: the context rides in the user message.
        catalog = get_example_class("api_catalog")(res)
        tokens0 = m.tokens_out
        t0 = time.perf_counter()
        pieces = list(catalog.rag_chain(
            "How does the prefill scheduler use the page cache?", [],
            max_tokens=max_tokens))
        user = res.llm.calls[-1][-1]["content"]
        context = user.split("Context:\n", 1)[-1].split("\n\nQuestion:")[0]
        doc_texts = {d["text"] for d in store.snapshot_docs()}
        api_catalog = {"seconds": time.perf_counter() - t0,
                       "pieces": len(pieces),
                       "tokens_generated": m.tokens_out - tokens0,
                       "context_chunks": len(context.split("\n\n")),
                       "context_in_user_message": user.startswith(
                           "Answer the question using the context below.")}
        api_ok = (api_catalog["context_in_user_message"]
                  and all(c in doc_texts for c in context.split("\n\n"))
                  and api_catalog["tokens_generated"] >= 1)

        # 3. multimodal: a PDF and a deck, images through the stub VLM.
        mm_cfg = load_config(env={}, overrides={
            **base_cfg, "vlm": {"server_url": vlm_url}})
        mm = get_example_class("multimodal")(
            Resources(mm_cfg, hub=hub, store=store))
        mm_base = serve(mm)
        t0 = time.perf_counter()
        uploads = [_upload(mm_base, "report.pdf", _pipelines_pdf()),
                   _upload(mm_base, "deck.pptx", _pipelines_deck())]
        ingest_s = time.perf_counter() - t0
        added = len(store) - n_store
        kinds = {}
        for d in store.snapshot_docs()[n_store:]:
            ct = d["metadata"]["content_type"]
            kinds[ct] = kinds.get(ct, 0) + 1
        t0 = time.perf_counter()
        tables = mm.document_search("quarterly revenue margin", 2,
                                    content_type="table")
        images = mm.document_search("regional growth chart", 2,
                                    content_type="image")
        search_ms = (time.perf_counter() - t0) * 1e3 / 2
        tokens0 = m.tokens_out
        answer = _chain_generate(mm_base, "What were the Q2 revenue and "
                                          "margin?", max_tokens)
        answer["tokens_generated"] = m.tokens_out - tokens0
        deleted = [_delete(mm_base, n) for n in ("report.pdf", "deck.pptx")]
        multimodal = {"uploads": uploads, "ingest_s": ingest_s,
                      "chunks_added": added, "content_types": kinds,
                      "vlm_requests": len(vlm_seen),
                      "table_hits": [x["content"] for x in tables],
                      "image_hit": images[0]["content"] if images else None,
                      "filtered_search_ms": search_ms, "answer": answer,
                      "deleted": deleted, "store_rows_after": len(store)}
        mm_ok = (all(u.get("message", "").endswith("uploaded successfully")
                     for u in uploads)
                 and kinds.get("table", 0) >= 2 and kinds.get("image") == 2
                 and len(vlm_seen) == 4
                 and any("Q2 | 1.5M | 33%" in x["content"] for x in tables)
                 and all(x["content_type"] == "table" for x in tables)
                 and bool(images) and "EMEA | 12%" in images[0]["content"]
                 and answer["done_frame"] and answer["error_frames"] == 0
                 and 1 <= answer["tokens_generated"] <= max_tokens
                 and len(store) == n_store)

        # 4. query_decomposition and knowledge_graph over a scripted LLM.
        def decompose(qstore):
            """One query_decomposition answer over `qstore`: its three
            sub-questions' embed forwards and search_batch calls, whether
            their hits equal exact MIPS, and how many sub-answers came
            from retrieved context."""
            decisions = iter([
                json.dumps({"action": "search",
                            "input": list(PIPELINES_SUB_QUESTIONS)}),
                json.dumps({"action": "final", "answer": "done"})])

            class Scripted(EchoLLM):
                def stream_chat(self, messages, **kw):
                    self.calls.append(list(messages))
                    if "Answer briefly and only from the context" in \
                            messages[0]["content"]:
                        yield "a sub-answer"
                        return
                    yield next(decisions, "final answer")

            qd_llm = Scripted()
            qd = get_example_class("query_decomposition")(
                Resources(config, hub=hub, llm=qd_llm, store=qstore))
            batches = []
            real_sb = qstore.search_batch

            def recorded_sb(qs, top_k=4, score_threshold=None):
                out = real_sb(qs, top_k=top_k,
                              score_threshold=score_threshold)
                batches.append((np.asarray(qs), top_k, out))
                return out

            qstore.search_batch = recorded_sb
            try:
                f1 = emb.forwards
                b0 = qstore.stats()["batched_searches"]
                t0 = time.perf_counter()
                list(qd.rag_chain("Compare the scheduler, the kernel and "
                                  "the tokenizer.", []))
                qd_s = time.perf_counter() - t0
                qd_forwards = emb.forwards - f1
                qd_batched = qstore.stats()["batched_searches"] - b0
            finally:
                del qstore.search_batch
            all_texts = [d["text"] for d in qstore.snapshot_docs()]
            qd_exact = False
            if len(batches) == 1:
                qs, k, hits = batches[0]
                qd_exact, _, _ = _exact_topk_check(
                    qstore.rows().cpu().numpy(), qs,
                    [[all_texts.index(h.text) for h in hl] for hl in hits],
                    [[h.score for h in hl] for hl in hits], k)
            final = qd_llm.calls[-1][-1]["content"]
            out = {"store_rows": len(qstore),
                   "sub_questions": len(PIPELINES_SUB_QUESTIONS),
                   "embed_forwards": qd_forwards,
                   "search_batch_calls": qd_batched,
                   "batched_queries": [len(b[0]) for b in batches],
                   "exact_ok": qd_exact, "llm_calls": len(qd_llm.calls),
                   "sub_answers_from_context": final.count(
                       "A: a sub-answer"),
                   "seconds": qd_s}
            ok = (qd_forwards == 1 and qd_batched == 1
                  and out["batched_queries"] == [3] and qd_exact
                  and all(f"- Q: {q}\n  A: " in final
                          for q in PIPELINES_SUB_QUESTIONS))
            return out, ok

        # Over the 2,001-chunk store a sub-question is answered from its
        # hits that fit 400 tokens; the default splitter's chunks (508)
        # never do, so each answer is "No relevant information found."
        # (as in JAX). A small store of short chunks runs the sub-answer
        # step: every sub-question must be answered from its context.
        qd_big, qd_big_ok = decompose(store)
        qd_store = DeviceVectorStore(emb.dim, device=device)
        qd_store.add(PIPELINES_QD_CHUNKS, emb.embed(PIPELINES_QD_CHUNKS))
        qd_small, qd_small_ok = decompose(qd_store)
        query_decomposition = {"corpus": qd_big, "short_chunks": qd_small}
        qd_ok = (qd_big_ok and qd_small_ok
                 and qd_small["sub_answers_from_context"]
                 == len(PIPELINES_SUB_QUESTIONS))

        kg_llm = EchoLLM(script=PIPELINES_KG_SCRIPT)
        kg_store = DeviceVectorStore(emb.dim, device=device)
        kg = get_example_class("knowledge_graph")(
            Resources(config, hub=hub, llm=kg_llm, store=kg_store))
        kg_base = serve(kg)
        t0 = time.perf_counter()
        kg_upload = _upload(kg_base, "kg.txt", "Pallas produces TPU kernels. "
                            "Those kernels impact serving throughput.")
        kg_answer = _chain_generate(kg_base, "What does Pallas produce?",
                                    max_tokens)
        kg_prompt = kg_llm.calls[-1][-1]["content"]
        knowledge_graph = {
            "upload": kg_upload, "triples": len(kg.res.kg_graph),
            "store_rows": len(kg_store), "answer": kg_answer,
            "triples_in_prompt": ("Pallas Produce TPU Kernels" in kg_prompt
                                  and "TPU Kernels Impact Serving "
                                      "Throughput" in kg_prompt),
            "seconds": time.perf_counter() - t0}
        kg_ok = (kg_upload.get("message", "").endswith("uploaded "
                                                       "successfully")
                 and knowledge_graph["triples"] == 2
                 and len(kg_store) >= 1 and kg_answer["done_frame"]
                 and kg_answer["error_frames"] == 0
                 and knowledge_graph["triples_in_prompt"])
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        forwards = emb.forwards - f0
    finally:
        for app, httpd, th in servers:
            _stop_server(app, httpd, th)
        vlm_httpd.shutdown()
        vlm_httpd.server_close()
        vlm_th.join(timeout=30)
        tracing._ENABLED = False
    seconds = time.perf_counter() - t_phase
    ok = (multi_ok and api_ok and mm_ok and qd_ok and kg_ok
          and all(launches[k] > 0 for k in ("flash_attention",
                                            "paged_attention",
                                            "encoder_attention")))
    rec = {"phase": "pipelines", "card": card, "seconds": seconds,
           "multi_turn_rag": multi_turn, "multi_turn_ok": multi_ok,
           "api_catalog": api_catalog, "api_catalog_ok": api_ok,
           "multimodal": multimodal, "multimodal_ok": mm_ok,
           "query_decomposition": query_decomposition, "qd_ok": qd_ok,
           "knowledge_graph": knowledge_graph, "kg_ok": kg_ok,
           "embed_forwards": forwards, "launches": launches, "ok": ok}
    emit(rec)
    return rec


# -- phase 12: the int8 deployment at 8B ---------------------------------

# The JAX package's documented int8 deployment (docs/deployment.md):
# llama3-8b, int8 weights + int8 KV, max_batch_size 128, page_size 128.
# Its pool is sized by the memory planner (auto_pool_pages: the card's
# memory less the headroom, the weights and the scratch and activation
# estimates), where the worst case (128 x 64 + 64 + 1 pages, ~71 GB)
# does not fit one 80 GB card beside the weights.
INT8_DEPLOYMENT = {"quantize_weights": "int8", "kv_dtype": "int8",
                   "max_batch_size": 128, "page_size": 128,
                   "max_seq_len": 8192, "auto_pool_pages": True}


def _int8_prompts(n_requests: int):
    """The int8 phases' prompts: 20-400 random letters each (seed 3)."""
    import numpy as np

    rng = np.random.default_rng(3)
    return ["".join(chr(c) for c in rng.integers(97, 123, n))
            for n in rng.integers(20, 401, n_requests)]


def _burst(base, prompts, max_tokens):
    """All prompts as concurrent greedy completions; their results."""
    results = [None] * len(prompts)

    def run(i):
        results[i] = _complete(base, prompts[i], max_tokens)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    time_mark("burst_done")
    return results


def _page_round_trip(pool, pages):
    """The KV pager's page moves on an int8 pool: random codes and scales
    written into `pages`, read out with pool_to_pages and copied to host
    memory, the pages zeroed, the host copy scattered back with
    pages_to_pool: codes and scales must come back bit-identical."""
    import torch

    from generativeaiexamples_tpu_torch.serving import engine_model

    dev = pool.kv.device
    row = torch.tensor(pages, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    codes = torch.randint(-127, 128, (len(pages),) + pool.kv[:, :, :, 0].shape,
                          generator=g, device=dev).to(torch.int8)
    scales = torch.rand((len(pages),) + pool.s[:, :, :, 0].shape,
                        generator=g, device=dev)
    engine_model.pages_to_pool(pool, codes, scales, row)
    got, got_s = engine_model.pool_to_pages(pool, row)
    host, host_s = got.cpu().numpy(), got_s.cpu().numpy()
    pool.kv[:, :, :, row] = 0
    pool.s[:, :, :, row] = 0
    engine_model.pages_to_pool(pool, torch.from_numpy(host).to(dev),
                               torch.from_numpy(host_s).to(dev), row)
    back, back_s = engine_model.pool_to_pages(pool, row)
    torch.cuda.synchronize()
    ok = bool(torch.equal(back, codes) and torch.equal(back_s, scales))
    return {"pages": list(pages),
            "bytes": back.numel() + 4 * back_s.numel(), "ok": ok}


def phase_serving_int8(card: str, model_size: str = "8b",
                       device: str = "cuda", n_requests: int = 128,
                       max_tokens: int = 16, long_prompt: int = 6000,
                       n_pages=None, engine_cfg=None):
    """The int8 engine behind the OpenAI server: n_requests concurrent
    greedy completions of max_tokens with prompts of 20-400 bytes (seed
    3), then one long_prompt-token prompt through the chunked lane into
    the int8 pool. Every request must finish ("length" or "stop", never
    "error") with tokens; K6, K4 and K1 must launch in the window, K2
    not. Tokens/s, TTFT and memory are printed for information, and the
    same burst runs again under the profiler (outside the counted
    window) for the device's busy time and idle share.

    With n_pages None the memory planner sizes the pool (the deployment's
    auto_pool_pages): its breakdown is printed, its weights line must
    equal the bytes the weight tree holds on the card and its page bytes
    times its pages the pool tensors' bytes; the peak allocated over the
    burst and the long prompt is printed beside the plan's total and the
    budget (hbm - headroom), with the bytes other phases left resident
    counted apart. The plan's hbm is the card's memory less those bytes
    (`hbm_gb_per_device`), as if the engine had the card alone: its
    activation line then holds the warmed engine's prefill graphs, which
    keep their pool (serving/step_graphs.py). Returns (the record, the
    closed ServedEngine), whose weights, pool size and token streams the
    speculative phase reuses."""
    import torch

    from generativeaiexamples_tpu_torch import kernels

    ecfg = dict(engine_cfg or INT8_DEPLOYMENT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    if ecfg.get("auto_pool_pages") and n_pages is None and torch.device(
            device).type == "cuda" and not ecfg.get("hbm_gb_per_device"):
        total = torch.cuda.get_device_properties(
            torch.device(device)).total_memory
        ecfg["hbm_gb_per_device"] = (total - resident) / 2**30
    served = ServedEngine(model_size, device, engine_cfg=ecfg,
                          n_pages=n_pages, warmup_buckets=[128, 512])
    engine = served.engine
    plan = engine.memory_plan
    try:
        prompts = _int8_prompts(n_requests)

        def burst(tokens=max_tokens):
            return _burst(served.base, prompts, tokens)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        results = burst()
        wall = time.perf_counter() - t0
        metrics = engine.metrics.snapshot()
        g = torch.Generator().manual_seed(7)
        ids = torch.randint(0, 256, (long_prompt,), generator=g).tolist()
        long_rec = _complete(served.base, ids, 8)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        pool = engine.pool
        # Outside the counted window: the same burst again (16 tokens a
        # request) under the profiler, for where its time goes.
        profile = _profile_window(lambda: sum(
            r["completion_tokens"] for r in burst(16) if r))
        # Read before the close drops the graphs.
        graphs = (engine._graphs.stats() if engine._graphs is not None
                  else None)
    finally:
        served.close()
    # With the engine stopped, a few free pages of its int8 pool make
    # the pager's round trip.
    round_trip = _page_round_trip(pool, engine.allocator._free[-4:])
    tokens = sum(r["completion_tokens"] for r in results if r)
    finished = all(r is not None and r["finish_reason"] in ("length", "stop")
                   and r["completion_tokens"] >= 1 for r in results)
    ok = (finished and long_rec["finish_reason"] in ("length", "stop")
          and long_rec["completion_tokens"] >= 1
          and launches["int8_matmul"] > 0
          and launches["paged_attention_int8"] > 0
          and launches["flash_attention"] > 0
          and launches["paged_attention"] == 0 and round_trip["ok"]
          and (n_pages is not None or plan is not None))
    max_pages = ecfg["max_seq_len"] // ecfg["page_size"]
    default_pages = ecfg["max_batch_size"] * max_pages + max_pages + 1
    n_pool = pool.n_pages
    planner = None
    if plan is not None:
        weight_bytes = _tree_bytes(engine.params)
        gib = float(1 << 30)
        budget = plan.hbm_bytes_per_device - plan.headroom_bytes
        planner = {
            "breakdown": plan.breakdown(),
            "lines": {line.name: line.bytes_per_device
                      for line in plan.lines},
            "hbm_bytes": plan.hbm_bytes_per_device,
            "headroom_bytes": plan.headroom_bytes,
            "page_bytes": plan.page_bytes_per_device,
            "fit_pages": plan.fit_pages, "pool_pages": plan.pool_pages,
            "weights_line_equals_tree": (
                plan.lines[0].bytes_per_device == weight_bytes),
            "tree_bytes": weight_bytes,
            "pool_line_equals_tensors": (
                plan.page_bytes_per_device * plan.pool_pages
                == pool.nbytes),
            "pool_tensor_bytes": pool.nbytes,
            "plan_total_gib": plan.total_bytes_per_device / gib,
            "budget_gib": budget / gib,
            "resident_before_gib": resident / gib,
            "peak_gib": peak_gb,
            "engine_peak_gib": peak_gb - resident / gib,
            "engine_peak_within_budget": (
                peak_gb * gib - resident <= budget),
            "peak_within_budget": peak_gb * gib <= budget}
        print(plan.breakdown(), flush=True)
    rec = {"phase": "serving_int8", "card": card,
           "model": f"llama3_{model_size} random (seed 0), int8 weights "
                    f"quantized at load, int8 KV",
           "engine": ecfg, "layers": engine.cfg.n_layers,
           "reduced": {"n_pages": n_pool,
                       "sized_by": ("the memory planner" if plan is not None
                                    else "n_pages"),
                       "default_n_pages": default_pages,
                       "pool_gb": pool.nbytes / 1e9,
                       "default_pool_gb": pool.nbytes / n_pool
                       * default_pages / 1e9},
           "planner": planner,
           "engine_build_s": served.build_s, "warmup_s": served.warm_s,
           "requests": n_requests, "max_tokens": max_tokens,
           "prompt_bytes": [int(min(len(p) for p in prompts)),
                            int(max(len(p) for p in prompts))],
           "completion_tokens": tokens,
           "finish_reasons": sorted({r["finish_reason"] for r in results
                                     if r}),
           "wall_s": wall, "tokens_per_s": tokens / wall if wall else None,
           "ttft_p50_ms": metrics["ttft_p50_ms"],
           "ttft_p95_ms": metrics["ttft_p95_ms"],
           "decode_steps": metrics["decode_steps"],
           "mean_batch_occupancy": metrics["mean_batch_occupancy"],
           "long_prompt": {"tokens": long_prompt, **long_rec},
           "launches": launches, "peak_mem_gb": peak_gb,
           "page_round_trip": round_trip, "profile": profile, "ok": ok}
    rec["graphs"] = graphs
    if planner is not None and graphs is not None:
        # The warmed engine's CUDA graphs reserve their pool on top of the
        # plan, out of its headroom.
        planner["graph_pool_bytes"] = graphs["pool_bytes"]
        planner["graph_pool_over_headroom"] = (
            graphs["pool_bytes"] / plan.headroom_bytes
            if plan.headroom_bytes else None)
    if planner is not None:
        rec["ok"] = (ok and planner["weights_line_equals_tree"]
                     and planner["pool_line_equals_tensors"]
                     and n_pool == plan.pool_pages)
    emit(rec)
    return rec, served


# -- the attribution tools (generativeaiexamples_tpu_torch/scripts/) --------

# A request's first-token stage (stage_rows: submit to the first-token
# event) against the TTFT its engine's histogram observed: the engine
# reads one clock, per slot at its emission, for both.
TTFT_AGREE_MS = 1.0
# decompose_decode's interleaved rounds at B = 128 (one K = 8 block of
# each variant a round, after one untimed block each): two paired
# differences for the median and their range.
DECOMPOSE_ROUNDS = 2
DECOMPOSE_B = 128
TUTORIAL_02 = os.path.join("generativeaiexamples_tpu_torch", "examples",
                           "tutorials", "02_serving_engine.py")


def _ttft_table(engine) -> dict:
    """ttft_breakdown.stage_rows over every request the (stopped) engine
    served: each row must hold every stage, none negative, its total
    within TTFT_AGREE_MS of the TTFT the histogram observed for it (the
    first-token event's value), and the histogram must hold exactly
    these requests. Also reports how long each first token waited on the
    host after its block landed (the event's `b`: the earlier slots'
    emission), which must lie within the request's first-token stage."""
    import statistics

    from generativeaiexamples_tpu_torch.scripts import ttft_breakdown
    from generativeaiexamples_tpu_torch.serving import flight

    events = engine.flight.snapshot_events()
    rids = [e["rid"] for e in events if e["kind"] == flight.EV_SUBMIT]
    observed = {e["rid"]: e["a"] for e in events
                if e["kind"] == flight.EV_FIRST_TOKEN}
    after_landing = {e["rid"]: e["b"] for e in events
                     if e["kind"] == flight.EV_FIRST_TOKEN}
    rows = ttft_breakdown.stage_rows(engine.flight, rids)
    stages = ttft_breakdown.STAGES
    whole = all(all(s in r for s in stages) for r in rows)
    monotone = all(r[s] >= 0 for r in rows for s in stages if s in r)
    gaps = [abs(r["total"] - observed[rid]) for rid, r in zip(rids, rows)
            if rid in observed]
    hist = engine.metrics.hists["ttft_ms"].snapshot()
    totals = [r["total"] for r in rows]
    waits = sorted(after_landing[rid] for rid in rids
                   if rid in after_landing)
    waits_within = all(0.0 <= after_landing[rid] <= r["first_token"]
                       for rid, r in zip(rids, rows) if rid in after_landing)
    ok = (bool(rows) and whole and monotone and len(gaps) == len(rows)
          and max(gaps) <= TTFT_AGREE_MS and hist["count"] == len(rows)
          and abs(hist["sum"] - sum(totals)) <= TTFT_AGREE_MS * len(rows)
          and waits_within)
    return {"requests": len(rows),
            "median": ttft_breakdown.median_row(rows),
            "p95_total_ms": sorted(totals)[int(0.95 * (len(totals) - 1))]
            if totals else None,
            "max_total_ms": max(totals, default=None),
            "worst_vs_hist_ms": max(gaps, default=None),
            "hist_count": hist["count"], "hist_sum_ms": hist["sum"],
            "rows_sum_ms": sum(totals),
            "hist_p50_ms": hist["p50"], "rows_p50_ms": statistics.median(
                totals) if totals else None,
            "emitted_after_landing_ms": {
                "p50": statistics.median(waits) if waits else None,
                "max": max(waits, default=None)},
            "whole": whole, "monotone": monotone,
            "waits_within_stage": waits_within, "ok": ok}


def phase_tools_int8(card: str, int8_served, device: str = "cuda",
                     B: int = DECOMPOSE_B, n_rounds: int = DECOMPOSE_ROUNDS,
                     mm_shape=None):
    """The attribution tools on serving_int8's deployment, after its
    engine stopped: ttft_breakdown's stage table of the phase's own
    requests (_ttft_table); with the engine's pool released,
    decompose_decode's four variants over its int8 weights at batch B,
    int8 KV, interleaved over n_rounds, with the profiler's device times
    (the full variant's tokens must be the same after the stubs' context
    manager as before it, the bindings the same objects, and K4's device
    time must show in the full block's profile); then
    profile_card's dispatch and bandwidth rows (bf16 torch.matmul against
    K6 at 8B decode widths). Returns (the record, the pool's page count,
    for spec_int8)."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.scripts import (
        decompose_decode, profile_card)

    engine = int8_served.engine
    t0 = time.perf_counter()
    ttft = _ttft_table(engine)
    t_ttft = time.perf_counter() - t0
    n_pages = engine.pool.n_pages
    _release_engine(engine)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    setup = decompose_decode.decode_setup(engine.cfg, B, "int8", device)
    kernels.reset_launches()
    dec = decompose_decode.decompose(engine.params, engine.cfg, setup,
                                     n_rounds)
    dec_launches = dict(kernels.LAUNCHES)
    t_dec = time.perf_counter() - t0
    for line in decompose_decode.format_rows(dec):
        print(line, flush=True)
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.reset_launches()
    bandwidth = profile_card.bandwidth_rows(
        device, mm_shape or profile_card.MM_SHAPE)
    bw_launches = dict(kernels.LAUNCHES)
    dispatch = profile_card.dispatch_overhead(device)
    t_prof = time.perf_counter() - t0
    full_dev = dec["variants"]["full"]["device"]
    dec_ok = (dec["full_tokens_equal_after_stubs"] and dec["bindings_restored"]
              and dec_launches["paged_attention_int8"] > 0
              and dec_launches["int8_matmul"] > 0
              and full_dev is not None
              and full_dev["paged_attention_int8_ms"] > 0)
    rec = {"phase": "tools", "part": "int8", "card": card,
           "ttft_breakdown": ttft,
           "decompose_decode": {**dec, "launches": dec_launches,
                                "ok": dec_ok},
           "profile_card": {"bandwidth": bandwidth, "dispatch": dispatch,
                            "launches": bw_launches},
           "seconds": {"ttft": t_ttft, "decompose": t_dec,
                       "profile": t_prof},
           "ok": ttft["ok"] and dec_ok and bw_launches["int8_matmul"] > 0}
    emit(rec)
    return rec, n_pages


def phase_tools_encoders(card: str, device: str = "cuda", B: int = 32,
                         S: int = 512, cfg=None, n_docs=None):
    """decompose_bert_forward's three variants, its profiler split of
    the full forward's device time by kernel class, and one
    decompose_encoders batch size at arctic-embed-l (bf16, random
    weights from seed 0), B = 32, S = 512: the full forward launches K3,
    the tool's fused_qkv loop (the same math in bf16) must agree with it
    within BF16_ATOL relative to max |out|, every time must be
    positive, and the split must hold K3's device time."""
    import dataclasses

    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.models import bert
    from generativeaiexamples_tpu_torch.scripts import (
        decompose_bert_forward, decompose_encoders)
    from generativeaiexamples_tpu_torch.serving.encoders import (
        EmbeddingEngine)
    from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

    cfg = cfg or dataclasses.replace(bert.BertConfig.arctic_embed_l(),
                                     dtype=torch.bfloat16)
    params = bert.init_params(
        cfg, device, torch.Generator(device=device).manual_seed(0))
    t0 = time.perf_counter()
    kernels.reset_launches()
    fwd = decompose_bert_forward.decompose(params, cfg, B, S, device)
    fwd_launches = dict(kernels.LAUNCHES)
    rng = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=rng,
                         device=device, dtype=torch.int32)
    lens = torch.full((B,), S, dtype=torch.int32, device=device)
    full, fused = (decompose_bert_forward.forward_variant(
        params, cfg, toks, lens, m).float() for m in ("full", "fused_qkv"))
    rel = float((full - fused).abs().max() / full.abs().max())
    kernels.reset_launches()
    split = decompose_bert_forward.device_split(params, cfg, B, S, device)
    split_launches = dict(kernels.LAUNCHES)
    t_fwd = time.perf_counter() - t0
    print(decompose_bert_forward.format_row("arctic-embed-l", fwd),
          flush=True)
    t0 = time.perf_counter()
    emb = EmbeddingEngine(params, cfg, ByteTokenizer(), max_batch=B,
                          buckets=decompose_encoders.BUCKETS, device=device)
    n = n_docs or decompose_encoders.N_DOCS
    kernels.reset_launches()
    enc = decompose_encoders.measure(
        emb, decompose_encoders.mktexts(n, 500),
        decompose_encoders.mktexts(n, 48, seed=1))
    enc_launches = dict(kernels.LAUNCHES)
    t_enc = time.perf_counter() - t0
    print(decompose_encoders.format_row(enc), flush=True)
    ok = (fwd_launches["encoder_attention"] > 0 and rel <= BF16_ATOL
          and split_launches["encoder_attention"] > 0
          and split["by_class_ms"]["K3"] > 0
          and enc_launches["encoder_attention"] > 0
          and all(r["ms"] > 0 for r in fwd["modes"].values())
          and enc["batch_chain_ms"] > 0 and enc["docs_per_s"] > 0)
    rec = {"phase": "tools", "part": "encoders", "card": card,
           "decompose_bert_forward": {
               **fwd, "launches": fwd_launches,
               "fused_qkv_vs_full_rel_err": rel,
               "device_split": {**split, "launches": split_launches}},
           "decompose_encoders": {**enc, "launches": enc_launches},
           "seconds": {"bert_forward": t_fwd, "encoders": t_enc}, "ok": ok}
    emit(rec)
    return rec


def phase_tutorial(card: str, device_args=(), timeout_s: float = 300):
    """The port's tutorial 02 (the serving engine) in a subprocess on the
    card: it must exit 0, and its printed metrics must show K1 and K2
    launches above 0 (its own process counts them, zeroed after the
    engine's warmup, so only served requests count). Its speculative and
    greedy token lines are compared and the first divergent position
    printed (a finding: bf16 near-ties on random weights)."""
    import re

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, TUTORIAL_02, *device_args], capture_output=True,
        text=True, cwd=ROOT_DIR, timeout=timeout_s)
    secs = time.perf_counter() - t0
    out = proc.stdout

    def count(name):
        m = re.search(rf"'kernel_launches_{name}': (\d+)", out)
        return int(m.group(1)) if m else None

    def tokens(prefix):
        line = next((ln for ln in out.splitlines()
                     if ln.startswith(prefix)), "")
        return [int(t) for t in re.findall(r"-?\d+", line.split(":", 1)[-1])]

    launches = {n: count(n) for n in ("flash_attention", "paged_attention",
                                      "paged_attention_tree",
                                      "paged_attention_int8", "int8_matmul",
                                      "encoder_attention")}
    spec, greedy = tokens("speculative tokens:"), tokens("greedy tokens:")
    chunked = tokens("long-prompt continuation:")
    rec = {"phase": "tools", "part": "tutorial_02", "card": card,
           "returncode": proc.returncode, "seconds": secs,
           "launches": launches, "speculative": spec, "greedy": greedy,
           "speculative_equals_greedy": spec == greedy,
           "first_divergence": _first_divergence(spec, greedy),
           "chunked_tokens": len(chunked),
           "stderr_tail": proc.stderr[-1500:] if proc.returncode else "",
           "ok": (proc.returncode == 0
                  and (launches["flash_attention"] or 0) > 0
                  and (launches["paged_attention"] or 0) > 0
                  and len(chunked) == 4 and len(greedy) == 12)}
    emit(rec)
    return rec


# -- phase 13: greedy self-speculation at 8B ------------------------------

# bench.py's default lattice (k = 3, M = 4, its step plans left off) and
# the r05 official config (k = 1, bench.py:59), on the int8 deployment.
SPEC_INT8_CONFIGS = (("tree_k3_m4", {"speculative_k": 3,
                                     "speculative_tree_branches": 4}),
                     ("linear_k1", {"speculative_k": 1}))


def _first_divergence(got, want):
    """Index of the first token where two streams differ (None if equal)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def phase_spec_int8(card: str, int8_served, device: str = "cuda",
                    n_requests: int = 128, max_tokens: int = 16,
                    n_pages=None, engine_cfg=None,
                    configs=SPEC_INT8_CONFIGS, profile_tokens: int = 16):
    """Speculative engines on the int8 deployment, over serving_int8's
    quantized weights (its engine and pool are released first; n_pages
    None: as many pages as its planned pool), each
    behind the OpenAI server in turn: serving_int8's burst of n_requests
    concurrent greedy max_tokens completions. Every request must finish
    with its tokens; K6 and K4 must launch, K2 and K5 not. The share of
    streams equal token for token to serving_int8's non-speculative
    streams is printed for information: verify projections at B * r
    rows round differently from one-row decode in bf16."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine

    old = int8_served.engine
    params, cfg, tokenizer = old.params, old.cfg, old.tokenizer
    base_streams = int8_served.app.streams
    n_pages = n_pages or old.pool.n_pages
    _release_engine(old)
    del old, int8_served
    gc.collect()
    torch.cuda.empty_cache()
    prompts = _int8_prompts(n_requests)
    recs = []
    for name, spec in configs:
        ecfg = {**(engine_cfg or INT8_DEPLOYMENT), **spec}
        engine = LLMEngine(params, cfg, tokenizer, ecfg, n_pages=n_pages,
                           device=device)
        # Greedy bursts only: the sampled fallback is not warmed.
        served = ServedEngine(engine=engine, warmup_buckets=[128, 512],
                              sampled=False)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            results = _burst(served.base, prompts, max_tokens)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            metrics = engine.metrics.snapshot()
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            streams = dict(served.app.streams)  # the counted burst's
            profile = None
            if spec.get("speculative_tree_branches"):
                # Outside the counted window: the same burst again under
                # the profiler, for the split of a verify step between
                # K4, K6, the other device work and the host.
                steps0 = engine.metrics.snapshot()["decode_steps"]
                profile = _profile_window(lambda: sum(
                    r["completion_tokens"] for r in _burst(
                        served.base, prompts, profile_tokens) if r))
                steps = engine.metrics.snapshot()["decode_steps"] - steps0
                window = profile["wall_ms"]
                profile["decode_steps"] = steps
                profile["per_step_ms"] = {
                    "wall": window / steps if steps else None,
                    **{k: ms / steps if steps else None
                       for k, ms in profile["port_kernels_ms"].items()},
                    "device_busy": (profile["device_busy_ms"] / steps
                                    if steps else None)}
                profile["shares"] = {
                    "paged_attention_int8": profile["port_kernels_ms"][
                        "paged_attention_int8"] / window,
                    "int8_matmul": profile["port_kernels_ms"][
                        "int8_matmul"] / window,
                    "other_device": (profile["device_busy_ms"] - sum(
                        profile["port_kernels_ms"].values())) / window,
                    "device_idle": profile["device_idle_share"]}
        finally:
            served.close()
        tokenize = tokenizer.encode
        equal, first = 0, None
        for p in prompts:
            ids = tuple(tokenize(p, add_bos=True))
            got = streams.get(ids, [])
            div = _first_divergence(got, base_streams.get(ids, []))
            if div is None:
                equal += 1
            elif first is None or div < first["token"]:
                first = {"prompt_chars": len(p), "token": div}
        tokens = sum(r["completion_tokens"] for r in results if r)
        finished = all(r is not None and (
            r["completion_tokens"] == max_tokens
            or r["finish_reason"] == "stop") for r in results)
        ok = (finished and launches["int8_matmul"] > 0
              and launches["paged_attention_int8"] > 0
              and launches["paged_attention"] == 0
              and launches["paged_attention_tree"] == 0)
        rec = {"phase": "spec_int8", "config": name, "card": card,
               "engine": ecfg, "layers": cfg.n_layers,
               "reduced": {"n_pages": n_pages},
               "engine_build_s": served.build_s, "warmup_s": served.warm_s,
               "requests": n_requests, "max_tokens": max_tokens,
               "completion_tokens": tokens,
               "finish_reasons": sorted({r["finish_reason"] for r in results
                                         if r}),
               "wall_s": wall, "tokens_per_s": tokens / wall if wall else None,
               "spec_tokens_per_step": metrics["spec_tokens_per_step"],
               "spec_committed": metrics["spec_committed"],
               "spec_slot_steps": metrics["spec_slot_steps"],
               "spec_fallback_steps": metrics["spec_fallback_steps"],
               "decode_steps": metrics["decode_steps"],
               "mean_batch_occupancy": metrics["mean_batch_occupancy"],
               "ttft_p50_ms": metrics["ttft_p50_ms"],
               "ttft_p95_ms": metrics["ttft_p95_ms"],
               "peak_mem_gb": peak_gb,
               "streams_equal_to_serving_int8": equal / len(prompts),
               "first_divergence": first,
               "launches": launches, "profile": profile, "ok": ok}
        emit(rec)
        recs.append(rec)
        _release_engine(engine)
        del engine, served
        gc.collect()
        torch.cuda.empty_cache()
    return recs


def phase_spec_bf16(card: str, bf16_served, device: str = "cuda",
                    n_requests: int = 8, max_tokens: int = 32,
                    spec=(3, 4)):
    """A tree engine (k = 3, M = 4, default batch 8) over the bf16 8B
    weights the serving phases used, behind the OpenAI server:
    n_requests concurrent max_tokens completions, the last of them
    sampled and sent once the greedy ones have run a verify step, so
    dispatches fall back to plain decode while it is live. Every request
    must finish with its tokens; K5 must launch, and K2 only through the
    fallback (at most fallback dispatches x decode_steps_per_dispatch x
    layers launches)."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine

    src = bf16_served.engine
    engine = LLMEngine(src.params, src.cfg, src.tokenizer,
                       {"speculative_k": spec[0],
                        "speculative_tree_branches": spec[1]},
                       device=device)
    # Every prompt fits the smallest bucket: only it is warmed.
    served = ServedEngine(engine=engine, warmup_buckets=[128])
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        results = [None] * n_requests

        def run(i, sampling):
            results[i] = _complete(served.base, f"Speculative request {i}:",
                                   max_tokens, **sampling)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i, {}))
                   for i in range(n_requests - 1)]
        for t in threads:
            t.start()
        while engine.metrics.spec_slot_steps == 0 and any(
                t.is_alive() for t in threads):
            time.sleep(0.005)
        threads.append(threading.Thread(target=run, args=(
            n_requests - 1, {"temperature": 0.7, "top_p": 0.9, "top_k": 40})))
        threads[-1].start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        metrics = engine.metrics.snapshot()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
    finally:
        served.close()
    _release_engine(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    tokens = sum(r["completion_tokens"] for r in results if r)
    finished = all(r is not None and (r["completion_tokens"] == max_tokens
                                      or r["finish_reason"] == "stop")
                   for r in results)
    k2_cap = (metrics["spec_fallback_steps"]
              * src.ecfg.decode_steps_per_dispatch * src.cfg.n_layers)
    ok = (finished and launches["paged_attention_tree"] > 0
          and launches["flash_attention"] > 0
          and metrics["spec_fallback_steps"] > 0
          and 0 < launches["paged_attention"] <= k2_cap
          and launches["paged_attention_int8"] == 0)
    rec = {"phase": "spec_bf16", "card": card,
           "engine": {"speculative_k": spec[0],
                      "speculative_tree_branches": spec[1],
                      "max_batch_size": src.ecfg.max_batch_size},
           "requests": n_requests, "sampled_requests": 1,
           "max_tokens": max_tokens, "completion_tokens": tokens,
           "finish_reasons": sorted({r["finish_reason"] for r in results
                                     if r}),
           "wall_s": wall, "tokens_per_s": tokens / wall if wall else None,
           "spec_tokens_per_step": metrics["spec_tokens_per_step"],
           "spec_committed": metrics["spec_committed"],
           "spec_slot_steps": metrics["spec_slot_steps"],
           "spec_fallback_steps": metrics["spec_fallback_steps"],
           "ttft_p50_ms": metrics["ttft_p50_ms"],
           "ttft_p95_ms": metrics["ttft_p95_ms"],
           "peak_mem_gb": peak_gb, "launches": launches,
           "k2_launch_cap": k2_cap, "ok": ok}
    emit(rec)
    return rec


# -- phase 11c: the prefix cache and the KV pager at 8B --------------------

# -- the warmed engine: its lattice replayed as CUDA graphs -----------------

# Both engines of a leg are warmed alike (the same lattice, so the same
# dispatch limits) and serve the same greedy requests, all submitted
# before the engine starts, so each admits them in the same prefill
# groups; max_tokens - 1 is a multiple of 8, and both warm every power
# of two up to K = 8, so both pick the same block lengths and the
# kernels' launches a token must be equal. Only the replay differs: the
# eager engine's graphs (decode, prefill and chunk) are dropped after its
# warmup. Every leg warms the chunked lane for one 4,096-token prompt (one
# chunk width, GRAPH_LONG_WARM), so each engine holds all three graph
# families.
GRAPH_KS = (1, 2, 4, 8)
GRAPH_SPEC_TREE = {"speculative_k": 3, "speculative_tree_branches": 4}
GRAPH_PROMPT_CHARS = (20, 100)
GRAPH_LONG_WARM = {"long_prompts": True, "long_prompt_lengths": [4096]}
# The kernels whose launches a token must be equal, replayed and eager.
GRAPH_KERNELS = ("flash_attention", "paged_attention", "paged_attention_int8",
                 "paged_attention_tree", "int8_matmul")


def _graph_prompts(tokenizer, n: int):
    """n prompts of 20-100 random letters (seed 5), as token ids."""
    import numpy as np

    rng = np.random.default_rng(5)
    return [tokenizer.encode("".join(chr(c) for c in rng.integers(97, 123, m)),
                             add_bos=True)
            for m in rng.integers(*GRAPH_PROMPT_CHARS, n)]


def _request_ids(req, timeout_s: float = 600) -> list:
    out = []
    while True:
        ev = req.stream.get(timeout=timeout_s)
        if ev["token_id"] >= 0:
            out.append(int(ev["token_id"]))
        if ev.get("finished"):
            return out


def _sampled_replay_check(engine, n_draws: int = 16) -> dict:
    """Replays of the warmed engine's sampled K = 1 graph, row 0 active
    (one token on page 1 of the fresh engine, temperature 1.0, top-k 40,
    top-p 0.9): every draw must lie inside the top-k / top-p mask of the
    same step's logits computed eagerly (the draws come from the engine's
    generator, registered with the graph), and the draws must not repeat
    one value (each replay draws fresh numbers)."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch.serving import engine_model
    from generativeaiexamples_tpu_torch.serving.sampling import (
        _mask_top_k, _mask_top_p)
    from generativeaiexamples_tpu_torch.serving.step_graphs import SAMPLED

    g = engine._graphs
    B, maxp = engine.ecfg.max_batch_size, engine.max_pages
    arrays = {"tables": np.zeros((B, maxp), np.int32),
              "lengths": np.ones(B, np.int32),
              "temps": np.zeros(B, np.float32),
              "top_ps": np.ones(B, np.float32),
              "top_ks": np.zeros(B, np.int32),
              "active_mask": np.zeros(B, bool)}
    arrays["tables"][0, 0] = 1
    arrays["temps"][0], arrays["top_ps"][0], arrays["top_ks"][0] = 1.0, 0.9, 40
    arrays["active_mask"][0] = True
    tok = 65
    dev = engine.device
    with torch.no_grad():
        toks = torch.full((B,), tok, dtype=torch.int32, device=dev)
        logits = engine_model._decode_once(
            engine.params, engine.cfg, engine.pool, toks,
            torch.from_numpy(arrays["tables"]).to(dev),
            torch.from_numpy(arrays["lengths"]).to(dev))[:1].float()
        masked = _mask_top_p(_mask_top_k(
            logits, torch.tensor([40], device=dev)),
            torch.tensor([0.9], device=dev))
        allowed = torch.isfinite(masked)[0]
    draws = []
    plan = engine_model.StepPlan(decode_k=1)
    for _ in range(n_draws):
        engine._last_tokens[0] = tok
        res = g.replay(plan, pool=engine.pool, last_tokens=engine._last_tokens,
                       arrays=arrays, sampling_flags=SAMPLED)
        draws.append(int(res["block"][0, 1]))
    engine._last_tokens[0] = 0
    inside = all(bool(allowed[d]) for d in draws)
    return {"draws": draws, "mask_size": int(allowed.sum()),
            "inside_mask": inside, "distinct": len(set(draws)),
            "ok": inside and len(set(draws)) > 1}


def _sink_prefill_record(engine, n: int, bucket: int, seed: int) -> dict:
    """A `prefill` record of n random prompts filling `bucket`, every row
    on sink page 0 with slot index len(slots), so it writes no slot and
    no page anything reads (greedy)."""
    import numpy as np

    from generativeaiexamples_tpu_torch.serving.step_graphs import GREEDY

    r = np.random.default_rng(seed)
    return {"tokens": r.integers(1, 250, (n, bucket)).astype(np.int32),
            "lengths": np.full((n,), bucket, np.int32),
            "rows": np.zeros((n, bucket // engine.pool.page_size), np.int32),
            "temps": np.zeros((n,), np.float32),
            "top_ps": np.ones((n,), np.float32),
            "top_ks": np.zeros((n,), np.int32),
            "idxs": np.full((n,), len(engine.slots), np.int32),
            "flags": np.asarray(GREEDY)}


def _prefill_copy_check(engine, n: int, bucket: int = 128) -> dict:
    """The first tokens' host copy of a replayed prefill group is queued
    on the replay's stream before any later replay of the same graph can
    overwrite its static output: two groups of the same (bucket, n)
    replayed back to back, each followed at once by its HostCopy as
    _prefill_group queues it, read only after both; each must equal the
    same group's first tokens run eagerly (graphs dropped for that)."""
    from generativeaiexamples_tpu_torch.serving.engine import HostCopy

    recs = [_sink_prefill_record(engine, n, bucket, seed) for seed in (1, 2)]
    copies = [HostCopy(engine._exec_prefill(rec)) for rec in recs]
    got = [c.numpy().tolist() for c in copies]
    graphs, engine._graphs = engine._graphs, None
    try:
        want = [engine._exec_prefill(rec).cpu().tolist() for rec in recs]
    finally:
        engine._graphs = graphs
    # Distinct groups, so a copy that read the second replay's output
    # would show.
    return {"group": n, "bucket": bucket, "replayed": got, "eager": want,
            "ok": got == want and want[0] != want[1]}


def _prefill_idle_probe(engine, n: int, bucket: int = 128,
                        reps: int = 1) -> dict:
    """The device's idle share inside prefill dispatches: groups of n
    prompts at `bucket` (sink rows) through the engine's own executor (a
    replay on a warmed engine with graphs, op by op without), each from
    an idle device. A dispatch's window runs from its host call to the
    end of its device work (host clock, `reps` dispatches unprofiled);
    its busy time is its device activities' time (torch.profiler over
    `reps` more, one stream; CUPTI slows the host's launches, not the
    kernels, so the window is not taken from those). The engine has
    served already, so its first-call costs are paid."""
    import numpy as np
    import torch

    rec = _sink_prefill_record(engine, n, bucket, 3)
    host_us, wall_ms = [], []

    def dispatch(log: bool):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._exec_prefill(rec)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if log:
            host_us.append((t1 - t0) * 1e6)
            wall_ms.append((time.perf_counter() - t0) * 1e3)

    for _ in range(reps):
        dispatch(True)
    rows = _shared().profile_device(
        lambda: [dispatch(False) for _ in range(reps)], engine.device)
    busy_ms = sum(ms for ms, _, _ in rows) / reps
    wall = float(np.median(wall_ms))
    return {"group": n, "bucket": bucket, "reps": reps,
            "host_us_p50": float(np.median(host_us)), "wall_ms_p50": wall,
            "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall if rows else None}


def _planner_lines(engine) -> dict:
    """The memory planner's activation_transients, long_prefill_scratch
    and headroom lines for the engine's config on this card (the plan an
    auto_pool_pages build would make), beside which the graph pools are
    printed."""
    from generativeaiexamples_tpu_torch.serving.memory_plan import (
        plan_rank_memory)

    try:
        plan = engine.memory_plan or plan_rank_memory(
            engine.model_cfg, engine.ecfg, None, engine.device)
    except Exception as e:  # a plan that cannot fit: printed, not fatal
        return {"error": f"{type(e).__name__}: {e}"}
    lines = {line.name: line.bytes_per_device for line in plan.lines}
    return {"activation_transients": lines.get("activation_transients"),
            "long_prefill_scratch": lines.get("long_prefill_scratch"),
            "headroom": plan.headroom_bytes}


def _leg_engine(params, cfg, tokenizer, ecfg, n_pages, device, warm_kw,
                mode: str):
    """A leg's engine warmed at warm_kw; the eager one has every graph
    dropped after its warmup. Returns (engine, warmup s, graph stats)."""
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine

    engine = LLMEngine(params, cfg, tokenizer, ecfg, n_pages=n_pages,
                       device=device)
    t0 = time.perf_counter()
    engine.warmup(**warm_kw)
    warm_s = time.perf_counter() - t0
    if mode == "eager":
        # Warmed alike, and every dispatch through the eager path.
        engine._graphs = None
    stats = engine._graphs.stats() if engine._graphs is not None else None
    return engine, warm_s, stats


def _timed_prefill(engine, host_us: list) -> None:
    """Time each prefill dispatch's host call (the replay: input copy and
    graph launch; or the eager launches), as timed_plan times a block's."""
    real = engine._exec_prefill

    def timed(rec):
        t = time.perf_counter()
        out = real(rec)
        host_us.append((time.perf_counter() - t) * 1e6)
        return out

    engine._exec_prefill = timed


def _free_engine(engine) -> None:
    import torch

    engine.stop()
    _release_engine(engine)
    gc.collect()
    torch.cuda.empty_cache()


def _leg_checks(g: dict, e: dict) -> dict:
    """What both sides of a leg must show: launches a token equal for
    K1, K2, K4, K5 and K6; the replayed engine's prefill and chunk graphs
    captured and no eager prefill or chunk dispatch; the eager one's
    graphs gone."""
    fam = (g["graphs"] or {}).get("by_family", {})
    return {
        "launches_equal": all(g["launches"][k] == e["launches"][k]
                              for k in GRAPH_KERNELS),
        "families_captured": all(fam.get(f, {}).get("graphs", 0) > 0
                                 for f in ("decode", "prefill", "chunk")),
        "no_eager_prefill_or_chunk": (g["eager_prefill_dispatches"] == 0
                                      and g["eager_chunk_dispatches"] == 0),
        "eager_side_eager": e["graphs"] is None}


def _digest(run: dict) -> None:
    """Streams printed as a digest and the first request's ids."""
    streams = run.pop("streams")
    run["streams_sha256"] = hashlib.sha256(
        json.dumps(streams).encode()).hexdigest()
    run["first_stream"] = streams[0]


def _graph_leg(card: str, name: str, params, cfg, tokenizer, ecfg: dict,
               n_pages: int, n_requests: int, max_tokens: int,
               warm_kw: dict, device: str = "cuda",
               sampled_check: bool = False) -> dict:
    """One deployment served twice over the same weights, by two engines
    warmed alike (`warm_kw`), one after the other, each fed the same
    greedy requests: the first replays its lattice as CUDA graphs
    (decode blocks, prefill groups; chunks where a prompt is chunked),
    the second has every graph dropped after warmup, so every dispatch
    runs eagerly under the same dispatch limits. Streams must be
    byte-identical and K1's, K2's, K4's, K5's and K6's launches a token
    equal; each stream runs to max_tokens or ends at EOS. Each side
    prints TTFT p50/p95, the host time of its prefill dispatches and its
    decode blocks, the device's idle share inside prefill dispatches (a
    profiled probe after the run) and its graph pools by family beside
    the planner's lines; the replayed side also checks a prefill group's
    first-token copy against a second replay."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving import engine_model
    from generativeaiexamples_tpu_torch.serving.engine import GenRequest
    from generativeaiexamples_tpu_torch.serving.openai_server import (
        OpenAIServer)

    prompts = _graph_prompts(tokenizer, n_requests)
    real = engine_model.plan_step
    host_us, prefill_us = [], []

    def timed_plan(params, cfg, plan, **kw):
        # Host time of each decode block's plan_step call: the replay
        # (input copy, graph launch) or the eager launches.
        t = time.perf_counter()
        out = real(params, cfg, plan, **kw)
        if plan.decode_k:
            host_us.append((time.perf_counter() - t) * 1e6)
        return out

    group = min(n_requests, _prefill_group_size(ecfg))
    runs = {}
    planner = None
    for mode in ("graphs", "eager"):
        engine, warm_s, stats = _leg_engine(params, cfg, tokenizer, ecfg,
                                            n_pages, device, warm_kw, mode)
        try:
            time_mark(f"graphs_{name}_{mode}_warm")
            planner = planner or _planner_lines(engine)
            sampled = (_sampled_replay_check(engine)
                       if mode == "graphs" and sampled_check else None)
            torch.cuda.synchronize()
            kernels.reset_launches()
            host_us.clear()
            prefill_us.clear()
            _timed_prefill(engine, prefill_us)
            reqs = [engine.submit(GenRequest(prompt_ids=list(ids),
                                             max_new_tokens=max_tokens))
                    for ids in prompts]
            got: dict = {}
            threads = [threading.Thread(target=_timed_request, args=(r, got),
                                        daemon=True) for r in reqs]
            for t in threads:
                t.start()
            engine_model.plan_step = timed_plan
            try:
                t1 = time.perf_counter()
                engine.start()
                for t in threads:
                    t.join(timeout=900)
                wall = time.perf_counter() - t1
            finally:
                engine_model.plan_step = real
            torch.cuda.synchronize()
            timed = [got.get(id(r), []) for r in reqs]
            streams = [[tok for _, tok in s] for s in timed]
            ttfts = [(s[0][0] - r.submit_time) * 1e3
                     for s, r in zip(timed, reqs) if s]
            launches = dict(kernels.LAUNCHES)
            metrics = engine.metrics.snapshot()
            if engine._graphs is not None:
                stats = engine._graphs.stats()  # with the run's replays
            flight = _flight_report(OpenAIServer(engine).timeline()[1],
                                    f"graphs_{name}_{mode}")
            engine.stop()
            del engine._exec_prefill  # the timing wrapper
            probe = _prefill_idle_probe(engine, group)
            copy = (_prefill_copy_check(engine, min(group, 8))
                    if mode == "graphs" else None)
        finally:
            _free_engine(engine)
            del engine
        tokens = sum(len(s) for s in streams)
        runs[mode] = {
            "warmup_s": warm_s, "graphs": stats, "sampled_replay": sampled,
            "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall if wall else None,
            "ttft_p50_ms": float(np.percentile(ttfts, 50)),
            "ttft_p95_ms": float(np.percentile(ttfts, 95)),
            "ttft_hist_p50_ms": metrics["ttft_p50_ms"],
            "ttft_hist_p95_ms": metrics["ttft_p95_ms"],
            "plan_variants_compiled": metrics["plan_variants_compiled"],
            "eager_prefill_dispatches": metrics["eager_prefill_dispatches"],
            "eager_chunk_dispatches": metrics["eager_chunk_dispatches"],
            "decode_steps": metrics["decode_steps"],
            "blocks": len(host_us),
            "block_host_us_p50": (float(np.median(host_us)) if host_us
                                  else None),
            "block_host_us_max": max(host_us) if host_us else None,
            "prefills": len(prefill_us),
            "prefill_host_us_p50": (float(np.median(prefill_us))
                                    if prefill_us else None),
            "prefill_probe": probe, "prefill_copy_check": copy,
            "launches": launches,
            "launches_per_token": {k: n / tokens for k, n in launches.items()
                                   if n} if tokens else {},
            "device_busy_pct": flight.get("device_busy_pct"),
            "idle_share": (1.0 - flight["device_busy_pct"] / 100.0
                           if "device_busy_pct" in flight else None),
            "flight_ok": flight["ok"], "streams": streams}
        time_mark(f"graphs_{name}_{mode}")
    g, e = runs["graphs"], runs["eager"]
    equal_streams = g["streams"] == e["streams"]
    first = None
    if not equal_streams:
        first = next(({"request": i, "token": _first_divergence(a, b)}
                      for i, (a, b) in enumerate(zip(g["streams"],
                                                     e["streams"]))
                      if a != b), None)
    checks = _leg_checks(g, e)
    eos = {tokenizer.eos_id} | set(getattr(tokenizer, "eos_ids", None) or ())
    whole = all(len(s) == max_tokens or (s and s[-1] in eos)
                for s in g["streams"])
    for run in runs.values():
        _digest(run)
    ok = (equal_streams and all(checks.values()) and whole
          and g["graphs"]["pool_bytes"] > 0
          and g["flight_ok"] and e["flight_ok"]
          and g["prefill_copy_check"]["ok"]
          and any(g["launches"][k] for k in GRAPH_KERNELS[1:])
          and (g["sampled_replay"] is None or g["sampled_replay"]["ok"]))
    rec = {"phase": "graphs", "deployment": name, "card": card,
           "engine": ecfg, "layers": cfg.n_layers, "requests": n_requests,
           "max_tokens": max_tokens, "warmup": warm_kw,
           "reduced": {"n_pages": n_pages}, "planner": planner,
           "streams_equal": equal_streams, "first_divergence": first,
           **checks, "runs": runs, "ok": ok}
    emit(rec)
    return rec


def _prefill_group_size(ecfg: dict) -> int:
    """The largest prefill group an engine of `ecfg` forms: its
    max_prefill_group (0: max_batch_size), rounded up to a power of two
    as _prefill_group pads it, at most max_batch_size's."""
    from generativeaiexamples_tpu_torch.config.schema import EngineConfig

    e = EngineConfig.coerce(ecfg)
    cap = e.max_prefill_group if e.max_prefill_group > 0 else e.max_batch_size
    n = min(cap, e.max_batch_size)
    return 1 << (max(n, 1) - 1).bit_length()


# The long-prompt leg (int8 deployment): a 6,000-token prompt rides three
# greedy streams, then a request sharing its first 46 pages (5,888
# tokens) with 200 new tokens hits the prefix cache. All are submitted
# before the engine starts: the hit waits for the one chunked lane, so
# both engines admit it on the same beat.
GRAPH_LONG = {"prompt": 6000, "hit_shared": 5888, "hit_new": 200,
              "shorts": 3, "short_tokens": 49, "long_tokens": 9,
              "n_pages": 160}


def _timed_request(req, out: dict, timeout_s: float = 600) -> None:
    """Collect one request's (arrival s, token id) pairs into out[id]."""
    got = []
    while True:
        ev = req.stream.get(timeout=timeout_s)
        if ev["token_id"] >= 0:
            got.append((time.perf_counter(), int(ev["token_id"])))
        if ev.get("finished"):
            out[id(req)] = got
            return


def _graph_long_leg(card: str, params, cfg, tokenizer, device: str = "cuda",
                    engine_cfg=None, spec=None) -> dict:
    """The int8 deployment (docs/deployment.md:62, batch 128) with the
    prefix cache and the 512-token rider, warmed with long_prompts (and
    at K in GRAPH_KS, bucket 128), served twice as _graph_leg serves it:
    replayed, and with every graph dropped. Traffic (GRAPH_LONG): three
    greedy streams, a 6,000-token prompt whose chunks ride their decode
    blocks, and a prefix hit on that prompt's first 46 pages. The
    streams must be byte-identical, K1's, K4's and K6's launches a token
    equal, the rider must ride and the hit hit on both sides, and the
    replayed side must dispatch no eager prefill or chunk. Prints TTFT
    p50/p95, the long prompt's TTFT, the hit's TTFT from its admission,
    the short streams' worst gap while the long prompt prefills, the
    prefill host p50, the idle share inside prefill dispatches and the
    graph pools by family beside the planner's lines."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving.engine import GenRequest

    spec = {**GRAPH_LONG, **(spec or {})}
    ecfg = {**(engine_cfg or INT8_DEPLOYMENT), "prefix_cache": True,
            **dict(FUSED_RUNS)["B_rider"], **UNPACED}
    # The chunked lane warmed for the two long prompts' lengths (one
    # scratch length, 8,192: chunks of 4,096 and 2,048, the 512-wide
    # rider), as the JAX warmup's long_prompt_lengths restricts it.
    # Prefill groups up to 4: the three streams' group and the probe's.
    warm_kw = {"buckets": [128], "group_sizes": [1, 2, 4], "ks": GRAPH_KS,
               "sampled": False, "long_prompts": True, "long_prompt_lengths": [
                   spec["prompt"], spec["hit_shared"] + spec["hit_new"]]}
    prompt, shorts = _fused_traffic(13, spec["prompt"], spec["shorts"])
    g = np.random.default_rng(14)
    hit = prompt[:spec["hit_shared"]] + g.integers(
        0, 256, spec["hit_new"]).tolist()
    runs = {}
    planner = None
    for mode in ("graphs", "eager"):
        engine, warm_s, stats = _leg_engine(
            params, cfg, tokenizer, ecfg, spec["n_pages"], device, warm_kw,
            mode)
        try:
            time_mark(f"graphs_long_{mode}_warm")
            planner = planner or _planner_lines(engine)
            torch.cuda.synchronize()
            kernels.reset_launches()
            prefill_us = []
            _timed_prefill(engine, prefill_us)
            admitted = {}
            real_begin = engine._begin_prefix_prefill

            def begin(req, *a, _real=real_begin, _admitted=admitted):
                _admitted[id(req)] = time.perf_counter()
                return _real(req, *a)

            engine._begin_prefix_prefill = begin
            reqs = [engine.submit(GenRequest(prompt_ids=list(p),
                                             max_new_tokens=spec[
                                                 "short_tokens"]))
                    for p in shorts]
            reqs += [engine.submit(GenRequest(prompt_ids=list(p),
                                              max_new_tokens=spec[
                                                  "long_tokens"]))
                     for p in (prompt, hit)]
            got: dict = {}
            threads = [threading.Thread(target=_timed_request, args=(r, got),
                                        daemon=True) for r in reqs]
            for t in threads:
                t.start()
            t1 = time.perf_counter()
            engine.start()
            for t in threads:
                t.join(timeout=900)
            wall = time.perf_counter() - t1
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            metrics = engine.metrics.snapshot()
            if engine._graphs is not None:
                stats = engine._graphs.stats()  # with the run's replays
            engine.stop()
            del engine._exec_prefill, engine._begin_prefix_prefill
            probe = _prefill_idle_probe(engine, _prefill_group_size(
                {**ecfg, "max_batch_size": spec["shorts"]}))
        finally:
            _free_engine(engine)
            del engine
        timed = [got.get(id(r), []) for r in reqs]
        streams = [[tok for _, tok in s] for s in timed]
        long_first = timed[-2][0][0] if timed[-2] else None
        gaps = [b[0] - a[0] for s in timed[:-2] for a, b in zip(s, s[1:])
                if long_first is not None and b[0] <= long_first]
        tokens = sum(len(s) for s in streams)
        hit_admit = admitted.get(id(reqs[-1]))
        ttfts = [(s[0][0] - r.submit_time) * 1e3
                 for s, r in zip(timed, reqs) if s]
        runs[mode] = {
            "warmup_s": warm_s, "graphs": stats, "tokens": tokens,
            "wall_s": wall,
            "ttft_p50_ms": float(np.percentile(ttfts, 50)),
            "ttft_p95_ms": float(np.percentile(ttfts, 95)),
            "ttft_hist_p50_ms": metrics["ttft_p50_ms"],
            "ttft_hist_p95_ms": metrics["ttft_p95_ms"],
            "long_ttft_ms": ((long_first - t1) * 1e3 if long_first
                             else None),
            "hit_ttft_from_admit_ms": (
                (timed[-1][0][0] - hit_admit) * 1e3
                if hit_admit and timed[-1] else None),
            "rider_worst_gap_ms": max(gaps) * 1e3 if gaps else None,
            "rider_gap_p50_ms": (float(np.median(gaps)) * 1e3 if gaps
                                 else None),
            "prefix_hits": metrics["prefix_hits"],
            "prefix_hit_tokens": metrics["prefix_hit_tokens"],
            "fused_steps": metrics["fused_steps"],
            "fused_prefill_tokens": metrics["fused_prefill_tokens"],
            "eager_prefill_dispatches": metrics["eager_prefill_dispatches"],
            "eager_chunk_dispatches": metrics["eager_chunk_dispatches"],
            "prefills": len(prefill_us),
            "prefill_host_us_p50": (float(np.median(prefill_us))
                                    if prefill_us else None),
            "prefill_probe": probe, "launches": launches,
            "launches_per_token": {k: n / tokens for k, n in launches.items()
                                   if n} if tokens else {},
            "streams": streams}
        time_mark(f"graphs_long_{mode}")
    g, e = runs["graphs"], runs["eager"]
    equal_streams = g["streams"] == e["streams"]
    checks = _leg_checks(g, e)
    eos = {tokenizer.eos_id} | set(getattr(tokenizer, "eos_ids", None) or ())
    want = [spec["short_tokens"]] * spec["shorts"] + [spec["long_tokens"]] * 2
    lengths_ok = all(len(s) == n or (s and s[-1] in eos)
                     for s, n in zip(g["streams"], want))
    for run in runs.values():
        _digest(run)
    ok = (equal_streams and all(checks.values()) and lengths_ok
          and all(r["prefix_hits"] == 1 and r["fused_steps"] > 0
                  and r["prefix_hit_tokens"] == spec["hit_shared"]
                  for r in runs.values())
          and g["launches"]["flash_attention"] > 0
          and g["launches"]["int8_matmul"] > 0)
    rec = {"phase": "graphs", "deployment": "int8_long", "card": card,
           "engine": ecfg, "layers": cfg.n_layers, "traffic": spec,
           "warmup": warm_kw, "reduced": {"n_pages": spec["n_pages"]},
           "planner": planner, "streams_equal": equal_streams,
           "stream_lengths_ok": lengths_ok, **checks, "runs": runs,
           "ok": ok}
    emit(rec)
    return rec


def phase_graphs_bf16(card: str, bf16_served, device: str = "cuda",
                      n_requests: int = 8, max_tokens: int = 129,
                      n_pages: int = 97) -> dict:
    """The default bf16 engine at B = 8 over the served engine's weights,
    warmed with the sampled variants too (as serving/__main__.py warms)
    and one sampled replay checked against its mask."""
    eng = bf16_served.engine
    return _graph_leg(card, "bf16_b8", eng.params, eng.cfg, eng.tokenizer,
                      {}, n_pages, n_requests, max_tokens,
                      {"buckets": [128], "ks": GRAPH_KS, "sampled": True,
                       **GRAPH_LONG_WARM}, device, sampled_check=True)


# The hits leg (bf16 default engine with the prefix cache, warmed as the
# default server warms): chunks at the JAX engine's widths past the
# scratch's end, and a cold scratch length captured on first sight. The
# prompts run one after another (each submitted once the one before it
# has its first token, so a hit finds its pages in the tree) beside three
# greedy streams: a 1,000-token prompt, then one sharing its first 640
# tokens plus 360 new (a 512-wide chunk from 640 of a 1,024-row scratch);
# a 1,024-token prompt, then its exact repeat (capped at 1,023 cached: a
# 128-wide chunk from 1,023); a 6,000-token prompt (scratch 8,192, cold:
# first sight), a second one with no shared prefix (second sight), then
# a hit on the first one's 46 pages plus 200 new (a 4,096-wide chunk
# from 5,888 of the 8,192 rows).
GRAPH_HITS = {"bucketed": 1000, "bucketed_shared": 640, "repeat": 1024,
              "long": 6000, "long_shared": 5888, "long_new": 200,
              "shorts": 3, "short_tokens": 320, "tokens": 6, "n_pages": 257,
              "warm_buckets": [128, 512, 1024]}


def _hits_traffic(spec: dict):
    """The hits leg's prompts in submission order, as (name, ids, is a
    hit), random bytes from seeds 21-24."""
    import numpy as np

    def ids(seed, n):
        return np.random.default_rng(seed).integers(0, 256, n).tolist()

    b = ids(21, spec["bucketed"])
    b_hit = b[:spec["bucketed_shared"]] + ids(
        22, spec["bucketed"] - spec["bucketed_shared"])
    r = ids(23, spec["repeat"])
    first, second = ids(24, spec["long"]), ids(25, spec["long"])
    l_hit = first[:spec["long_shared"]] + ids(26, spec["long_new"])
    return [("bucketed", b, False), ("bucketed_hit", b_hit, True),
            ("repeat_first", r, False), ("repeat", list(r), True),
            ("long_first_sight", first, False),
            ("long_second_sight", second, False), ("long_hit", l_hit, True)]


def _collect_request(req, out: list, first) -> None:
    """Collect one request's (arrival s, token id) pairs into `out`,
    setting `first` at its first token (or its end)."""
    while True:
        ev = req.stream.get(timeout=600)
        if ev["token_id"] >= 0:
            out.append((time.perf_counter(), int(ev["token_id"])))
            first.set()
        if ev.get("finished"):
            first.set()
            return


def phase_graphs_hits(card: str, bf16_served, device: str = "cuda",
                      spec=None, engine_cfg=None) -> dict:
    """The default bf16 engine (page 128, batch 8) with the prefix cache
    over the served engine's weights, warmed as the default server warms
    (sampled, no long prompts; at the buckets the traffic uses), served
    twice as _graph_leg serves it: replayed, and with every graph dropped.
    Traffic (GRAPH_HITS): three greedy streams, then seven prompts one
    after another, three of them hits whose chunks pass the scratch's end
    at the JAX engine's widths, and a 6,000-token prompt at a scratch
    length the warmup did not capture. Streams must be byte-identical,
    K1's, K2's and K6's launches a token equal (net of the live captures'
    eager runs over sink inputs), every hit must hit on both sides; the replayed side must dispatch no eager prefill or chunk and
    capture the cold length's chunk, seed and commit at the first long
    prompt's admission and nothing after. Prints each hit's TTFT from its
    admission, the streams' worst gap while each hit's chunk runs, the
    long prompt's TTFT at first and second sight, the live captures'
    seconds and the chunk pool's bytes after each, beside the planner's
    lines."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving.__main__ import (
        serving_warmup_kw)
    from generativeaiexamples_tpu_torch.serving.engine import GenRequest
    from generativeaiexamples_tpu_torch.serving.step_graphs import (
        first_sight_keys)

    spec = {**GRAPH_HITS, **(spec or {})}
    eng0 = bf16_served.engine
    params, cfg, tokenizer = eng0.params, eng0.cfg, eng0.tokenizer
    ecfg = {**(engine_cfg or {}), "prefix_cache": True, **UNPACED}
    warm_kw = {**serving_warmup_kw(), "long_prompts": False,
               "buckets": spec["warm_buckets"]}
    traffic = _hits_traffic(spec)
    shorts = _graph_prompts(tokenizer, spec["shorts"])
    runs = {}
    planner = None
    keys = None
    for mode in ("graphs", "eager"):
        engine, warm_s, stats = _leg_engine(params, cfg, tokenizer, ecfg,
                                            spec["n_pages"], device, warm_kw,
                                            mode)
        chunk = engine.buckets[-1]
        s_long = -(-spec["long"] // chunk) * chunk
        keys = first_sight_keys(s_long, chunk, True)
        graphs = engine._graphs
        warmed_cold = graphs is not None and any(
            k in graphs.graphs for k in keys)
        try:
            time_mark(f"graphs_hits_{mode}_warm")
            planner = planner or _planner_lines(engine)
            torch.cuda.synchronize()
            kernels.reset_launches()
            prefill_us = []
            _timed_prefill(engine, prefill_us)
            admitted, live_after = {}, []
            for name in ("_begin_long_prefill", "_begin_prefix_prefill"):
                def begin(req, *a, _fn=getattr(engine, name)):
                    admitted[id(req)] = time.perf_counter()
                    out = _fn(req, *a)
                    g = engine._graphs
                    live_after.append(len(g.live) if g is not None else 0)
                    return out

                setattr(engine, name, begin)
            got: dict = {}
            threads = []

            def submit(ids, n):
                req = engine.submit(GenRequest(prompt_ids=list(ids),
                                               max_new_tokens=n))
                got[id(req)] = []
                first = threading.Event()
                t = threading.Thread(target=_collect_request,
                                     args=(req, got[id(req)], first),
                                     daemon=True)
                t.start()
                threads.append(t)
                return req, first

            short_reqs = [submit(p, spec["short_tokens"])[0] for p in shorts]
            t1 = time.perf_counter()
            engine.start()
            reqs = []
            for _, ids, _ in traffic:
                req, first = submit(ids, spec["tokens"])
                reqs.append(req)
                first.wait(timeout=600)
            for t in threads:
                t.join(timeout=900)
            wall = time.perf_counter() - t1
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            metrics = engine.metrics.snapshot()
            if engine._graphs is not None:
                stats = engine._graphs.stats()  # with the run's replays
            engine.stop()
        finally:
            _free_engine(engine)
            del engine
        timed = [got[id(r)] for r in short_reqs + reqs]
        streams = [[tok for _, tok in t] for t in timed]
        tokens = sum(len(t) for t in streams)
        short_timed = timed[:spec["shorts"]]
        per = {}
        for (name, _, hit), req, t in zip(traffic, reqs,
                                          timed[spec["shorts"]:]):
            first_t = t[0][0] if t else None
            start = admitted.get(id(req)) if hit else req.submit_time
            # The streams' gaps that overlap this prompt's wait for its
            # first token (its chunks' time for a hit).
            gaps = [b[0] - a[0] for s in short_timed
                    for a, b in zip(s, s[1:])
                    if first_t is not None and b[0] >= req.submit_time
                    and a[0] <= first_t]
            per[name] = {
                "ttft_ms": ((first_t - req.submit_time) * 1e3
                            if first_t else None),
                "ttft_from_admit_ms": ((first_t - start) * 1e3
                                       if hit and first_t and start
                                       else None),
                "streams_worst_gap_ms": max(gaps) * 1e3 if gaps else None,
                "streams_live": bool(gaps)}
        hit_gaps = [per[n]["streams_worst_gap_ms"] for n, _, h in traffic
                    if h and per[n]["streams_worst_gap_ms"] is not None]
        runs[mode] = {
            "warmup_s": warm_s, "graphs": stats, "tokens": tokens,
            "wall_s": wall, "prompts": per,
            "hits_streams_worst_gap_ms": max(hit_gaps) if hit_gaps else None,
            "live_after_admissions": live_after,
            "warmup_held_cold_points": warmed_cold,
            "prefix_hits": metrics["prefix_hits"],
            "prefix_hit_tokens": metrics["prefix_hit_tokens"],
            "eager_prefill_dispatches": metrics["eager_prefill_dispatches"],
            "eager_chunk_dispatches": metrics["eager_chunk_dispatches"],
            "prefills": len(prefill_us),
            "prefill_host_us_p50": (float(np.median(prefill_us))
                                    if prefill_us else None),
            "launches": launches,
            "launches_per_token": {k: n / tokens for k, n in launches.items()
                                   if n} if tokens else {},
            "streams": streams}
        time_mark(f"graphs_hits_{mode}")
    g, e = runs["graphs"], runs["eager"]
    equal_streams = g["streams"] == e["streams"]
    gstats = g["graphs"] or {}
    fam = gstats.get("by_family", {}).get("chunk", {})
    # The three long-lane admissions (first sight, second sight, the long
    # hit) each see the cold length's points captured, at the first one.
    n = len(keys)
    # The live captures' eager runs over sink inputs launch for real on
    # the replayed side and serve no token: held apart.
    warm = {k: sum(r["warm_launches"].get(k, 0)
                   for r in (g["graphs"] or {}).get("live", []))
            for k in GRAPH_KERNELS}
    g["live_warm_launches"] = warm
    checks = {
        "launches_equal": all(g["launches"][k] - warm[k] == e["launches"][k]
                              for k in GRAPH_KERNELS),
        "no_eager_prefill_or_chunk": (g["eager_prefill_dispatches"] == 0
                                      and g["eager_chunk_dispatches"] == 0),
        "eager_side_eager": e["graphs"] is None,
        "cold_length_not_warmed": not g["warmup_held_cold_points"],
        "first_sight_at_admission": g["live_after_admissions"] == [
            0, 0, n, n, n],
        "live_graphs_counted": (fam.get("live_graphs") == n
                                and fam.get("live_refused") == 0
                                and [tuple(r["key"]) for r in gstats.get(
                                    "live", [])] == list(keys)),
        "hits_hit": all(
            r["prefix_hits"] == 3 and r["prefix_hit_tokens"] == (
                spec["bucketed_shared"] + spec["repeat"] - 1
                + spec["long_shared"]) for r in runs.values()),
        "streams_live_through_hits": all(
            g["prompts"][name]["streams_live"]
            for name, _, hit in traffic if hit)}
    eos = {tokenizer.eos_id} | set(getattr(tokenizer, "eos_ids", None) or ())
    want = [spec["short_tokens"]] * spec["shorts"] + [spec["tokens"]] * len(
        traffic)
    lengths_ok = all(len(s) == n_tok or (s and s[-1] in eos)
                     for s, n_tok in zip(g["streams"], want))
    for run in runs.values():
        _digest(run)
    ok = (equal_streams and all(checks.values()) and lengths_ok
          and g["launches"]["flash_attention"] > 0
          and g["launches"]["paged_attention"] > 0)
    rec = {"phase": "graphs", "deployment": "bf16_hits", "card": card,
           "engine": ecfg, "layers": cfg.n_layers, "traffic": {
               k: v for k, v in spec.items() if k != "warm_buckets"},
           "warmup": warm_kw, "first_sight_keys": [list(k) for k in keys],
           "reduced": {"n_pages": spec["n_pages"],
                       "warm_buckets": spec["warm_buckets"],
                       "default_buckets": list(eng0.buckets)},
           "planner": planner, "streams_equal": equal_streams,
           "stream_lengths_ok": lengths_ok, **checks, "runs": runs,
           "ok": ok}
    emit(rec)
    return rec


def phase_graphs_int8(card: str, params, cfg, tokenizer,
                      device: str = "cuda", n_requests: int = 128,
                      max_tokens: int = 65, tree_tokens: int = 33,
                      n_pages: int = 577, engine_cfg=None,
                      long_spec=None) -> list:
    """The int8 deployment (docs/deployment.md:62) at B = 128, then its
    speculative tree form (k = 3, M = 4), over the int8 weights; then the
    long-prompt leg on the same deployment."""
    base = dict(engine_cfg or INT8_DEPLOYMENT)
    legs = [_graph_leg(card, name, params, cfg, tokenizer,
                       {**base, **spec}, n_pages, n_requests, n_tokens,
                       {"buckets": [128], "ks": GRAPH_KS, "sampled": False,
                        **GRAPH_LONG_WARM}, device)
            for name, spec, n_tokens in (
                ("int8_b128", {}, max_tokens),
                ("spec_int8_tree", GRAPH_SPEC_TREE, tree_tokens))]
    return legs + [_graph_long_leg(card, params, cfg, tokenizer, device,
                                   base, long_spec)]


def graphs_only(card: str) -> dict:
    """The graphs phase alone (`chip_smoke.py --graphs`): the kernels
    built, the random 8B bf16 engine (seed 0, as the served engine) for
    its two legs (B = 8, the hits), then the int8 deployment's weights (seed 0, quantized, as
    serving_int8's) for the int8, tree and long-prompt legs, each freed
    before the next."""
    import types

    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving.__main__ import build_engine

    t0 = time.perf_counter()
    kernels.build()
    out = {"build_s": time.perf_counter() - t0}
    eng = build_engine("8b", "cuda", seed=0, warmup=False, n_pages=97)
    bf16 = phase_graphs_bf16(card, types.SimpleNamespace(engine=eng))
    hits = phase_graphs_hits(card, types.SimpleNamespace(engine=eng))
    _release_engine(eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng = build_engine("8b", "cuda", seed=0, warmup=False,
                       engine_cfg=INT8_DEPLOYMENT, n_pages=65)
    legs = [bf16, hits] + phase_graphs_int8(card, eng.params, eng.cfg,
                                            eng.tokenizer)
    out.update(seconds=time.perf_counter() - t0,
               ok={r["deployment"]: r["ok"] for r in legs})
    return out


PREFIX_ENGINE = {"prefix_cache": True, "kv_pager": True,
                 "prefix_cache_capacity": 0.25, "kv_host_budget_mb": 512}
PREFIX_POOL_PAGES = 257


# Scheduler methods whose host time splits a request's TTFT.
TIMELINE_METHODS = ("_admit_waiting", "_lookup_prefix",
                    "_begin_prefix_prefill", "_dispatch_chunk",
                    "_finish_long_prefill", "_prefill_group",
                    "_dispatch_decode", "_land_next_block")


def _ttft_timeline(engine, run):
    """Host time of the scheduler's methods between the submit of
    `run()`'s one request and its first token: each of TIMELINE_METHODS
    (and `submit`) is wrapped on `engine` for the call (the engine must
    be idle), and per method the calls and milliseconds that started in
    that span are summed. Returns (ttft_ms, {method: [calls, ms]})."""
    log, submits = [], []
    engine.submit = lambda req, _fn=engine.submit: (
        submits.append(req.submit_time), _fn(req))[1]
    for name in TIMELINE_METHODS:
        fn = getattr(engine, name)

        def timed(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                log.append((_name, t0, time.perf_counter()))

        setattr(engine, name, timed)
    try:
        run()
    finally:
        for name in TIMELINE_METHODS + ("submit",):
            delattr(engine, name)
    ttft = engine.metrics.last_ttft_ms
    out = {}
    for name, a, b in log:
        if 0 <= (a - submits[0]) * 1e3 < ttft:
            calls, ms = out.get(name, (0, 0.0))
            out[name] = [calls + 1, ms + (b - a) * 1e3]
    return ttft, out


def _timeline_rec(engine, base, prompt, max_tokens):
    ttft, host = _ttft_timeline(
        engine, lambda: _complete(base, prompt, max_tokens))
    return {"ttft_ms": ttft, "host_ms": host}


def _metric_delta(engine, before, keys):
    after = engine.metrics.snapshot()
    return after, {k: after[k] - before[k] for k in keys}


def phase_prefix(card: str, bf16_served, device: str = "cuda",
                 prefix_len: int = 1536, question_len: int = 40,
                 n_questions: int = 4, session_len: int = 1024,
                 n_sessions: int = 12, n_resume: int = 3,
                 max_tokens: int = 8, n_pages: int = PREFIX_POOL_PAGES,
                 engine_cfg=None, warmup_buckets=(128, 1024, 2048)):
    """An engine with the prefix cache and the KV pager (PREFIX_ENGINE,
    batch 8, page 128, n_pages pool pages) over the bf16 8B weights the
    serving phases used, behind the OpenAI server; raw token-id prompts
    through /v1/completions (no chat template shifts the pages), greedy.

    Shared prefix (the RAG shape): one prefix_len-token prefix (system
    prompt and retrieved context) and n_questions distinct
    question_len-token questions, one after another: the first misses,
    each later one must raise prefix_hit_tokens by page_size x the
    prefix's full pages and prefill_tokens by its suffix only (K1's
    q_offset form). TTFT cold against the hits' p50. Then the same
    prompts at once: hits against lane demotions (the scratch lane is one
    wide, as in the JAX engine).

    Sessions (the pager): n_sessions distinct session_len-token prompts,
    each run twice while resident (the second run, h1, is a hit capped at
    plen - 1: a CoW tail and an unaligned q_offset); the later sessions
    push the first past the cache's capacity into host RAM and the spill
    file. The first n_resume sessions' pages are copied (pool_to_pages)
    right after their h1; resuming them (h2) must promote pages equal to
    that copy bit for bit and give h1's tokens. kv_demotions,
    kv_promotions and kv_spill_writes must be > 0. K1 and K2 must launch
    in both parts."""
    import tempfile

    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving import engine_model
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine

    t_phase = time.perf_counter()
    src = bf16_served.engine
    spill = tempfile.TemporaryDirectory(prefix="kv_spill_")
    ecfg = {**PREFIX_ENGINE, "kv_spill_dir": spill.name,
            **(engine_cfg or {})}
    engine = LLMEngine(src.params, src.cfg, src.tokenizer, ecfg,
                       n_pages=n_pages, device=device)
    served = ServedEngine(engine=engine, warmup_buckets=list(warmup_buckets))
    ps = engine.pool.page_size
    keys = ("prefix_hits", "prefix_miss", "prefix_hit_tokens",
            "prefill_tokens", "kv_demotions", "kv_promotions",
            "kv_spill_writes", "kv_promote_ms")
    g = torch.Generator().manual_seed(11)

    def ids(n):
        return torch.randint(0, 256, (n,), generator=g).tolist()

    def run(prompt):
        before = engine.metrics.snapshot()
        res = _complete(served.base, prompt, max_tokens)
        torch.cuda.synchronize()
        _, d = _metric_delta(engine, before, keys)
        return {**res, "ttft_ms": engine.metrics.last_ttft_ms,
                "tokens": list(served.app.streams[tuple(prompt)]), **d}

    try:
        # -- shared prefix ---------------------------------------------
        prefix = ids(prefix_len)
        prompts = [prefix + ids(question_len) for _ in range(n_questions)]
        full_pages = prefix_len // ps
        torch.cuda.synchronize()
        kernels.reset_launches()
        seq_runs = [run(p) for p in prompts]
        before = engine.metrics.snapshot()
        t0 = time.perf_counter()
        burst = _burst(served.base, prompts, max_tokens)
        burst_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        _, burst_d = _metric_delta(engine, before, keys)
        shared_launches = dict(kernels.LAUNCHES)
        # Outside the counted window: where a resident shared-prefix
        # hit's TTFT goes on the host.
        timeline = {"shared_prefix_hit": _timeline_rec(
            engine, served.base, prompts[-1], max_tokens)}
        cold, hits = seq_runs[0], seq_runs[1:]
        hit_ttft = sorted(r["ttft_ms"] for r in hits)
        shared_ok = (
            cold["prefix_miss"] == 1
            and cold["prefill_tokens"] == len(prompts[0])
            and all(r["prefix_hits"] == 1
                    and r["prefix_hit_tokens"] == full_pages * ps
                    and r["prefill_tokens"] == len(p) - full_pages * ps
                    for r, p in zip(hits, prompts[1:]))
            and all(r is not None and r["completion_tokens"] >= 1
                    for r in burst)
            and burst_d["prefix_miss"] == 0 and burst_d["prefix_hits"] >= 1
            and shared_launches["flash_attention"] > 0
            and shared_launches["paged_attention"] > 0)
        shared = {
            "prefix_tokens": prefix_len, "prefix_full_pages": full_pages,
            "question_tokens": question_len, "requests": n_questions,
            "hit_tokens_each": [r["prefix_hit_tokens"] for r in hits],
            "prefill_tokens_each": [r["prefill_tokens"] for r in seq_runs],
            "ttft_cold_ms": cold["ttft_ms"],
            "ttft_hit_p50_ms": hit_ttft[len(hit_ttft) // 2],
            "ttft_hits_ms": [r["ttft_ms"] for r in hits],
            "burst": {"hits": burst_d["prefix_hits"],
                      "misses": burst_d["prefix_miss"],
                      "lane_demotions": n_questions - burst_d["prefix_hits"]
                      - burst_d["prefix_miss"],
                      "prefill_tokens": burst_d["prefill_tokens"],
                      "wall_s": burst_s},
            "launches": shared_launches, "ok": shared_ok}

        # -- sessions through the pager ---------------------------------
        kernels.reset_launches()
        sessions = [ids(session_len) for _ in range(n_sessions)]
        h1, snaps, sess_runs = [], [], []
        for i, p in enumerate(sessions):
            sess_runs.append(run(p))
            h1.append(run(p))
            if i < n_resume:
                pages = engine.prefix_cache.match(p)
                codes, _ = engine_model.pool_to_pages(
                    engine.pool, torch.tensor(pages, device=engine.device))
                snaps.append((len(pages), codes.cpu()))
        # The spill worker has moved the host tier's oldest pages to disk
        # before the resumes read them.
        spilled = engine.kv_pager.wait_maintenance(60.0)
        mid = engine.metrics.snapshot()
        tiers = [[n.tier for n in engine.prefix_cache.match_nodes(p)]
                 for p in sessions[:n_resume]]
        h2, equal = [], []
        for i, p in enumerate(sessions[:n_resume]):
            h2.append(run(p))
            nodes = engine.prefix_cache.match_nodes(p)[:snaps[i][0]]
            codes, _ = engine_model.pool_to_pages(
                engine.pool, torch.tensor([n.page for n in nodes],
                                          device=engine.device))
            equal.append(bool(torch.equal(codes.cpu().view(torch.int16),
                                          snaps[i][1].view(torch.int16))))
        torch.cuda.synchronize()
        session_launches = dict(kernels.LAUNCHES)
        end = engine.metrics.snapshot()
        # Outside the counted window: where a resident session hit's TTFT
        # goes on the host.
        timeline["session_hit"] = _timeline_rec(engine, served.base,
                                                sessions[-1], max_tokens)
        promoted = end["kv_promotions"] - mid["kv_promotions"]
        capped = session_len - 1
        sess_ok = (
            all(r["prefix_hits"] == 1 and r["prefix_hit_tokens"] == capped
                and r["prefill_tokens"] == 1 for r in h1 + h2)
            and all(equal) and len(equal) == n_resume
            and all(a["tokens"] == b["tokens"] for a, b in zip(h1, h2))
            and spilled and all(t[0] != 0 for t in tiers)  # all demoted
            and end["kv_demotions"] > 0 and promoted > 0
            and end["kv_spill_writes"] > 0
            and session_launches["flash_attention"] > 0
            and session_launches["paged_attention"] > 0)
        sessions_rec = {
            "sessions": n_sessions, "session_tokens": session_len,
            "resumed": n_resume, "max_tokens": max_tokens,
            "capacity_pages": engine.prefix_cache.capacity_pages,
            "host_slots": engine.kv_pager.n_host_slots,
            "h1_hit_tokens": [r["prefix_hit_tokens"] for r in h1],
            "h2_hit_tokens": [r["prefix_hit_tokens"] for r in h2],
            "resume_tiers": tiers,
            "promoted_equal_snapshot": equal,
            "h2_tokens_equal_h1": [a["tokens"] == b["tokens"]
                                   for a, b in zip(h1, h2)],
            "ttft_cold_p50_ms": sorted(r["ttft_ms"] for r in sess_runs)[
                len(sess_runs) // 2],
            "ttft_h1_p50_ms": sorted(r["ttft_ms"] for r in h1)[len(h1) // 2],
            "ttft_h2_ms": [r["ttft_ms"] for r in h2],
            "promoted_pages": promoted,
            "promote_ms_per_page": ((end["kv_promote_ms"]
                                     - mid["kv_promote_ms"]) / promoted
                                    if promoted else None),
            "pager": {k: end[k] for k in end if k.startswith("kv_")},
            "launches": session_launches, "ok": sess_ok}
    finally:
        served.close()
        _release_engine(engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        spill.cleanup()
    launches = {k: shared_launches[k] + session_launches[k]
                for k in shared_launches}
    rec = {"phase": "prefix", "card": card,
           "engine": {**{k: ecfg[k] for k in PREFIX_ENGINE},
                      "n_pages": n_pages, "page_size": ps,
                      "max_batch_size": src.ecfg.max_batch_size},
           "shared_prefix": shared, "sessions": sessions_rec,
           "ttft_timeline": timeline, "launches": launches,
           "engine_warmup_s": served.warm_s,
           "seconds": time.perf_counter() - t_phase,
           "ok": shared["ok"] and sessions_rec["ok"]}
    emit(rec)
    return rec


# -- phase 11e: the serving fleet (router, lifecycle, disagg, HTTP, QoS) ----

# The fleet's replicas: the served engine's config with the prefix cache
# on, and a pool small enough to sit beside the served engine.
FLEET_POOL_PAGES = 129
# The QoS engine's pool: the trace's 1,024-5,000-token batch prompts in
# 8 slots.
QOS_POOL_PAGES = 385
# bursty_trace(seed=0) with long batch prompts (bounded Pareto 1,024 to
# 5,000 tokens: beyond the largest bucket they go through the chunked
# lane, which the latency tier's TTFT phase pauses), over 2 s of
# arrivals (6 s by default; cut for the smoke's time).
QOS_TRACE = {"batch_prompt": (1.4, 1024, 3000), "horizon_s": 2.0}
# The edge's bounds in the 429 check (each tier's in-flight limit).
QOS_EDGE_BOUNDS = {"latency": 2, "standard": 2, "batch": 1}


class _DispatchTally:
    """K1 and K2 launches an engine's dispatches imply: a prefill group's
    forward or a chunk plan launches K1 once a layer, a decode plan K2
    once a layer a step. Wraps the engine's `_prefill_group` and
    `_exec_plan` for the counted window (the engine must be idle when it
    is installed and removed)."""

    def __init__(self, engine):
        self.engine, self.k1, self.k2 = engine, 0, 0
        layers = engine.cfg.n_layers
        group, plan = engine._prefill_group, engine._exec_plan

        def prefill_group(*a, **kw):
            self.k1 += layers
            return group(*a, **kw)

        def exec_plan(rec):
            from generativeaiexamples_tpu_torch.serving.engine_model import (
                plan_from_record)

            p = plan_from_record(rec)
            if p.rider_width:
                self.k1 += layers
            if p.decode_k and not p.spec_k:
                self.k2 += layers * p.decode_k
            return plan(rec)

        engine._prefill_group = prefill_group
        engine._exec_plan = exec_plan

    def remove(self):
        del self.engine._prefill_group
        del self.engine._exec_plan


def _cold_replica(first_page, rids):
    """The replica the prefix router's stable hash gives a prompt no
    replica has seen (serving/router.py `_choose`'s last branch)."""
    h = zlib.crc32(" ".join(str(t) for t in first_page).encode())
    return sorted(rids)[h % len(rids)]


def _chat_sse(base, messages, max_tokens, user="", headers=None):
    """One streaming chat completion: (status, concatenated text,
    finish_reason, response headers)."""
    body = {"messages": messages, "max_tokens": max_tokens, "stream": True}
    if user:
        body["user"] = user
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    text, finish = "", None
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                ch = json.loads(line[6:])["choices"][0]
                text += ch["delta"].get("content", "")
                finish = ch.get("finish_reason") or finish
            return resp.status, text, finish, dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), None, dict(e.headers)


def _collect_req(req, timeout=600):
    """(token ids, finish_reason, seconds to the first token) of a
    submitted request's stream."""
    toks, first = [], None
    while True:
        ev = req.stream.get(timeout=timeout)
        if ev["token_id"] >= 0:
            if first is None:
                first = time.perf_counter()
            toks.append(ev["token_id"])
        if ev["finished"]:
            return toks, ev["finish_reason"], first


def _serve(app):
    """`app` behind a ThreadingHTTPServer on a local port: (httpd,
    thread, base url)."""
    from generativeaiexamples_tpu_torch.serving.openai_server import (
        make_http_server)

    httpd = make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, th, f"http://127.0.0.1:{httpd.server_address[1]}"


def _pages_of(engine, ids):
    """The raw bytes of `ids`' cached full pages in `engine`'s pool."""
    import torch

    from generativeaiexamples_tpu_torch.serving import engine_model

    pages = engine.prefix_cache.match(list(ids))
    codes, _ = engine_model.pool_to_pages(
        engine.pool, torch.tensor(pages, device=engine.device))
    return codes.cpu().view(torch.int16)


# The chaos kill's trace: bursty_trace(seed=3) cut to 3 s with 4 batch
# prompts of 128-1,024 tokens.
CHAOS_TRACE = {"horizon_s": 2.0, "latency_rps": 2.0, "batch_requests": 4,
               "batch_prompt": (1.4, 128, 1024), "batch_out": (1.6, 16, 48)}
# The kill's time into that trace (s); the slowed prefill's prompt (40
# full pages of 128 and a 40-token suffix) and its delay a beat (s); the
# autoscaler's in-flight depth a replica that scales up.
CHAOS_KILL_T = 1.0
CHAOS_PROMPT = 5160
CHAOS_SLOW_S = 0.05
ELASTIC_UP_DEPTH = 1.0


def _active(fleet) -> int:
    return sum(r.state == "active" for r in fleet.replicas)


def _wait_active(fleet, n: int, timeout_s: float) -> float:
    """Seconds until at most `n` replicas are active (the timeout if
    never)."""
    t0 = time.perf_counter()
    while _active(fleet) > n and time.perf_counter() - t0 < timeout_s:
        time.sleep(0.05)
    return time.perf_counter() - t0


def _fleet_elastic(src, engines, fleet_of, letters, chat_ids, ecfg,
                   n_pages, device, n_chats, max_tokens, gap_s):
    """phase_fleet (f): r0 active and r1 parked warm behind a
    FleetAutoscaler (0.25 s polls, 2 up / 3 down ticks, 1 s cooldown,
    1 to 3 replicas, a warm pool of 1, ELASTIC_UP_DEPTH in-flight requests a
    replica) whose spawn lane builds a LocalReplica engine over the
    served weight tree with n_pages pages; the router places by load.
    n_chats greedy chats arrive gap_s apart (each prefills alone, as its
    reference did): the pressure must wake r1 (a scale-up), then, with no
    spare left, spawn a third replica; idle must then park replicas down
    to min_replicas (scale-downs); with scale_to_zero the last parks too
    and one more chat wakes it at submit (a demand wake). Every stream
    must equal the same request alone on the served engine. The seconds
    from the first arrival to r1's wake and to the spawned replica's
    first token are printed."""
    from generativeaiexamples_tpu_torch.serving.autoscaler import (
        FleetAutoscaler)
    from generativeaiexamples_tpu_torch.serving.engine import (
        GenRequest, LLMEngine)
    from generativeaiexamples_tpu_torch.serving.flight import (
        EV_ADMIT, EV_FIRST_TOKEN, EV_SCALE_UP)

    spawned, spawn_s = [], []

    def engine_factory():
        t0 = time.perf_counter()
        eng = LLMEngine(src.params, src.cfg, src.tokenizer, ecfg,
                        n_pages=n_pages, device=device)
        spawn_s.append(time.perf_counter() - t0)
        spawned.append(eng)
        return eng

    chats = [[{"role": "user", "content": letters(200)}]
             for _ in range(n_chats + 1)]
    ids = [chat_ids(m) for m in chats]
    want = [_alone(src, p, max_tokens) for p in ids]
    # Least-load placement: each arrival goes to the shallowest replica,
    # so a replica that has just joined takes the next ones.
    fleet = fleet_of(router_policy="least_load")
    fleet.park("r1")  # warm: its engine runs, it takes no placements
    scaler = FleetAutoscaler(
        fleet, engine_factory=engine_factory, min_replicas=1,
        max_replicas=3, warm_pool=1, interval_s=0.25,
        up_depth=ELASTIC_UP_DEPTH, down_depth=0.5, up_ticks=2, down_ticks=3,
        cooldown_s=1.0, drain_timeout_s=120.0)
    out = [None] * n_chats
    try:
        scaler.start()
        t_burst = time.perf_counter()

        def run(i):
            req = GenRequest(prompt_ids=ids[i], max_new_tokens=max_tokens,
                             request_id=f"elastic-{i}")
            t0 = time.perf_counter()
            fleet.submit(req)
            out[i] = (*_collect_req(req), t0, time.perf_counter())

        threads = []
        for i in range(n_chats):
            threads.append(threading.Thread(target=run, args=(i,)))
            threads[-1].start()
            time.sleep(gap_s)
        for t in threads:
            t.join(timeout=600)
        t_done = time.perf_counter()
        peak_replicas = len(fleet.replicas)
        idle_s = _wait_active(fleet, 1, 60.0)
        states_idle = {r.rid: r.state for r in fleet.replicas}
        scaler.scale_to_zero = True
        zero_s = _wait_active(fleet, 0, 60.0)
        states_zero = {r.rid: r.state for r in fleet.replicas}
        req = GenRequest(prompt_ids=ids[-1], max_new_tokens=max_tokens)
        t0 = time.perf_counter()
        fleet.submit(req)
        wake_toks, wake_finish, wake_first = _collect_req(req)
        wake_ttft_ms = (wake_first - t0) * 1e3 if wake_first else None
        scaler.stop()
        snap = fleet.metrics.snapshot()
        events = scaler.flight.snapshot_events()
        health = fleet.fleet_health()["autoscale"]
    finally:
        scaler.stop()
        fleet.stop()
    ups = [e for e in events if e["kind"] == EV_SCALE_UP]
    wake_r1 = next((e["ts"] for e in ups if e["aux"] == "r1"), None)
    first_spawned = None
    for eng in spawned:
        firsts = [e["ts"] for e in eng.flight.snapshot_events()
                  if e["kind"] == EV_FIRST_TOKEN]
        if firsts:
            first_spawned = min(firsts + ([first_spawned]
                                          if first_spawned else []))
    got = [o[0] if o else None for o in out]
    # Where each chat was admitted (its replica's admit event).
    placed = {}
    for rid, eng in (("r0", engines[0]), ("r1", engines[1]),
                     *((f"as{i + 1}", e) for i, e in enumerate(spawned))):
        for e in eng.flight.snapshot_events():
            if e["kind"] == EV_ADMIT and e["rid"].startswith("elastic-"):
                placed[int(e["rid"].split("-")[1])] = rid
    chats_rec = [{"replica": placed.get(i),
                  "submit_s": (o[3] - t_burst) if o else None,
                  "ttft_ms": (o[2] - o[3]) * 1e3 if o and o[2] else None,
                  "e2e_s": (o[4] - o[3]) if o else None}
                 for i, o in enumerate(out)]
    for eng in spawned:
        _release_engine(eng)
    rec = {"chats": n_chats, "max_tokens": max_tokens, "gap_s": gap_s,
           "autoscaler": {"interval_s": 0.25, "up_depth": ELASTIC_UP_DEPTH,
                          "down_depth": 0.5, "up_ticks": 2,
                          "down_ticks": 3, "cooldown_s": 1.0,
                          "min_replicas": 1, "max_replicas": 3,
                          "warm_pool": 1},
           "burst_s": t_done - t_burst, "per_chat": chats_rec,
           "pressure_to_wake_ms": ((wake_r1 - t_burst) * 1e3
                                   if wake_r1 else None),
           "pressure_to_spawned_first_token_ms": (
               (first_spawned - t_burst) * 1e3 if first_spawned else None),
           "spawn_engine_build_s": spawn_s,
           "scale_events": [{"kind": e["kind"], "rid": e["aux"],
                             "t_ms": (e["ts"] - t_burst) * 1e3,
                             "a": e["a"], "b": e["b"]} for e in events],
           "peak_replicas": peak_replicas,
           "idle_to_min_s": idle_s, "states_idle": states_idle,
           "idle_to_zero_s": zero_s, "states_zero": states_zero,
           "wake_ttft_ms": wake_ttft_ms,
           "counters": {k: snap[k] for k in ("autoscale_ups",
                                             "autoscale_downs",
                                             "autoscale_wakes")},
           "health_spawned": health.get("spawned"),
           "streams_equal_served": [g == w for g, w in zip(got, want)],
           "wake_stream_equal_served": wake_toks == want[-1],
           "first_divergence": [_first_divergence(g or [], w)
                                for g, w in zip(got, want)]}
    rec["ok"] = (wake_r1 is not None and len(spawned) == 1
                 and first_spawned is not None and peak_replicas == 3
                 and snap["autoscale_ups"] >= 2
                 and snap["autoscale_downs"] >= 1
                 and snap["autoscale_wakes"] >= 1
                 and sum(s == "active" for s in states_idle.values()) == 1
                 and all(s != "active" for s in states_zero.values())
                 and all(rec["streams_equal_served"])
                 and rec["wake_stream_equal_served"]
                 and wake_finish in ("length", "stop"))
    return rec


def _fleet_chaos(src, engines, fleet_of, rng, ecfg, n_pages, device,
                 max_tokens, trace_kw):
    """phase_fleet (g). A `slow` injection (CHAOS_SLOW_S a scheduler beat)
    on the prefill replica during a pipelined disagg run in 1-page windows
    of a CHAOS_PROMPT-token prompt whose last chunk holds full pages: each
    window's export waits for one of the replica's beats, so the stage
    finishes while the first chunk's windows still ship, the last chunk's
    pages ship after it and the decode replica admits before the last
    window lands (disagg_early_admits, printed);
    the stream must equal the served engine's, or, where the early admit
    left the decode replica a shorter prefix hit, a single engine's that
    took the same hit (chunk shapes then differ from the served engine's,
    so bf16 rounding may differ). Then a `kill` of a seeded pick in the
    middle of bursty_trace(seed=3, **trace_kw) at CHAOS_KILL_T s over both
    replicas (0.1 s probes, eviction after 2 failures): `classify` must
    count no lost request (errored with no token). Each fleet's /metrics
    must show chaos_injected_* equal to its injections."""
    from generativeaiexamples_tpu_torch.serving import qos as qos_mod
    from generativeaiexamples_tpu_torch.serving.chaos import (
        ChaosEvent, ChaosMonkey, classify, run_chaos_trace)
    from generativeaiexamples_tpu_torch.serving.engine import (
        GenRequest, LLMEngine)
    from generativeaiexamples_tpu_torch.serving.fleet import (
        CHAOS_KEYS, EngineFleet, LocalReplica)
    from generativeaiexamples_tpu_torch.serving.openai_server import (
        OpenAIServer)

    prompt = rng.integers(0, 256, CHAOS_PROMPT).tolist()
    ref = GenRequest(prompt_ids=prompt, max_new_tokens=max_tokens)
    src.submit(ref)
    ref_toks, _, _ = _collect_req(ref)
    sfleet = fleet_of(replica_roles={"r0": "prefill", "r1": "decode"},
                      disagg=True, disagg_pipeline=True,
                      disagg_transfer_chunk_pages=1)
    dec = engines[1]
    try:
        smonkey = ChaosMonkey(sfleet, seed=0)
        m0, ops0 = dec.metrics.snapshot(), sfleet.ops.snapshot()
        smonkey.inject(ChaosEvent(t=0.0, kind="slow", rid="r0",
                                  magnitude=CHAOS_SLOW_S))
        req = GenRequest(prompt_ids=prompt, max_new_tokens=max_tokens)
        t0 = time.perf_counter()
        sfleet.submit(req)
        got, finish, first = _collect_req(req)
        ttft = (first - t0) * 1e3 if first else None
        sfleet._disagg_transfer.drain(timeout_s=120)
        smonkey.undo_all()
        m1, ops1 = dec.metrics.snapshot(), sfleet.ops.snapshot()
        slow_metrics = OpenAIServer(sfleet).metrics()[1]
    finally:
        sfleet.stop()
    d = {k: m1[k] - m0[k] for k in ("prefill_tokens", "prefix_hit_tokens",
                                    "kv_transfer_pages",
                                    "kv_transfer_chunks")}
    o = {k: ops1[k] - ops0[k] for k in ops1}
    same_hit_equal = None
    if got != ref_toks and d["prefix_hit_tokens"]:
        reng = LLMEngine(src.params, src.cfg, src.tokenizer, ecfg,
                         n_pages=n_pages, device=device).start()
        try:
            _alone(reng, prompt[:d["prefix_hit_tokens"]] + [1], 1)
            same_hit_equal = _alone(reng, prompt, max_tokens) == got
        finally:
            reng.stop()
            _release_engine(reng)
    slow = {"prompt_tokens": CHAOS_PROMPT, "slow_s_per_beat": CHAOS_SLOW_S,
            "ttft_ms": ttft, "finish": finish,
            "disagg_early_admits": o["disagg_early_admits"],
            "kv_transfer_chunks": d["kv_transfer_chunks"],
            "decode_engine": d, "fleet_ops": o,
            "equal_served": got == ref_toks,
            "first_divergence": _first_divergence(got, ref_toks),
            "equal_same_hit_engine": same_hit_equal,
            "chaos_metrics": {k: slow_metrics[k] for k in CHAOS_KEYS}}
    slow["ok"] = (o["disagg_requests"] == 1 and o["disagg_fallbacks"] == 0
                  and finish in ("length", "stop")
                  and (got == ref_toks or same_hit_equal is True)
                  and slow["chaos_metrics"] == {
                      **dict.fromkeys(CHAOS_KEYS, 0),
                      "chaos_injected_slow_beats": 1})

    kfleet = EngineFleet([LocalReplica("r0", engines[0]),
                          LocalReplica("r1", engines[1])], src.tokenizer,
                         engines[0].pool.page_size, health_interval_s=0.1,
                         health_fail_threshold=2).start()
    trace = qos_mod.bursty_trace(seed=3, **trace_kw)
    try:
        t0 = time.perf_counter()
        results, kmonkey = run_chaos_trace(
            kfleet, trace, [ChaosEvent(t=CHAOS_KILL_T, kind="kill")], seed=7,
            timeout_s=600.0)
        wall = time.perf_counter() - t0
        buckets = classify(results)
        kill_metrics = OpenAIServer(kfleet).metrics()[1]
        killed = [e["aux"] for e in kmonkey.flight.snapshot_events()]
        states = {r.rid: r.state for r in kfleet.replicas}
    finally:
        kfleet.stop()
    kill = {"trace": {"requests": len(trace), **{k: list(v) if isinstance(
                v, tuple) else v for k, v in trace_kw.items()}},
            "kill_t_s": CHAOS_KILL_T, "killed": killed, "states": states,
            "wall_s": wall, "classify": buckets,
            "replica_evictions": kill_metrics["replica_evictions"],
            "router_requeued": kill_metrics["router_requeued"],
            "chaos_metrics": {k: kill_metrics[k] for k in CHAOS_KEYS}}
    kill["ok"] = (buckets["lost"] == 0 and buckets["completed"] >= 1
                  and sum(buckets.values()) == len(trace)
                  and len(killed) == 1
                  and kill_metrics["replica_evictions"] == 1
                  and kill["chaos_metrics"] == {
                      **dict.fromkeys(CHAOS_KEYS, 0),
                      "chaos_injected_kills": 1})
    return {"slow": slow, "kill": kill, "ok": slow["ok"] and kill["ok"]}


def phase_fleet(card: str, bf16_served, device: str = "cuda",
                n_chats: int = 4, n_sessions: int = 4, chat_chars: int = 300,
                max_tokens: int = 16, disagg_prompt: int = 4136,
                disagg_tokens: int = 16, chunk_pages: int = 8,
                n_pages: int = FLEET_POOL_PAGES, engine_cfg=None,
                warmups=(((512, 1024), None), ((4096,), (1,))),
                qos_pages: int = QOS_POOL_PAGES, qos_trace=None,
                qos_warmup=((128,), (1,)),
                edge_requests: int = 6, edge_tokens: int = 64,
                elastic_chats: int = 16, elastic_tokens: int = 64,
                elastic_gap_s: float = 0.15, chaos_trace=None):
    """The serving fleet over the bf16 8B weights the served engine holds:
    two LocalReplica engines (the served engine's config with the prefix
    cache on, n_pages pool pages each) sharing that one weight tree,
    behind the port's OpenAI server.

    (a) routing: n_chats greedy max_tokens-token chats over n_sessions
    sessions (`user`), submitted 0.1 s apart so each is its own prefill
    group as when run alone, all decoding together, two sessions on
    each replica (the cold first turns' texts are drawn so the router's
    stable hash splits them): each stream must
    equal the same request alone on the served engine; over this window
    K1's and K2's launches must equal what the replicas' dispatches imply
    (launch counting under two scheduler threads). Then each session's
    second turn must land on its replica with a router locality hit and
    an engine prefix hit. (b) lifecycle: drain a replica with a stream in
    flight (it completes), restore; stop a replica's engine, queue a
    batch-tier request pinned to it, evict it: the request is requeued to
    the survivor with its tier and tenant and completes; restore. (c)
    disagg (r0 prefill, r1 decode): a disagg_prompt-token prompt (32 full
    pages and a 40-token suffix) over the host bounce, then over the
    device path (card to card, no host copy), then pipelined in windows
    of chunk_pages pages; one more prompt warms the shapes first. The
    decode replica must prefill only the suffix on the two serialized
    routes, every stream must equal the served engine's, and no run may
    fall back (disagg_fallbacks, disagg_device_fallbacks 0). (d) HTTP:
    r1 behind a second server as an HttpReplica of a router-only fleet: a
    proxied SSE chat equal to the served engine's, and one transfer over
    /v1/kv/export -> /v1/kv/import seating bytes equal to the in-process
    export. (f) elastic: the two replicas behind an autoscaler
    (`_fleet_elastic`): a burst wakes the warm spare and spawns a third
    replica over the same weights, idle parks down to one, scale to zero
    and a demand wake; streams equal the served engine's. (g) chaos
    (`_fleet_chaos`): a slowed prefill replica in a pipelined disagg run
    of 1-page windows, then a replica killed in the middle of a bursty
    trace (none lost that was not streaming). (e) QoS, after the
    replicas are freed: one engine replays
    qos.bursty_trace(seed=0) with long batch prompts, QoS off then on
    (latency-tier TTFT p50/p95, qos_preemptions); then with
    serving.qos_edge, edge_requests concurrent latency-tier requests
    against a bound of 2: the rest must get 429 with Retry-After.

    K1 and K2 must launch in the phase, K4, K5 and K6 must not."""
    import dataclasses

    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.config.schema import ServingConfig
    from generativeaiexamples_tpu_torch.serving import qos as qos_mod
    from generativeaiexamples_tpu_torch.serving.disagg import page_geometry
    from generativeaiexamples_tpu_torch.serving.engine import (
        GenRequest, LLMEngine)
    from generativeaiexamples_tpu_torch.serving.fleet import (
        EngineFleet, HttpReplica, LocalReplica)
    from generativeaiexamples_tpu_torch.serving.openai_server import (
        OpenAIServer)

    t_phase = time.perf_counter()
    src = bf16_served.engine
    tok = src.tokenizer
    ecfg = dataclasses.replace(src.ecfg, prefix_cache=True,
                               **(engine_cfg or {}))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    engines = []
    for _ in range(2):
        eng = LLMEngine(src.params, src.cfg, tok, ecfg, n_pages=n_pages,
                        device=device)
        for buckets, groups in warmups:
            eng.warmup(buckets=list(buckets),
                       group_sizes=None if groups is None else list(groups))
        engines.append(eng.start())
    build_s = time.perf_counter() - t0
    memory = {"allocated_gb": torch.cuda.memory_allocated() / 2**30,
              "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    ps = engines[0].pool.page_size
    rng = np.random.default_rng(21)
    servers = []

    def fleet_of(**kw):
        return EngineFleet([LocalReplica("r0", engines[0]),
                            LocalReplica("r1", engines[1])], tok, ps,
                           health_interval_s=0, **kw).start()

    def letters(n):
        return "".join(chr(c) for c in rng.integers(97, 123, n))

    def chat_ids(messages):
        return tok.encode(tok.apply_chat_template(messages), add_bos=False)

    fleet = fleet_of()
    app = _recording_server(fleet)
    httpd, th, base = _serve(app)
    servers.append((httpd, th))
    rec = {"phase": "fleet", "card": card, "replica_pool_pages": n_pages,
           "replica_build_s": build_s, "memory": memory,
           "engine": {"page_size": ps, "max_batch_size": ecfg.max_batch_size,
                      "prefix_cache": True}}
    try:
        part_s = {}
        t_part = time.perf_counter()
        # -- (a) routing ---------------------------------------------------
        users = [f"user-{i % n_sessions}" for i in range(n_chats)]
        # The first turns are cold, so the router's stable hash of their
        # first page places them: their texts are drawn until the hash
        # gives each replica half the sessions, so both scheduler
        # threads launch at once in the counted window.
        firsts, per = [], {"r0": 0, "r1": 0}
        for _ in range(256):
            if len(firsts) == n_sessions:
                break
            msgs = [{"role": "user", "content": letters(chat_chars)}]
            r = _cold_replica(chat_ids(msgs)[:ps], ("r0", "r1"))
            if per[r] < n_sessions // 2 + n_sessions % 2:
                per[r] += 1
                firsts.append(msgs)
        chats = firsts + [[{"role": "user", "content": letters(chat_chars)}]
                          for _ in range(n_chats - n_sessions)]
        want = [_alone(src, chat_ids(m), max_tokens) for m in chats]
        torch.cuda.synchronize()
        before = dict(kernels.LAUNCHES)
        tallies = [_DispatchTally(e) for e in engines]
        results = [None] * n_chats

        def chat(i):
            results[i] = _chat_sse(base, chats[i], max_tokens, users[i])

        threads = []
        for i in range(n_chats):
            threads.append(threading.Thread(target=chat, args=(i,)))
            threads[-1].start()
            time.sleep(0.1)
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        window = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        for t in tallies:
            t.remove()
        got = [list(app.streams.get(tuple(chat_ids(m)), ()))
               for m in chats]
        placed = {u: fleet.router._affinity[u][0] for u in set(users)}
        turn1 = {"streams_equal_served": [g == w for g, w in zip(got, want)],
                 "first_divergence": [_first_divergence(g, w)
                                      for g, w in zip(got, want)],
                 "finish": [r[2] if r else None for r in results],
                 "placement": placed,
                 "launches": {k: window[k] for k in ("flash_attention",
                                                     "paged_attention")},
                 "dispatch_implied": {
                     "flash_attention": sum(t.k1 for t in tallies),
                     "paged_attention": sum(t.k2 for t in tallies)}}
        turn2 = []
        for u in sorted(set(users)):
            i = users.index(u)
            msgs = chats[i] + [{"role": "assistant", "content": results[i][1]},
                               {"role": "user", "content": letters(40)}]
            rid = fleet.router._affinity[u][0]
            eng = engines[int(rid[1])]
            snap0, hits0 = fleet.router.snapshot(), eng.metrics.prefix_hits
            status, _, finish, _ = _chat_sse(base, msgs, 16, u)
            snap1 = fleet.router.snapshot()
            turn2.append({
                "session": u, "replica": rid, "status": status,
                "finish": finish,
                "same_replica": fleet.router._affinity[u][0] == rid,
                "router_prefix_hit": snap1["router_prefix_hits"]
                - snap0["router_prefix_hits"],
                "router_hit_tokens": snap1["router_hit_tokens"]
                - snap0["router_hit_tokens"],
                "engine_prefix_hits": eng.metrics.prefix_hits - hits0})
        routing_ok = (
            all(turn1["streams_equal_served"])
            and all(f in ("length", "stop") for f in turn1["finish"])
            and len(set(placed.values())) == 2
            and turn1["launches"] == turn1["dispatch_implied"]
            and turn1["launches"]["flash_attention"] > 0
            and turn1["launches"]["paged_attention"] > 0
            and all(t["status"] == 200 and t["same_replica"]
                    and t["router_prefix_hit"] == 1
                    and t["engine_prefix_hits"] >= 1 for t in turn2))
        time_mark("fleet_routing")
        rec["routing"] = {"chats": n_chats, "sessions": n_sessions,
                          "prompt_tokens": [len(chat_ids(m)) for m in chats],
                          "turn1": turn1, "turn2": turn2,
                          "router": fleet.router.snapshot(),
                          "ok": routing_ok}

        part_s["routing"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # -- (b) lifecycle ---------------------------------------------------
        prompt = rng.integers(0, 256, 200).tolist()
        req = GenRequest(prompt_ids=prompt, max_new_tokens=max_tokens)
        fleet.submit(req)
        first = req.stream.get(timeout=600)
        rid = next(r for r, d in fleet.router.queue_depths().items() if d)
        drained = fleet.drain(rid, timeout_s=300)
        toks, finish, _ = _collect_req(req)
        state_drained = fleet.fleet_health()["replicas"][rid]["state"]
        fleet.restore(rid)
        drain_ok = (drained and state_drained == "drained"
                    and finish in ("length", "stop")
                    and len(toks) + (first["token_id"] >= 0)
                    == max_tokens)
        victim = placed[users[0]]
        survivor = "r1" if victim == "r0" else "r0"
        v_eng = engines[int(victim[1])]
        v_eng.stop()
        queued = GenRequest(prompt_ids=rng.integers(0, 256, 150).tolist(),
                            max_new_tokens=16, priority="batch",
                            tenant_id="tenant-evict", session_id=users[0],
                            request_id="evict-requeue")
        # Placed on the victim (the survivor briefly refuses placements),
        # where it queues on the stopped engine.
        fleet.router.set_admitting(survivor, False)
        fleet.submit(queued)
        fleet.router.set_admitting(survivor, True)
        waiting = len(v_eng.waiting)
        requeued = fleet.evict(victim)
        toks, finish, _ = _collect_req(queued)
        s_eng = engines[int(survivor[1])]
        tiers = [e["tier"] for e in s_eng.flight.snapshot_events()
                 if e["rid"] == "evict-requeue"]
        state_evicted = fleet.fleet_health()["replicas"][victim]["state"]
        fleet.restore(victim)
        evict_ok = (waiting == 1 and requeued == 1
                    and state_evicted == "evicted"
                    and finish in ("length", "stop") and len(toks) == 16
                    and queued.priority == "batch"
                    and queued.tenant_id == "tenant-evict"
                    and tiers and all(t == 2 for t in tiers)
                    and fleet.router._affinity[users[0]][0] == survivor
                    and v_eng._running
                    and fleet.metrics.snapshot()["router_requeued"] == 1)
        time_mark("fleet_lifecycle")
        rec["lifecycle"] = {
            "drain": {"replica": rid, "emptied": drained,
                      "state": state_drained, "finish": finish,
                      "ok": drain_ok},
            "evict": {"replica": victim, "survivor": survivor,
                      "queued_on_victim": waiting, "requeued": requeued,
                      "state": state_evicted, "tokens": len(toks),
                      "survivor_tiers": tiers, "ok": evict_ok}}
        lifecycle_ok = drain_ok and evict_ok

        part_s["lifecycle"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # -- (c) disagg ------------------------------------------------------
        runs = {}
        full = disagg_prompt // ps
        shape, dtype, _ = page_geometry(engines[1].pool)
        page_bytes = int(np.prod(shape)) * torch.empty(
            (), dtype=dtype).element_size()
        for name, kw in (
                ("warm", {}), ("host", {}),
                ("device", {"disagg_device_path": True}),
                ("pipelined", {"disagg_pipeline": True,
                               "disagg_transfer_chunk_pages": chunk_pages})):
            prompt = rng.integers(0, 256, disagg_prompt).tolist()
            t0 = time.perf_counter()
            ref = GenRequest(prompt_ids=prompt, max_new_tokens=disagg_tokens)
            src.submit(ref)
            ref_toks, _, ref_first = _collect_req(ref)
            colocated_ttft = (ref_first - t0) * 1e3
            dfleet = fleet_of(replica_roles={"r0": "prefill",
                                             "r1": "decode"},
                              disagg=True, **kw)
            dec = engines[1]
            m0, ops0 = dec.metrics.snapshot(), dfleet.ops.snapshot()
            req = GenRequest(prompt_ids=prompt, max_new_tokens=disagg_tokens)
            t0 = time.perf_counter()
            dfleet.submit(req)
            got_toks, finish, first = _collect_req(req)
            ttft = (first - t0) * 1e3
            dfleet._disagg_transfer.drain(timeout_s=60)
            m1, ops1 = dec.metrics.snapshot(), dfleet.ops.snapshot()
            d = {k: m1[k] - m0[k] for k in (
                "prefill_tokens", "prefix_hits", "prefix_hit_tokens",
                "kv_transfer_pages", "kv_transfer_ms",
                "kv_transfer_device_pages", "kv_transfer_chunks")}
            o = {k: ops1[k] - ops0[k] for k in ops1}
            pages = d["kv_transfer_pages"]
            run = {"prompt_tokens": disagg_prompt, "full_pages": full,
                   "kv_bytes": pages * page_bytes,
                   "decode_prefill_tokens": d["prefill_tokens"],
                   "engine": d, "fleet_ops": o,
                   "ms_per_page": (o["disagg_transfer_ms"] / pages
                                   if pages else None),
                   "import_ms_per_page": (d["kv_transfer_ms"] / pages
                                          if pages else None),
                   "ttft_ms": ttft, "colocated_ttft_ms": colocated_ttft,
                   "equal_served": got_toks == ref_toks,
                   "first_divergence": _first_divergence(got_toks,
                                                         ref_toks),
                   "finish": finish}
            suffix_only = d["prefill_tokens"] == disagg_prompt - full * ps
            run["ok"] = (
                o["disagg_requests"] == 1 and o["disagg_fallbacks"] == 0
                and o["disagg_device_fallbacks"] == 0
                and finish in ("length", "stop")
                and (name == "pipelined" or (
                    suffix_only and got_toks == ref_toks
                    and pages == full and d["prefix_hits"] == 1))
                and (name != "device"
                     or d["kv_transfer_device_pages"] == full)
                and (name == "device" or d["kv_transfer_device_pages"] == 0))
            runs[name] = run
        time_mark("fleet_disagg")
        rec["disagg"] = {"runs": runs, "chunk_pages": chunk_pages}
        disagg_ok = all(r["ok"] for r in runs.values())

        part_s["disagg"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # -- (d) HTTP replicas -----------------------------------------------
        b_app = _recording_server(engines[1])
        a_app = _recording_server(engines[0])
        hb, tb, base_b = _serve(b_app)
        ha, ta, base_a = _serve(a_app)
        servers += [(hb, tb), (ha, ta)]
        hfleet = EngineFleet([HttpReplica("h0", base_b)], tok, ps,
                             health_interval_s=0).start()
        hf, tf_, base_f = _serve(OpenAIServer(hfleet))
        servers.append((hf, tf_))
        msgs = [{"role": "user", "content": letters(chat_chars)}]
        ids = chat_ids(msgs)
        want_toks = _alone(src, ids, 32)
        _, want_text, want_finish, _ = _chat_sse(bf16_served.base, msgs, 32)
        status, text, finish, _ = _chat_sse(base_f, msgs, 32)
        proxied = list(b_app.streams.get(tuple(ids), ()))
        remote = HttpReplica("b", base_b).export_kv_pages(ids)
        local = LocalReplica("r1", engines[1]).export_kv_pages(ids)
        wire_equal = (remote is not None and local is not None
                      and remote[2] == local[2]
                      and torch.equal(remote[0].view(torch.int16),
                                      local[0].view(torch.int16)))
        imported = HttpReplica("a", base_a).import_kv_pages(
            ids[:remote[2]], remote[0], remote[1]) if remote else 0
        seated_equal = bool(imported and torch.equal(
            _pages_of(engines[0], ids), _pages_of(engines[1], ids)))
        http_ok = (status == 200 and text == want_text
                   and finish == want_finish and proxied == want_toks
                   and wire_equal and imported == len(ids) // ps
                   and seated_equal)
        time_mark("fleet_http")
        rec["http"] = {"sse_status": status, "sse_text_equal": text
                       == want_text, "finish": finish,
                       "proxied_tokens_equal_served": proxied == want_toks,
                       "export_pages": (remote[0].shape[0] if remote
                                        else 0),
                       "wire_equal_in_process": wire_equal,
                       "imported": imported, "seated_equal": seated_equal,
                       "ok": http_ok}
        hfleet.stop()
        part_s["http"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        time_mark("fleet_elastic")
        rec["elastic"] = _fleet_elastic(
            src, engines, fleet_of, letters, chat_ids, ecfg, n_pages, device,
            elastic_chats, elastic_tokens, elastic_gap_s)
        part_s["elastic"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        time_mark("fleet_chaos")
        rec["chaos"] = _fleet_chaos(
            src, engines, fleet_of, rng, ecfg, n_pages, device,
            disagg_tokens, chaos_trace or CHAOS_TRACE)
        part_s["chaos"] = time.perf_counter() - t_part
        launches_fleet = dict(kernels.LAUNCHES)
    finally:
        for httpd, t in servers:
            httpd.shutdown()
            httpd.server_close()
            t.join(timeout=30)
        for e in engines:
            e.stop()
            _release_engine(e)
        del engines
        gc.collect()
        torch.cuda.empty_cache()

    # -- (e) QoS --------------------------------------------------------------
    t_part = time.perf_counter()
    qcfg = dataclasses.replace(src.ecfg, qos=True)
    qeng = LLMEngine(src.params, src.cfg, tok, qcfg, n_pages=qos_pages,
                     device=device)
    t0 = time.perf_counter()
    qeng.warmup(buckets=list(qos_warmup[0]), group_sizes=list(qos_warmup[1]))
    qos_warm_s = time.perf_counter() - t0
    qeng.start()
    time_mark("fleet_qos")
    trace = qos_mod.bursty_trace(seed=0, **(qos_trace or QOS_TRACE))
    scheduler = qeng.qos
    qos_runs = {}
    try:
        for name in ("off", "on"):
            qeng.qos = scheduler if name == "on" else None
            p0 = qeng.metrics.qos_preemptions
            t0 = time.perf_counter()
            res = qos_mod.run_trace_on_engine(qeng, trace, seed=0,
                                              timeout_s=600)
            lat = sorted(r["ttft_s"] * 1e3 for r in res
                         if r["tier"] == "latency" and r["ttft_s"])
            bat = sorted(r["ttft_s"] * 1e3 for r in res
                         if r["tier"] == "batch" and r["ttft_s"])
            qos_runs[name] = {
                "wall_s": time.perf_counter() - t0,
                "latency_ttft_p50_ms": _pct(lat, 0.5),
                "latency_ttft_p95_ms": _pct(lat, 0.95),
                "batch_ttft_p50_ms": _pct(bat, 0.5),
                "errors": sum(r["error"] for r in res),
                "served": sum(r["tokens"] > 0 for r in res),
                "qos_preemptions": qeng.metrics.qos_preemptions - p0}
        qeng.qos = scheduler
        edge_app = OpenAIServer(qeng, serving_cfg=ServingConfig(
            qos_edge=True, qos_bound_latency=QOS_EDGE_BOUNDS["latency"],
            qos_bound_standard=QOS_EDGE_BOUNDS["standard"],
            qos_bound_batch=QOS_EDGE_BOUNDS["batch"],
            qos_retry_after_s=1.0))
        he, te, base_e = _serve(edge_app)
        answers = [None] * edge_requests

        def edge_call(i):
            answers[i] = _chat_sse(
                base_e, [{"role": "user", "content": f"edge {i}"}],
                edge_tokens, headers={"x-priority": "latency"})

        try:
            ths = [threading.Thread(target=edge_call, args=(i,))
                   for i in range(edge_requests)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            edge_snap = edge_app.metrics()[1]
        finally:
            he.shutdown()
            he.server_close()
            te.join(timeout=30)
    finally:
        qeng.stop()
        _release_engine(qeng)
        del qeng
        gc.collect()
        torch.cuda.empty_cache()
    shed = [a for a in answers if a and a[0] == 429]
    served = [a for a in answers if a and a[0] == 200]
    bound = QOS_EDGE_BOUNDS["latency"]
    edge_ok = (len(served) == bound and len(shed) == edge_requests - bound
               and all(a[3].get("Retry-After") == "1" for a in shed)
               and edge_snap["qos_shed_latency"] == len(shed))
    qos_ok = (qos_runs["off"]["qos_preemptions"] == 0
              and all(r["errors"] == 0 and r["served"] == len(trace)
                      for r in qos_runs.values()))
    rec["qos"] = {"trace": {"requests": len(trace),
                            "latency": sum(t.tier == "latency"
                                           for t in trace),
                            "batch": sum(t.tier == "batch" for t in trace),
                            "batch_prompt": list(
                                (qos_trace or QOS_TRACE)["batch_prompt"])},
                  "pool_pages": qos_pages, "warmup_s": qos_warm_s,
                  "runs": qos_runs,
                  "edge": {"bounds": QOS_EDGE_BOUNDS,
                           "requests": edge_requests, "served": len(served),
                           "shed_429": len(shed),
                           "retry_after": [a[3].get("Retry-After")
                                           for a in shed],
                           "qos_shed_latency": edge_snap["qos_shed_latency"],
                           "ok": edge_ok},
                  "ok": qos_ok and edge_ok}
    torch.cuda.synchronize()
    part_s["qos"] = time.perf_counter() - t_part
    rec["part_seconds"] = part_s
    launches = dict(kernels.LAUNCHES)
    rec["launches"] = launches
    rec["launches_before_qos"] = launches_fleet
    rec["seconds"] = time.perf_counter() - t_phase
    rec["ok"] = (routing_ok and lifecycle_ok and disagg_ok and http_ok
                 and rec["elastic"]["ok"] and rec["chaos"]["ok"]
                 and rec["qos"]["ok"]
                 and launches["flash_attention"] > 0
                 and launches["paged_attention"] > 0
                 and not any(launches[k] for k in (
                     "paged_attention_int8", "paged_attention_tree",
                     "int8_matmul")))
    emit(rec)
    return rec


# -- phases 15a-15d: the framework-neutral modules and training -------------

# The K1 / K2 / K3 launch counts a phase line prints.
K123 = ("flash_attention", "paged_attention", "encoder_attention")
# Logits of the trained LoRA model through K1 against the training route
# (plain attention) on the same tokens, relative to the largest |logit|:
# both bf16 over 32 layers, where K1 rounds P to bf16 before P.V (the
# budget of phase_tp's teacher-forced logits, TP_LOGIT_RTOL, which the
# same depth met at 1.9-2.3%); a fault in the merge or the route gives
# O(1).
TRAIN_LOGIT_RTOL = 5e-2


def _k123() -> dict:
    from generativeaiexamples_tpu_torch import kernels

    return {k: kernels.LAUNCHES[k] for k in K123}


def _ingest_sources(root: str, n_chunks: int, n_events: int):
    """A generated directory of text, HTML and PDF files from the RAG
    corpus (seed 4) and the queue events beside it: (file patterns,
    events)."""
    import html as html_mod

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    paras = _rag_corpus(4, n_chunks).split("\n\n")
    events, paras = paras[:n_events], paras[n_events:]
    groups = [paras[i::24] for i in range(24)]
    for i, group in enumerate(groups):
        if i < 16:
            with open(os.path.join(root, f"doc{i:02d}.txt"), "w",
                      encoding="utf-8") as fh:
                fh.write("\n\n".join(group))
        elif i < 22:
            with open(os.path.join(root, f"page{i:02d}.html"), "w",
                      encoding="utf-8") as fh:
                fh.write("<html><head><style>p {}</style><script>var x;"
                         "</script></head><body>" + "".join(
                             f"<p>{html_mod.escape(p)}</p>" for p in group)
                         + "</body></html>")
        else:
            pages = ["".join(c for c in p if c.isascii() and c not in "()\\")
                     for p in group]
            with open(os.path.join(root, f"deck{i:02d}.pdf"), "wb") as fh:
                fh.write(_pdf_bytes(pages))
    pats = [os.path.join(root, p) for p in ("*.txt", "*.html", "*.pdf")]
    return pats, events


def phase_ingest(card: str, keep: dict, device: str = "cuda",
                 n_chunks: int = 2000, n_events: int = 64,
                 embed_batch: int = 64):
    """ingest/pipeline.py on the card: FileSource over a generated
    directory of text, HTML and PDF files plus a QueueSource of events
    (~2,000 chunks at the default splitter) through the arctic embedder
    (K3) into a fresh device store, with embed and store pipelined. The
    same sources through a host run (hash embedder, memory store) must
    give the same document and chunk counts; the store's first batch of
    rows must be within BF16_ATOL of a direct embedder call on its texts;
    K3 must launch once a layer a forward. The overlap of the embed and
    store stages is printed (seconds of store.add that ran while a batch
    embedded)."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.fakes import HashEmbedder
    from generativeaiexamples_tpu_torch.connectors.local import LocalEmbedder
    from generativeaiexamples_tpu_torch.ingest.pipeline import (
        FileSource, IngestPipeline, QueueSource)
    from generativeaiexamples_tpu_torch.rag.splitter import get_text_splitter
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        DeviceVectorStore, MemoryVectorStore)

    emb = keep["emb"]
    root = os.path.join("build", "ingest_smoke")
    pats, events = _ingest_sources(root, n_chunks, n_events)
    splitter = get_text_splitter(load_config(env={}))
    spans = {"embed": [], "store": []}

    class TimedEmbedder:
        def __init__(self, inner):
            self.inner, self.dim = inner, inner.dim

        def embed_documents(self, texts):
            t0 = time.perf_counter()
            out = self.inner.embed_documents(texts)
            spans["embed"].append((t0, time.perf_counter()))
            return out

    class TimedStore:
        def __init__(self, inner):
            self.inner = inner

        def add(self, *a):
            t0 = time.perf_counter()
            out = self.inner.add(*a)
            torch.cuda.synchronize()
            spans["store"].append((t0, time.perf_counter()))
            return out

        def stats(self):
            return self.inner.stats()

    def sources():
        q = QueueSource(source_name="events")
        for i, text in enumerate(events):
            q.push(text, {"event": i})
        q.close()
        return [FileSource(pats, source_name="files"), q]

    host = IngestPipeline(sources(), splitter, HashEmbedder(emb.dim),
                          MemoryVectorStore(emb.dim),
                          embed_batch=embed_batch).run()
    store = DeviceVectorStore(emb.dim, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    emb.forwards = 0
    t0 = time.perf_counter()
    stats = IngestPipeline(sources(), splitter,
                           TimedEmbedder(LocalEmbedder(emb)),
                           TimedStore(store), embed_batch=embed_batch).run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, forwards = _k123(), emb.forwards
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    overlap = sum(max(0.0, min(e1, s1) - max(e0, s0))
                  for e0, e1 in spans["embed"] for s0, s1 in spans["store"])
    texts = [d["text"] for d in store.snapshot_docs()][:embed_batch]
    direct = LocalEmbedder(emb).embed_documents(texts)
    rows = store.rows()[:len(texts)].float().cpu().numpy()
    row_err = float(np.abs(rows - np.asarray(direct, np.float32)).max())
    ok = (stats["documents"] == host["documents"]
          and stats["chunks"] == host["chunks"] == stats["embeddings"]
          == len(store) and stats["store"]["ntotal"] == len(store)
          and row_err <= BF16_ATOL
          and launches["encoder_attention"] == forwards * emb.cfg.n_layers
          > 0)
    shutil.rmtree(root, ignore_errors=True)
    rec = {"phase": "ingest", "card": card, "embedder": "arctic_embed_l bf16",
           "store": "DeviceVectorStore", "embed_batch": embed_batch,
           "files": {"txt": 16, "html": 6, "pdf": 2}, "events": len(events),
           "stats": stats, "host_counts": {k: host[k] for k in (
               "documents", "chunks")},
           "run_s": run_s, "chunks_per_s": stats["chunks"] / run_s,
           "embed_s": sum(b - a for a, b in spans["embed"]),
           "store_s": sum(b - a for a, b in spans["store"]),
           "embed_store_overlap_s": overlap, "batches": len(spans["embed"]),
           "first_batch_row_err": row_err, "tol": BF16_ATOL,
           "forwards": forwards, "launches": launches,
           "peak_mem_gb": peak_gb, "ok": ok}
    emit(rec)
    return rec


class _QAFromChunk:
    """A ChatLLM that answers the harness's QA prompt extractively: the
    question names the passage's first words, the answer is its first
    sentence (a random-weight engine writes no JSON)."""

    def chat(self, messages, **kw):
        chunk = messages[-1]["content"].split("Passage:\n", 1)[1].split(
            "\n\nReply with one JSON object", 1)[0]
        first = chunk.split(". ")[0].strip()
        return json.dumps({
            "question": "What does the passage say about "
                        f"{' '.join(chunk.split()[:6])}?",
            "answer": first if first.endswith(".") else first + "."})


class _ShortLLM:
    """A ChatLLM whose replies are capped at `cap` tokens (the harness
    asks for up to 256)."""

    def __init__(self, llm, cap: int):
        self.llm, self.cap = llm, cap

    def chat(self, messages, **kw):
        kw["max_tokens"] = min(kw.get("max_tokens", self.cap), self.cap)
        return self.llm.chat(messages, **kw)


# The report keys of the JAX harness (eval/harness.py run_eval,
# eval/metrics.py): ragas, llm_judge, retrieval and n.
EVAL_REPORT_KEYS = {
    "ragas": {"faithfulness", "context_relevancy", "answer_relevancy",
              "context_recall", "context_precision", "answer_similarity",
              "ragas_score"},
    "llm_judge": {"mean_rating", "rated", "total", "details"},
    "retrieval": {"n_scored", "hit_at_1", "hit_at_k", "hit_at_k_min", "k",
                  "k_min", "mrr", "match_threshold"}}


def phase_eval(card: str, served: ServedEngine, keep: dict,
               device: str = "cuda", n_rows: int = 1, max_tokens: int = 16):
    """eval/harness.py end to end beside a chain server (developer_rag
    over the served 8B engine, phase_rag's encoders and a fresh device
    store): the corpus uploaded through ChainServerClient,
    generate_synthetic_qa (the engine first; a random-weight model
    writes no JSON, so the rows it cannot give come from an extractive
    generator over the same chunks), generate_answers through the
    client (answers of `max_tokens`), run_eval with the engine as the
    grader (replies capped at `max_tokens`) and the arctic embedder, and
    save_report. The report's keys must be the JAX harness's, every
    ragas and retrieval metric a number in [0, 1] or None, the
    model-free retrieval metrics and answer_similarity numbers (JAX's
    rules give numbers there: every row has a ground-truth context and
    answer), and K1, K2 and K3 must launch."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.connectors.local import (
        LocalEmbedder, LocalEngineLLM)
    from generativeaiexamples_tpu_torch.eval import harness
    from generativeaiexamples_tpu_torch.rag.splitter import get_text_splitter
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        DeviceVectorStore)

    emb, rr = keep["emb"], keep["rr"]
    # Chunks of ~120 approx-tokens: with the byte tokenizer a probe's
    # prompt (four chunks of context) stays inside the engine's 8,191.
    config = load_config(env={}, overrides={
        "vector_store": {"name": "tpu"},
        "embeddings": {"dimensions": emb.dim},
        "text_splitter": {"chunk_size": 120, "chunk_overlap": 20}})
    hub = EngineHub(config, llm=served.engine, embed=emb, rerank=rr,
                    device=device)
    root = os.path.join("build", "eval_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    corpus = os.path.join(root, "corpus.txt")
    with open(corpus, "w", encoding="utf-8") as fh:
        fh.write(_rag_corpus(5, 12))
    chunks = get_text_splitter(config).split(open(corpus).read())

    class ShortAnswers(harness.ChainServerClient):
        def generate(self, question, use_kb=True, **settings):
            return super().generate(question, use_kb, max_tokens=max_tokens,
                                    **settings)

    app, httpd, base, th = _chain_server(
        config, hub, DeviceVectorStore(emb.dim, device=device))
    llm = _ShortLLM(LocalEngineLLM(served.engine), max_tokens)
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        client = ShortAnswers(base, timeout=600)
        client.upload(corpus)
        from_engine = harness.generate_synthetic_qa(llm, chunks[:n_rows])
        qa = (from_engine + harness.generate_synthetic_qa(
            _QAFromChunk(), chunks[len(from_engine):n_rows]))[:n_rows]
        rows = harness.generate_answers(client, qa)
        report = harness.run_eval(llm, LocalEmbedder(emb), rows)
        report["environment"] = {"mode": "chain-server", "server": base,
                                 "grader_llm": "LocalEngineLLM (8b, random)",
                                 "embedder": "LocalEmbedder (arctic)"}
        report["rows"] = rows
        path = os.path.join(root, "report.json")
        harness.save_report(report, path)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _k123()
        with open(path) as fh:
            saved = json.load(fh)
    finally:
        _stop_server(app, httpd, th)
        shutil.rmtree(root, ignore_errors=True)

    def unit(v):
        return v is None or (isinstance(v, (int, float)) and 0 <= v <= 1)

    metrics = {**saved["ragas"], **{k: saved["retrieval"][k] for k in (
        "hit_at_1", "hit_at_k", "hit_at_k_min", "mrr")}}
    keys_ok = (all(set(saved[k]) == v for k, v in EVAL_REPORT_KEYS.items())
               and saved["n"] == len(rows) == n_rows)
    ok = (keys_ok and all(unit(v) for v in metrics.values())
          and all(saved["retrieval"][k] is not None for k in (
              "hit_at_1", "hit_at_k", "mrr"))
          and saved["retrieval"]["n_scored"] == n_rows
          and saved["ragas"]["answer_similarity"] is not None
          and all(r["retrieved_context"] for r in rows)
          and launches["flash_attention"] > 0
          and launches["paged_attention"] > 0
          and launches["encoder_attention"] > 0)
    rec = {"phase": "eval", "card": card, "rows": n_rows,
           "qa_from_engine": len(from_engine), "answer_tokens": max_tokens,
           "metrics": metrics, "llm_judge": {
               k: saved["llm_judge"][k] for k in ("mean_rating", "rated",
                                                  "total")},
           "retrieval": saved["retrieval"], "keys_ok": keys_ok,
           "run_s": run_s, "launches": launches, "ok": ok}
    emit(rec)
    return rec


def _serve_aiohttp(app):
    """An aiohttp app on 127.0.0.1 in a thread of its own: (base url,
    stop)."""
    import asyncio

    from aiohttp import web

    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    loop.run_until_complete(runner.setup())
    site = web.TCPSite(runner, "127.0.0.1", 0)
    loop.run_until_complete(site.start())
    port = site._server.sockets[0].getsockname()[1]
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()

    def stop():
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=30)
        loop.close()

    return f"http://127.0.0.1:{port}", stop


def _voice_stub():
    """An OpenAI-audio stub on 127.0.0.1: /v1/audio/transcriptions
    answers with the upload's size, /v1/audio/speech with a 24 kHz tone
    of a word's length per word. (base url, stop)."""
    import numpy as np

    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from generativeaiexamples_tpu_torch.streaming.asr import (
        pcm_to_wav_bytes)

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            if self.path.endswith("/transcriptions"):
                out, ctype = json.dumps(
                    {"text": f"heard {len(body)} bytes"}).encode(), \
                    "application/json"
            else:
                n = len(json.loads(body)["input"].split())
                t = np.arange(int(0.05 * max(n, 1) * 24000)) / 24000
                out = pcm_to_wav_bytes(
                    (np.sin(2 * np.pi * 330 * t) * 12000).astype(np.int16),
                    24000)
                ctype = "audio/wav"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()

    def stop():
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)

    return f"http://127.0.0.1:{httpd.server_address[1]}", stop


def phase_ui(card: str, served: ServedEngine, keep: dict,
             device: str = "cuda", max_tokens: int = 16):
    """The playground (ui/server.py, aiohttp) in front of a chain server
    whose LLM decodes greedily (the served 8B engine at temperature 0,
    each call's token ids recorded): one streamed /api/chat with
    use_knowledge_base false, then the same request straight to the
    chain server's /generate; the texts and the token ids must be equal,
    and K1 and K2 must launch. /api/voice, /api/transcribe and
    /api/speech run against stub ASR and TTS servers in this process
    through the HTTP voice clients (the TTS reply resampled from 24 kHz
    to the asked 16 kHz)."""
    import urllib.request as ureq

    import torch

    from generativeaiexamples_tpu_torch.api.server import (
        ChainServer, make_http_server)
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.connectors.local import (
        LocalEngineLLM)
    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.pipelines.base import (
        get_example_class)
    from generativeaiexamples_tpu_torch.pipelines.resources import Resources
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        DeviceVectorStore)
    from generativeaiexamples_tpu_torch.streaming.asr import (
        HTTPASRClient, HTTPTTSClient, pcm_to_wav_bytes, wav_bytes_to_pcm)
    from generativeaiexamples_tpu_torch.ui.chat_client import ChatClient
    from generativeaiexamples_tpu_torch.ui.server import PlaygroundServer

    class Recorder:
        def __init__(self, engine):
            self.engine, self.calls = engine, []

        def generate_stream(self, ids, **kw):
            toks = []
            self.calls.append(toks)
            for ev in self.engine.generate_stream(ids, **kw):
                if ev["token_id"] >= 0:
                    toks.append(ev["token_id"])
                yield ev

    class Greedy(LocalEngineLLM):
        def stream_chat(self, messages, **kw):
            return super().stream_chat(messages, **{**kw,
                                                    "temperature": 0.0})

    emb = keep["emb"]
    config = load_config(env={}, overrides={
        "vector_store": {"name": "tpu"},
        "embeddings": {"dimensions": emb.dim}})
    hub = EngineHub(config, llm=served.engine, embed=emb, rerank=keep["rr"],
                    device=device)
    rec_engine = Recorder(served.engine)
    res = Resources(config, hub=hub, llm=Greedy(
        rec_engine, served.engine.tokenizer),
        store=DeviceVectorStore(emb.dim, device=device))
    app = ChainServer(config, example=get_example_class("developer_rag")(res))
    httpd = make_http_server(app, "127.0.0.1", 0)
    chain = f"http://127.0.0.1:{httpd.server_address[1]}"
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    voice, stop_voice = _voice_stub()
    ui, stop_ui = _serve_aiohttp(PlaygroundServer(
        ChatClient(chain, "llama3-8b"), asr=HTTPASRClient(voice),
        tts=HTTPTTSClient(voice), feedback_path=os.path.join(
            "build", "ui_smoke_feedback.jsonl")).app)
    query = "Name three things a paged KV cache keeps."
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with _post(ui + "/api/chat", {"query": query,
                                      "use_knowledge_base": False,
                                      "max_tokens": max_tokens}) as r:
            ui_frames = [json.loads(ln[6:]) for ln in
                         r.read().decode().split("\n\n")
                         if ln.startswith("data: ")]
        ui_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with _post(chain + "/generate", {
                "messages": [{"role": "user", "content": query}],
                "use_knowledge_base": False,
                "max_tokens": max_tokens}) as r:
            direct = [json.loads(ln[6:])["choices"][0] for ln in
                      r.read().decode().split("\n\n")
                      if ln.startswith("data: ")]
        direct_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _k123()
        with ureq.urlopen(ui + "/api/voice", timeout=60) as r:
            caps = json.loads(r.read())
        tone = (torch.sin(torch.arange(8000) / 9.0) * 9000).to(
            torch.int16).numpy()
        req = ureq.Request(ui + "/api/transcribe",
                           data=pcm_to_wav_bytes(tone, 16000),
                           headers={"Content-Type": "audio/wav"})
        with ureq.urlopen(req, timeout=60) as r:
            heard = json.loads(r.read())
        with _post(ui + "/api/speech", {"text": "a paged cache keeps keys",
                                        "sample_rate": 16000}) as r:
            ctype = r.headers["Content-Type"]
            pcm, rate = wav_bytes_to_pcm(r.read())
    finally:
        stop_ui()
        stop_voice()
        _stop_server(app, httpd, th)
    ui_text = "".join(f.get("content", "") for f in ui_frames)
    direct_text = "".join(c["message"]["content"] for c in direct
                          if c["finish_reason"] != "[DONE]")
    ok = (len(rec_engine.calls) == 2
          and rec_engine.calls[0] == rec_engine.calls[1]
          and 1 <= len(rec_engine.calls[0]) <= max_tokens
          and ui_text == direct_text
          and ui_frames[-1] == {"done": True, "context": []}
          and direct[-1]["finish_reason"] == "[DONE]"
          and launches["flash_attention"] > 0
          and launches["paged_attention"] > 0
          and caps == {"asr": True, "tts": True}
          and heard.get("text", "").startswith("heard ")
          and ctype == "audio/wav" and rate == 16000
          and len(pcm) == int(0.05 * 5 * 24000) * 2 // 3)
    rec = {"phase": "ui", "card": card, "query": query,
           "max_tokens": max_tokens, "token_ids": rec_engine.calls,
           "ui_text": ui_text, "direct_text": direct_text,
           "ui_frames": len(ui_frames), "ui_s": ui_s, "direct_s": direct_s,
           "voice": {"caps": caps, "transcribe": heard,
                     "speech_rate": rate, "speech_samples": len(pcm)},
           "launches": launches, "ok": ok}
    emit(rec)
    return rec


STREAM_FS_AUDIO = 16_000
STREAM_FS_IQ = 250_000
# Paced UDP sends: a slice of IQ bytes, then wait until the ring holds it
# (a loopback socket's default receive buffer, ~208 KB, holds about a
# dozen 8 KB datagrams: each takes more than its payload).
STREAM_UDP_SLICE = 64 << 10
STREAM_UDP_PACKET = 8192
STREAM_TRANSCRIPTS = (
    "breaking news the launch window for the weather satellite opens "
    "tonight at nine",
    "engineers at the pad report that all systems are go for the liftoff "
    "this evening",
    "the harbour pilots expect calm seas and clear skies along the coast "
    "until morning",
    "in sports the home team won the final by two goals after extra time",
)
# (label, question, the intent the scripted classifier gives, the
# recency it gives, the breadcrumb the chain must stream first).
STREAM_QUESTIONS = (
    ("recent", "Summarize what was said in the last 5 minutes.",
     "RecentSummary", (5, "minutes"), "entries from the last 300s"),
    ("past", "What were they talking about 30 seconds ago?",
     "TimeWindow", (30, "seconds"), "entries from 30s ago (+/- 90s)"),
    ("topic", "What did the engineers say about the launch?",
     "SpecificTopic", None, "related entries"),
)


class _StreamLLM:
    """The streaming chain's LLM on the card: the served engine answers
    (greedy, `max_tokens` capped); the intent and recency classifiers
    are scripted, as the JAX tests script them, since random weights
    write no JSON."""

    def __init__(self, engine, max_tokens: int):
        from generativeaiexamples_tpu_torch.connectors.local import (
            LocalEngineLLM)
        from generativeaiexamples_tpu_torch.streaming import prompts

        self.llm = LocalEngineLLM(engine)
        self.max_tokens = max_tokens
        self.prompts = prompts
        self.routes: list = []

    def _scripted(self, messages):
        system = messages[0]["content"] if messages else ""
        question = messages[-1]["content"]
        for label, q, intent, recency, _ in STREAM_QUESTIONS:
            if q != question:
                continue
            if system == self.prompts.INTENT_PROMPT:
                self.routes.append((label, intent))
                return json.dumps({"intentType": intent})
            if system == self.prompts.RECENCY_PROMPT and recency:
                return json.dumps({"timeNum": recency[0],
                                   "timeUnit": recency[1]})
        return None

    def chat(self, messages, **kw):
        out = self._scripted(messages)
        return out if out is not None else "".join(
            self.stream_chat(messages, **kw))

    def stream_chat(self, messages, **kw):
        kw = {**kw, "temperature": 0.0,
              "max_tokens": min(kw.get("max_tokens", self.max_tokens),
                                self.max_tokens)}
        yield from self.llm.stream_chat(messages, **kw)


def _udp_receive(iq: "np.ndarray") -> tuple:
    """Send complex64 IQ over loopback UDP (`replay.udp_send_iq`, one
    64 KB slice a millisecond, from a thread) and receive it through
    `replay.udp_receive_iq` (its socket's receive buffer and the native
    ring): (the samples received, bytes sent, received and lost,
    datagrams, seconds)."""
    import socket

    import numpy as np

    from generativeaiexamples_tpu_torch.streaming import replay

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    step = STREAM_UDP_SLICE // 8
    packets = []

    def send():
        time.sleep(0.5)  # the receiver binds first
        for i in range(0, len(iq), step):
            packets.append(replay.udp_send_iq(
                iq[i:i + step], ("127.0.0.1", port),
                pkt_size=STREAM_UDP_PACKET))
            time.sleep(0.001)

    sender = threading.Thread(target=send, daemon=True)
    sender.start()
    t0 = time.perf_counter()
    try:
        got = replay.udp_receive_iq(port, iq.nbytes, timeout=3.0).copy()
        err = None
    except TimeoutError as e:
        got, err = np.zeros((0,), np.complex64), str(e)
    sender.join(timeout=10)
    return got, {"bytes_sent": iq.nbytes, "packets": sum(packets),
                 "bytes_received": got.nbytes,
                 "bytes_lost": iq.nbytes - got.nbytes, "error": err,
                 "seconds": time.perf_counter() - t0 - 0.5}


def phase_streaming(card: str, served: ServedEngine, keep: dict,
                    device: str = "cuda", audio_s: float = 4.0,
                    max_tokens: int = 16):
    """The fm-asr streaming RAG path (streaming/, native/) on the card:

    (a) `synth_speech_like` (audio_s seconds at 16 kHz) goes through
        `fm_modulate` on `device` to 250 kHz complex64 IQ;
    (b) the IQ goes over loopback UDP, one 64 KB slice a millisecond,
        into `replay.udp_receive_iq` (its socket's 4 MB receive buffer
        and the native SPSC ring: the port's sdr_ring.c, built into
        build/native/; the card's machine must have a C compiler): every
        byte must arrive;
    (c) `FMReceiver.process` on `device`, one 1 s chunk at a time, timed
        warm (DSP ms a chunk: its real-time factor);
    (d) `replay.StreamPump.run_iq` pushes the received chunks through its
        own FMReceiver on `device`, the port's FakeASR (whose PCM is held
        to the port's CPU route within 1 LSB and to the input audio:
        best-lag correlation over 0 to 4 samples above 0.95 on the first
        chunk) and a sink that posts each transcript to the
        StreamingServer's /storeStreamingText; /flush ends the stream.
        The store embeds through the arctic embedder (K3);
    (e) three /generate questions over SSE, on the served 8B engine
        (greedy, max_tokens a call; K1, K2): a recent summary (through
        the chain's summarization when the window holds more than 4
        entries), a past time window (truncated to the closest entries)
        and a topic; the intent and recency classifiers are
        scripted (random weights write no JSON), each answer must stream
        its route's breadcrumb, then text frames, then {"done": true}.

    Prints the DSP ms a chunk, bytes received and lost, transcripts
    and indexed documents, each answer's first-frame ms, and the K1, K2
    and K3 launches of (d)-(e)."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch.connectors.local import (
        LocalEmbedder)
    from generativeaiexamples_tpu_torch.native import ring as native_ring
    from generativeaiexamples_tpu_torch.streaming import dsp, replay
    from generativeaiexamples_tpu_torch.streaming.asr import FakeASR
    from generativeaiexamples_tpu_torch.streaming.server import (
        StreamingServer)
    from generativeaiexamples_tpu_torch import kernels

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    rec: dict = {"phase": "streaming", "card": card, "audio_s": audio_s,
                 "fs_audio": STREAM_FS_AUDIO, "fs_iq": STREAM_FS_IQ}
    audio = replay.synth_speech_like(audio_s, fs=STREAM_FS_AUDIO, seed=0)
    sync()
    t0 = time.perf_counter()
    iq = dsp.fm_modulate(audio, STREAM_FS_AUDIO, STREAM_FS_IQ, device=device)
    sync()
    rec["modulate_s"] = time.perf_counter() - t0
    iq_np = iq.cpu().numpy()
    rec["native_available"] = native_ring.native_available()
    got, rec["udp"] = _udp_receive(iq_np)
    rec["udp"]["iq_equal"] = bool(got.shape == iq_np.shape
                                  and np.array_equal(got, iq_np))
    time_mark("streaming_dsp")

    # The DSP's time a chunk and its PCM against the CPU route, on the
    # received samples.
    chunk = STREAM_FS_IQ
    parts = [torch.from_numpy(got[i:i + chunk].copy())
             for i in range(0, len(got) - chunk + 1, chunk)]
    receiver = dsp.FMReceiver(STREAM_FS_IQ, STREAM_FS_AUDIO, device=device)
    cpu_receiver = dsp.FMReceiver(STREAM_FS_IQ, STREAM_FS_AUDIO,
                                  device="cpu")
    dsp_ms = []
    for part in parts:
        dev_part = part.to(device)
        receiver.process(dev_part)  # the first call's allocations
        sync()
        t0 = time.perf_counter()
        receiver.process(dev_part)
        sync()
        dsp_ms.append(1e3 * (time.perf_counter() - t0))
    time_mark("streaming_receiver")

    llm = _StreamLLM(served.engine, max_tokens)
    srv = StreamingServer(llm, LocalEmbedder(keep["emb"]), chunk_size=128,
                          chunk_overlap=16)
    base, stop = _serve_aiohttp(srv.app)
    pcms = []

    class RecordingASR(FakeASR):
        """The port's FakeASR, keeping the PCM the pump hands it."""

        def transcribe(self, pcm, sample_rate):
            pcms.append(pcm)
            return super().transcribe(pcm, sample_rate)

    asr = RecordingASR(script=list(STREAM_TRANSCRIPTS))
    stores = []

    def store(source_id, text):
        with _post(base + "/storeStreamingText",
                   {"transcript": text, "source_id": source_id}) as r:
            stores.append(json.loads(r.read()))

    pump = replay.StreamPump(asr, store, fs_audio=STREAM_FS_AUDIO,
                             fs_iq=STREAM_FS_IQ, source_id="fm",
                             device=device)
    answers = {}
    try:
        sync()
        kernels.reset_launches()
        # The received IQ through the pump: FMReceiver on `device`, the
        # ASR, /storeStreamingText; then the stream's end.
        delivered = pump.run_iq(got[i:i + chunk]
                                for i in range(0, len(got), chunk))
        with _post(base + "/flush", {"source_id": "fm"}) as r:
            stores.append(json.loads(r.read()))
        rec["ingest"] = {"asr_calls": asr.calls, "delivered": delivered,
                         "stores": stores,
                         "transcripts": len(STREAM_TRANSCRIPTS)
                         - len(asr.script),
                         "indexed_documents": len(srv.accumulator
                                                  .timestamp_db),
                         "store_rows": len(srv.store.store)}
        for label, question, _, _, crumb in STREAM_QUESTIONS:
            tokens0 = served.engine.metrics.snapshot()["tokens_generated"]
            t0 = time.perf_counter()
            first_ms = None
            frames = []
            # The past window truncates to the closest entries; the
            # recent summary summarizes (both of the chain's budgets).
            with _post(base + "/generate", {
                    "question": question,
                    "allow_summary": label != "past"}) as r:
                status = r.status
                buf = b""
                while True:
                    piece = r.read1(65536) if hasattr(r, "read1") \
                        else r.read(65536)
                    if not piece:
                        break
                    if first_ms is None:
                        first_ms = 1e3 * (time.perf_counter() - t0)
                    buf += piece
            frames = [json.loads(ln[6:]) for ln in buf.decode().split("\n\n")
                      if ln.startswith("data: ")]
            text = "".join(f.get("content", "") for f in frames)
            answers[label] = {
                "status": status, "first_frame_ms": first_ms,
                "total_ms": 1e3 * (time.perf_counter() - t0),
                "frames": len(frames), "breadcrumb": crumb in text,
                "done": bool(frames) and frames[-1] == {"done": True},
                "tokens": served.engine.metrics.snapshot()[
                    "tokens_generated"] - tokens0,
                "text_head": text[:160]}
        sync()
        launches = _k123()
    finally:
        stop()
    lsb = [int(np.abs(pcm.astype(np.int32) - cpu_receiver.process(
        part).numpy().astype(np.int32)).max())
        for pcm, part in zip(pcms, parts)]
    n = len(pcms[0]) - 128
    corr = max(float(np.corrcoef(pcms[0][64 + lag:64 + lag + n].astype(
        np.float32), audio[64:64 + n])[0, 1]) for lag in range(5))
    rec["receiver"] = {"chunks": len(pcms), "dsp_ms_per_chunk": dsp_ms,
                       "real_time_factor": max(dsp_ms) / 1e3,
                       "max_lsb_vs_cpu": lsb, "tol_lsb": 1,
                       "audio_corr_best_lag": corr}
    rec["answers"] = answers
    rec["routes"] = llm.routes
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    rec["ok"] = bool(
        rec["native_available"] and rec["udp"]["iq_equal"]
        and rec["udp"]["bytes_lost"] == 0
        and len(pcms) == len(parts) == int(audio_s)
        and all(v <= 1 for v in lsb) and corr > 0.95
        and rec["ingest"]["transcripts"] == len(STREAM_TRANSCRIPTS)
        and rec["ingest"]["indexed_documents"] > 0
        and [r[0] for r in llm.routes] == [q[0] for q in STREAM_QUESTIONS]
        and all(a["status"] == 200 and a["breadcrumb"] and a["done"]
                and a["tokens"] > 0 for a in answers.values())
        and all(launches[k] > 0 for k in K123))
    emit(rec)
    return rec


def phase_train(card: str, params, cfg, keep: dict, device: str = "cuda",
                seq: int = 512, steps: int = 3, lora_rank: int = 8,
                trainer_layers: int = 2, ft_pairs: int = 16,
                ft_len: int = 64):
    """Single-device training (training/{lora,trainer,retriever_ft}.py)
    on the checkpoint phase's bf16 8B weights and phase_rag's arctic
    embedder, all on the differentiable route (plain attention, autograd
    through it):

    (a) LoRA rank 8 on wq and wv over all layers, B=1, S=seq, remat on,
        `steps` steps (lr 1e-3, warmup 1: the first step runs at lr 0).
        The first update must be zero and the later ones not, wq and wv
        bit-equal afterwards and every other base leaf's checksum
        unchanged; the merged model's logits through K1 within
        TRAIN_LOGIT_RTOL of the training route's on the same tokens.
    (b) The full trainer at full width over `trainer_layers` layers (a
        clone of the first layers with the embeddings and head), B=1,
        S=seq, warmup 1, `steps` steps: loss and grad_norm finite.
    (c) The retriever fine-tune at arctic width, `ft_pairs` pairs from
        the RAG corpus, max_len `ft_len`, `steps` steps: the fine-tuned
        encoder's pooled output through K3 within BF16_ATOL of the
        training route's.

    K1 and K3 must raise on a CUDA operand that requires grad. Peak
    memory above the phase's start is printed for each part."""
    import dataclasses

    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.models import bert, llama
    from generativeaiexamples_tpu_torch.ops import attention as attn_ops
    from generativeaiexamples_tpu_torch.ops import encoder_attention as enc
    from generativeaiexamples_tpu_torch.training import (
        lora, retriever_ft, trainer)

    def peak_gb(base):
        return (torch.cuda.max_memory_allocated() - base) / 2**30

    def finite(x):
        return bool(torch.isfinite(torch.as_tensor(x)).all())

    # K1 and K3 have no backward: an operand that requires grad raises.
    q = torch.randn((1, 4, 64, 64), device=device).bfloat16() \
        .requires_grad_(True)
    k = torch.randn((1, 4, 64, 64), device=device).bfloat16()
    refused = {}
    for name, fn in (("flash_attention", attn_ops.flash_attention),
                     ("encoder_attention", enc.encoder_attention)):
        try:
            fn(q, k, k)
            refused[name] = False
        except RuntimeError as e:
            refused[name] = "requires grad" in str(e)
    del q, k
    torch.cuda.synchronize()
    kernels.reset_launches()
    batch = trainer.synthetic_batch(cfg, 1, seq, seed=0, device=device)
    base_mem = torch.cuda.memory_allocated()

    # (a) LoRA.
    time_mark("train_lora")
    torch.cuda.reset_peak_memory_stats()
    lcfg = lora.LoraConfig(rank=lora_rank, targets=("wq", "wv"))
    targets = {n: params["layers"][n].clone() for n in lcfg.targets}

    def checksums():
        """An int64 sum of each base leaf's bits (as int16) a layer."""
        def one(t):
            bits = t.view(torch.int16)
            if t.dim() > 2:
                return bits.flatten(1).sum(1, dtype=torch.int64).tolist()
            return [int(bits.sum(dtype=torch.int64))]

        return {k: one(v) for k, v in params.items()
                if not isinstance(v, dict)} | {
            f"layers.{k}": one(v) for k, v in params["layers"].items()}

    sums = checksums()
    ad = lora.init_lora(cfg, lcfg, torch.Generator(device).manual_seed(0),
                        device=device)
    opt = trainer.make_optimizer(trainer.TrainConfig(learning_rate=1e-3,
                                                     warmup_steps=1))
    step = lora.make_lora_train_step(cfg, lcfg, opt, remat=True)
    state, hist, moved = opt.init(ad), [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        prev = ad
        ad, state, m = step(ad, state, params, batch)
        moved.append(any(not torch.equal(prev[n][x], ad[n][x])
                         for n in ad for x in ("a", "b")))
        hist.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    lora_s = time.perf_counter() - t0
    lora_peak = peak_gb(base_mem)
    with torch.no_grad():
        merged = lora.merge(params, ad, lcfg)
        k1_before = kernels.LAUNCHES["flash_attention"]
        kern, _ = llama.forward(merged, cfg, batch["tokens"])
        k1_merged = kernels.LAUNCHES["flash_attention"] - k1_before
        plain, _ = llama.forward(merged, cfg, batch["tokens"],
                                 attention="plain")
        logit_err = float((kern - plain).abs().max()
                          / plain.abs().max())
    del merged, kern, plain
    base_same = (all(torch.equal(params["layers"][n], targets[n])
                     for n in targets) and checksums() == sums)
    del targets
    lora_ok = (moved[0] is False and all(moved[1:]) and base_same
               and all(finite(h["loss"]) and finite(h["lora_grad_norm"])
                       for h in hist)
               and logit_err <= TRAIN_LOGIT_RTOL
               and k1_merged == cfg.n_layers)
    lora_rec = {"rank": lora_rank, "targets": list(lcfg.targets),
                "steps": hist, "moved": moved, "base_unchanged": base_same,
                "logit_err_rel": logit_err, "tol": TRAIN_LOGIT_RTOL,
                "k1_launches_merged_forward": k1_merged, "s": lora_s,
                "peak_gb": lora_peak, "ok": lora_ok}

    # (b) The full trainer over a clone of the first layers.
    time_mark("train_full")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg2 = dataclasses.replace(cfg, n_layers=trainer_layers)
    small = {**{k: v for k, v in params.items() if k != "layers"},
             "layers": {k: v[:trainer_layers].clone()
                        for k, v in params["layers"].items()}}
    tcfg = trainer.TrainConfig(learning_rate=1e-5, warmup_steps=1)
    topt = trainer.make_optimizer(tcfg)
    tstep = trainer.make_train_step(cfg2, tcfg, topt)
    tstate, thist = topt.init(small), []
    t0 = time.perf_counter()
    for _ in range(steps):
        small, tstate, m = tstep(small, tstate, batch)
        thist.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    full_peak = peak_gb(base_mem)
    del small, tstate
    full_ok = all(finite(h["loss"]) and finite(h["grad_norm"])
                  for h in thist)
    full_rec = {"layers": trainer_layers, "steps": thist, "s": full_s,
                "peak_gb": full_peak, "ok": full_ok}

    # (c) The retriever fine-tune.
    time_mark("train_retriever")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    emb = keep["emb"]
    paras = _rag_corpus(6, 40).split("\n\n")[:ft_pairs]
    pairs = [(" ".join(p.split()[:8]), p) for p in paras]
    fhist = []
    t0 = time.perf_counter()
    tuned = retriever_ft.finetune(
        emb.params, emb.cfg, emb.tokenizer, pairs, epochs=steps,
        batch_size=ft_pairs, ft=retriever_ft.RetrieverFTConfig(
            learning_rate=1e-4), log=fhist.append, device=device)
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t0
    ft_peak = peak_gb(base_mem)
    b = retriever_ft.tokenize_pairs(emb.tokenizer, pairs, ft_len,
                                    device=device)
    with torch.no_grad():
        k3_before = kernels.LAUNCHES["encoder_attention"]
        _, via_k3 = bert.forward(tuned, emb.cfg, b["p_tokens"],
                                 lengths=b["p_lengths"])
        k3_tuned = kernels.LAUNCHES["encoder_attention"] - k3_before
        _, via_plain = bert.forward(tuned, emb.cfg, b["p_tokens"],
                                    lengths=b["p_lengths"],
                                    attention="plain")
        pooled_err = float((via_k3.float() - via_plain.float()).abs().max())
        changed = not torch.equal(tuned["tok_emb"], emb.params["tok_emb"])
    del tuned
    ft_ok = (len(fhist) == steps and all(finite(h["loss"]) for h in fhist)
             and pooled_err <= BF16_ATOL and changed
             and k3_tuned == emb.cfg.n_layers)
    ft_rec = {"pairs": ft_pairs, "max_len": ft_len, "steps": fhist,
              "pooled_err": pooled_err, "tol": BF16_ATOL,
              "k3_launches_tuned_forward": k3_tuned, "s": ft_s,
              "peak_gb": ft_peak, "ok": ft_ok}
    launches = _k123()
    gc.collect()
    torch.cuda.empty_cache()
    ok = lora_ok and full_ok and ft_ok and all(refused.values())
    rec = {"phase": "train", "card": card, "seq": seq, "batch": 1,
           "refuse_grad": refused, "lora": lora_rec, "full": full_rec,
           "retriever_ft": ft_rec, "launches": launches, "ok": ok}
    emit(rec)
    return rec


# -- phase 15: serve from disk (checkpoints, tokenizer gate, store) ---------

# Where the phase writes its snapshots (inside the ignored build/), and
# removes them when it ends.
CHECKPOINT_DIR = os.path.join("build", "checkpoint_smoke")
# HF names of a Llama layer's tensors, and whether ours is the transpose
# (HF linears are [out, in], the port's [in, out]). Written out here, not
# taken from the loader, so the snapshot is independent of what reads it.
HF_LLAMA_LAYER = (("ln1", "input_layernorm.weight", False),
                  ("ln2", "post_attention_layernorm.weight", False),
                  ("wq", "self_attn.q_proj.weight", True),
                  ("wk", "self_attn.k_proj.weight", True),
                  ("wv", "self_attn.v_proj.weight", True),
                  ("wo", "self_attn.o_proj.weight", True),
                  ("w_gate", "mlp.gate_proj.weight", True),
                  ("w_up", "mlp.up_proj.weight", True),
                  ("w_down", "mlp.down_proj.weight", True))
HF_BERT_LAYER = (("wq", "attention.self.query.weight", True),
                 ("bq", "attention.self.query.bias", False),
                 ("wk", "attention.self.key.weight", True),
                 ("bk", "attention.self.key.bias", False),
                 ("wv", "attention.self.value.weight", True),
                 ("bv", "attention.self.value.bias", False),
                 ("wo", "attention.output.dense.weight", True),
                 ("bo", "attention.output.dense.bias", False),
                 ("ln1_w", "attention.output.LayerNorm.weight", False),
                 ("ln1_b", "attention.output.LayerNorm.bias", False),
                 ("w_in", "intermediate.dense.weight", True),
                 ("b_in", "intermediate.dense.bias", False),
                 ("w_out", "output.dense.weight", True),
                 ("b_out", "output.dense.bias", False),
                 ("ln2_w", "output.LayerNorm.weight", False),
                 ("ln2_b", "output.LayerNorm.bias", False))


def _write_safetensors(path, entries) -> int:
    """A .safetensors file of (name, tensor) entries, each tensor copied
    to the host in turn (bf16 as its 16-bit patterns); the header padded
    to 8 bytes, as the HF writer does. Returns the data bytes."""
    import torch

    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, off = {}, 0
    for name, t in entries:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)) + blob)
        for _, t in entries:
            host = t.contiguous().cpu()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.int16)
            fh.write(host.numpy().data)
    return off


def _write_snapshot(path, entries, config, n_shards=1) -> int:
    """An HF snapshot directory: config.json, the entries over `n_shards`
    files of about equal bytes and, when sharded, the
    model.safetensors.index.json naming each tensor's file."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(config, fh, indent=1)
    sizes = [t.numel() * t.element_size() for _, t in entries]
    total, shards, acc = sum(sizes), [[] for _ in range(n_shards)], 0
    for entry, n in zip(entries, sizes):
        shards[min(n_shards - 1, acc * n_shards // total)].append(entry)
        acc += n
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = (f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
                 if n_shards > 1 else "model.safetensors")
        _write_safetensors(os.path.join(path, fname), shard)
        weight_map.update({name: fname for name, _ in shard})
    if n_shards > 1:
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as fh:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, fh, indent=1)
    return total


def _llama_snapshot_entries(params, cfg):
    """The served Llama tree under HF LlamaForCausalLM names and layouts
    (views on the device; written one at a time)."""
    entries = [("model.embed_tokens.weight", params["tok_emb"]),
               ("model.norm.weight", params["ln_f"])]
    for i in range(cfg.n_layers):
        for leaf, name, transpose in HF_LLAMA_LAYER:
            w = params["layers"][leaf][i]
            entries.append((f"model.layers.{i}.{name}",
                            w.t() if transpose else w))
    if not cfg.tie_embeddings:
        entries.append(("lm_head.weight", params["lm_head"].t()))
    return entries


def _llama_hf_config(cfg) -> dict:
    import torch

    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "intermediate_size": cfg.mlp_dim, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_eps,
            "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": cfg.tie_embeddings,
            "torch_dtype": str(cfg.dtype).replace("torch.", "")
            if cfg.dtype != torch.float32 else "float32"}


def _bert_snapshot(params, cfg, prefixed: bool):
    """(entries, config.json) of an encoder engine's tree (fused QKV split
    back into HF's query, key and value) under HF BERT names: bare, as
    BertModel saves them, or under `bert.` with the pooler and the
    classifier, as BertForSequenceClassification does."""
    lw, D = params["layers"], cfg.dim
    split = {"wq": lw["wqkv"][..., :D], "wk": lw["wqkv"][..., D:2 * D],
             "wv": lw["wqkv"][..., 2 * D:], "bq": lw["bqkv"][..., :D],
             "bk": lw["bqkv"][..., D:2 * D], "bv": lw["bqkv"][..., 2 * D:]}
    pre = "bert." if prefixed else ""
    entries = [(pre + "embeddings.word_embeddings.weight", params["tok_emb"]),
               (pre + "embeddings.position_embeddings.weight",
                params["pos_emb"]),
               (pre + "embeddings.token_type_embeddings.weight",
                params["type_emb"]),
               (pre + "embeddings.LayerNorm.weight", params["emb_ln"]["w"]),
               (pre + "embeddings.LayerNorm.bias", params["emb_ln"]["b"])]
    for i in range(cfg.n_layers):
        for leaf, name, transpose in HF_BERT_LAYER:
            w = (split[leaf] if leaf in split else lw[leaf])[i]
            entries.append((f"{pre}encoder.layer.{i}.{name}",
                            w.t() if transpose else w))
    if cfg.n_labels:
        c = params["classifier"]
        entries += [(pre + "pooler.dense.weight", c["pool_w"].t()),
                    (pre + "pooler.dense.bias", c["pool_b"]),
                    ("classifier.weight", c["w"].t()),
                    ("classifier.bias", c["b"])]
    config = {"model_type": "bert", "vocab_size": cfg.vocab_size,
              "hidden_size": D, "num_hidden_layers": cfg.n_layers,
              "num_attention_heads": cfg.n_heads,
              "intermediate_size": cfg.mlp_dim,
              "max_position_embeddings": cfg.max_position,
              "type_vocab_size": cfg.type_vocab_size,
              "layer_norm_eps": cfg.ln_eps}
    return entries, config


def _bits_equal(a, b) -> bool:
    """Equal shape, dtype and bits (a float compare would take -0 for 0)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    raw = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
           torch.float32: torch.int32}.get(a.dtype)
    return bool(torch.equal(a.view(raw), b.view(raw)) if raw
                else torch.equal(a, b))


def _tree_mismatches(got, want, path="") -> list:
    """Paths of the leaves (codes and scales of a QuantizedTensor) that
    differ in keys, shape, dtype or bits."""
    from generativeaiexamples_tpu_torch.ops.quant import QuantizedTensor

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [path or "/"]
        return [m for k in sorted(want)
                for m in _tree_mismatches(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, QuantizedTensor):
        if not isinstance(got, QuantizedTensor):
            return [path]
        return [p for p, a, b in ((path + ".q", got.q, want.q),
                                  (path + ".s", got.s, want.s))
                if not _bits_equal(a, b)]
    return [] if _bits_equal(got, want) else [path]


def _tree_bytes(tree) -> int:
    from generativeaiexamples_tpu_torch.ops.quant import QuantizedTensor

    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, QuantizedTensor):
        return tree.q.nbytes + tree.s.nbytes
    return tree.nbytes


def _checkpoint_prompts(vocab: int):
    """Four token-id prompts of 20-100 ids (seed 9)."""
    import numpy as np

    rng = np.random.default_rng(9)
    return [rng.integers(0, min(vocab, 128000), n).tolist()
            for n in rng.integers(20, 101, 4)]


def checkpoint_streams(served: ServedEngine, max_tokens: int = 32):
    """Token streams of the checkpoint prompts through `served`'s OpenAI
    server: one streaming chat completion, then four concurrent greedy
    completions admitted as ONE prefill group (the scheduler is stopped
    until all four wait, so two engines see the same batch shapes and
    their bf16 results can be compared bit for bit)."""
    engine, app = served.engine, served.app
    app.streams.clear()
    chat = _stream_chat(served.base, 32)
    (chat_tokens,) = app.streams.values()
    prompts = _checkpoint_prompts(engine.cfg.vocab_size)
    engine.stop()
    results = [None] * len(prompts)

    def run(i):
        results[i] = _complete(served.base, prompts[i], max_tokens)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + 60
    while len(engine.waiting) < len(prompts) \
            and time.perf_counter() < deadline:
        time.sleep(0.01)
    grouped = len(engine.waiting) == len(prompts)
    t0 = time.perf_counter()
    engine.start()
    for t in threads:
        t.join(timeout=600)
    return {"chat": chat, "chat_tokens": chat_tokens, "grouped": grouped,
            "completions": results, "prompts": prompts,
            "completions_wall_s": time.perf_counter() - t0,
            "tokens": [app.streams.get(tuple(p)) for p in prompts]}


def _pdf_bytes(pages, image: bytes = b"") -> bytes:
    """A minimal PDF, one FlateDecode content stream a page. A page is a
    line of text, or a list of raw content operations (bytes). `image`,
    when given, is embedded as one DCTDecode image object."""
    import zlib

    out = (b"%PDF-1.4\n1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\n"
           b"endobj\n2 0 obj\n<< /Type /Pages /Kids ["
           + b" ".join(b"%d 0 R" % (3 + 2 * i) for i in range(len(pages)))
           + b"] /Count %d >>\nendobj\n" % len(pages))
    for i, page in enumerate(pages):
        num = 3 + 2 * i
        content = zlib.compress(
            b"BT /F1 12 Tf 72 720 Td (" + page.encode() + b") Tj ET"
            if isinstance(page, str) else b"\n".join(page))
        out += (b"%d 0 obj\n<< /Type /Page /Parent 2 0 R /Contents %d 0 R "
                b">>\nendobj\n%d 0 obj\n<< /Length %d /Filter /FlateDecode "
                b">>\nstream\n" % (num, num + 1, num + 1, len(content))
                + content + b"\nendstream\nendobj\n")
    if image:
        out += (b"%d 0 obj\n<< /Subtype /Image /Filter /DCTDecode /Width 2 "
                b"/Height 2 /Length %d >>\nstream\n"
                % (3 + 2 * len(pages), len(image))
                + image + b"\nendstream\nendobj\n")
    return out + b"trailer\n<< /Root 1 0 R >>\n%%EOF"


CHECKPOINT_PDF = ("Pager spill files hold demoted KV pages on disk.",
                  "Promotion scatters the pages back in one copy.")
CHECKPOINT_HTML = ("<html><head><style>p {margin: 0}</style><script>var "
                   "hidden = 1;</script></head><body><h1>Tokenizer gate</h1>"
                   "<p>A weights-only snapshot falls back to bytes only "
                   "when asked.</p></body></html>")


def _loaded(load):
    """Run `load()` with the device's peak memory counter reset: (result,
    seconds, peak bytes allocated above what was allocated before)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = load()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() - base


def _largest_layer_bytes(params) -> int:
    """One layer of the largest stacked leaf (in the model dtype): what a
    streaming load may hold beside the tree."""
    return max(v.shape[1:].numel() * v.element_size()
               for v in params["layers"].values())


def _quantizers_match_numpy(device) -> dict:
    """quantize_tensor (per output column) and quantize_kv (per row) on
    the card against the JAX package's arithmetic in numpy (f32 divide,
    round half to even) on seeded values of mixed magnitude (`match`);
    and how many of those values' quotients by 127 differ between a
    division by a host scalar and `div127`'s by a device tensor."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch.ops.quant import (
        div127, quantize_tensor)
    from generativeaiexamples_tpu_torch.serving.paged_attention_int8 import (
        quantize_kv)

    g = torch.Generator(device=device).manual_seed(13)
    w = torch.randn((1024, 4096), generator=g, device=device) \
        * torch.rand((1, 4096), generator=g, device=device)
    wf = w.cpu().numpy()

    def ref(axis):
        amax = np.abs(wf).max(axis=axis, keepdims=True)
        s = np.maximum(amax / np.float32(127), np.float32(1e-8))
        return np.clip(np.round(wf / s), -127, 127).astype(np.int8), \
            np.squeeze(s, axis)

    qt = quantize_tensor(w)
    kq, ks = quantize_kv(w)
    (q0, s0), (q1, s1) = ref(0), ref(-1)
    match = bool(np.array_equal(qt.q.cpu().numpy(), q0)
                 and np.array_equal(qt.s.cpu().numpy(), s0)
                 and np.array_equal(kq.cpu().numpy(), q1)
                 and np.array_equal(ks.cpu().numpy(), s1))
    return {"match": match, "values": w.numel(),
            "host_scalar_div_differs": int((w / 127.0 != div127(w)).sum())}


def _checkpoint_chain(engine, emb, rr, keep, root, device):
    """The chain over the loaded engines with a persisted store: PDF and
    HTML uploads through /documents, a search returning every stored
    chunk with its file, the store's directory reloaded; then the RAG
    phase's 2,001-chunk store saved, reloaded into a fresh store and
    searched with the RAG phase's queries (equal ids and scores)."""
    import numpy as np

    from generativeaiexamples_tpu_torch.api.server import (
        ChainServer, make_http_server)
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.rag.documents import load_document
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        DeviceVectorStore)

    chain_dir = os.path.join(root, "chain_store")
    config = load_config(env={}, overrides={
        "vector_store": {"name": "tpu", "persist_dir": chain_dir},
        "reranker": {"enabled": True},
        "embeddings": {"dimensions": emb.dim}})
    hub = EngineHub(config, llm=engine, embed=emb, rerank=rr, device=device)
    app = ChainServer(config, hub=hub, upload_dir=os.path.join(root, "up"))
    httpd = make_http_server(app, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    files = {"ckpt.pdf": _pdf_bytes(CHECKPOINT_PDF),
             "ckpt.html": CHECKPOINT_HTML.encode()}
    try:
        uploads = {}
        for name, data in files.items():
            uploads[name] = _upload(base, name, data,
                                    timeout=300).get("message", "")
        store, splitter = app.example.res.store, app.example.res.splitter
        n = len(store)
        with _post(base + "/search", {"query": CHECKPOINT_PDF[0],
                                      "top_k": max(n, 1)}) as r:
            chunks = json.loads(r.read())["chunks"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        app.close()
    # The chunks each file's extraction gives (on the card's machine HTML
    # goes through the standard-library parser; the log says which).
    want = {}
    for name, data in files.items():
        path = os.path.join(root, "extract_" + name)
        with open(path, "wb") as fh:
            fh.write(data)
        want[name] = sorted(c for d in load_document(path, name)
                            for c in splitter.split(d.text))
    found = {name: sorted(c["content"] for c in chunks
                          if c["filename"] == name) for name in files}
    reopened = DeviceVectorStore(emb.dim, device=device,
                                 persist_dir=chain_dir)
    chain_ok = (all(m.endswith("uploaded successfully")
                    for m in uploads.values())
                and n == 3 and found == want
                and all(found[f] for f in files)
                and reopened.list_documents() == sorted(files)
                and len(reopened) == n)

    # The RAG phase's ingested store: save, reload, same hits.
    src = keep["store"]
    store_dir = os.path.join(root, "rag_store")
    t0 = time.perf_counter()
    src.save(store_dir)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh = DeviceVectorStore.load(store_dir, src.dim, device=device)
    load_s = time.perf_counter() - t0
    qv = np.stack([keep["emb"].embed_query(q) for q in keep["queries"]])
    a = src.search_batch(qv, top_k=10)
    b = fresh.search_batch(qv, top_k=10)
    same_ids = [[h.text for h in x] for x in a] == \
        [[h.text for h in x] for x in b]
    same_scores = [[h.score for h in x] for x in a] == \
        [[h.score for h in x] for x in b]
    store_rec = {"chunks": len(src), "reloaded": len(fresh),
                 "bytes_on_disk": sum(
                     os.path.getsize(os.path.join(store_dir, f))
                     for f in os.listdir(store_dir)),
                 "save_s": save_s, "load_s": load_s,
                 "queries": len(keep["queries"]), "same_ids": same_ids,
                 "same_scores": same_scores}
    del fresh, reopened
    return {"uploads": uploads, "chunks_stored": n,
            "search_found": {f: len(v) for f, v in found.items()},
            "documents_reopened": sorted(files), "chain_ok": chain_ok,
            "rag_store": store_rec,
            "ok": chain_ok and same_ids and same_scores
            and len(src) == store_rec["reloaded"]}


def phase_checkpoint(card: str, src_params, src_cfg, ref: dict, keep: dict,
                     device: str = "cuda", engine_cfg=None,
                     int8_cfg=None, int8_pages: int = 1025,
                     n_requests: int = 32, max_tokens: int = 16,
                     tp_kw=None) -> dict:
    """Serve from disk. The served bf16 8B engine's own weights
    (`src_params`, kept when its engine went) are written as an HF
    snapshot (four shards, an index, config.json at the published
    widths) and the RAG phase's encoders as two BERT snapshots, under the
    ignored build/ (free disk checked first), all removed at the end.
    Then, each loaded model freed before the next:

    - the tokenizer gate: `load_tokenizer` on the weights-only 8B
      snapshot must raise unless GAIE_BYTE_TOKENIZER_FALLBACK=1 (set for
      the rest of the phase, as these snapshots have no tokenizer);
    - encoders: `load_bert` trees bit-identical to the in-memory
      encoders', then `build_encoders` from the two paths: embeddings
      and scores of a few texts bit-identical to the in-memory ones;
      K3 must launch;
    - bf16: `load_llama(device="cuda")` (time, GB/s, peak device memory
      against the tree's bytes) bit-identical leaf by leaf; then
      `build_engine(weights_path=...)` behind the OpenAI server: its
      streaming chat and four concurrent 32-token greedy completions
      must equal the served engine's tokens (`ref`); K1 and K2 must
      launch; the chain over it: PDF and HTML through /documents into a
      persisted store, and the RAG store saved and reloaded;
    - int8: `load_llama(quantize=True)` (peak device memory at most the
      int8 tree plus one bf16 layer of the largest leaf), codes and
      scales bit-identical to the loader's quantizer applied on the card
      to the source bf16 weights, layer 0 of each int8 leaf also to the
      JAX loader's numpy arithmetic (and `quantize_tensor` /
      `quantize_kv` to the JAX package's, on seeded values); then the
      int8 deployment built from the path serves `n_requests`
      concurrent completions: K6 and K4 must launch, K2 not."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.models import bert as bert_lib
    from generativeaiexamples_tpu_torch.models.hf_loader import (
        load_bert, load_llama)
    from generativeaiexamples_tpu_torch.ops.quant import (
        LLAMA_QUANT_KEYS, quantize_for_load)
    from generativeaiexamples_tpu_torch.serving.__main__ import (
        build_encoders, build_engine)
    from generativeaiexamples_tpu_torch.utils.tokenizer import (
        ByteTokenizer, load_tokenizer)

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        CHECKPOINT_DIR)
    llm_dir = os.path.join(root, "llama")
    emb_dir, rr_dir = os.path.join(root, "embed"), os.path.join(root, "rerank")
    emb_src, rr_src = keep["emb"], keep["rr"]
    llm_entries = _llama_snapshot_entries(src_params, src_cfg)
    tree_bytes = sum(t.numel() * t.element_size() for _, t in llm_entries)
    need = tree_bytes + 2 * _tree_bytes(emb_src.params) \
        + 2 * _tree_bytes(rr_src.params) + (1 << 30)
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < need:
        raise RuntimeError(f"checkpoint phase: {free / 1e9:.2f} GB free "
                           f"under {root}, {need / 1e9:.2f} GB needed")
    launches = {}
    old_env = os.environ.pop("GAIE_BYTE_TOKENIZER_FALLBACK", None)
    rec = {"phase": "checkpoint", "card": card, "disk_free_gb": free / 1e9}
    # phase_tp's ranks start now, their start-up behind this phase's work.
    tp_ranks = tp_spawn((tp_kw or {}).get("device", "cuda:0"))
    try:
        t0 = time.perf_counter()
        _write_snapshot(llm_dir, llm_entries, _llama_hf_config(src_cfg),
                        n_shards=4)
        write_s = time.perf_counter() - t0
        del llm_entries
        for path, src, prefixed in ((emb_dir, emb_src, False),
                                    (rr_dir, rr_src, True)):
            entries, config = _bert_snapshot(src.params, src.cfg, prefixed)
            _write_snapshot(path, entries, config)
        rec["write"] = {"llm_bytes": tree_bytes, "llm_s": write_s,
                        "llm_gb_per_s": tree_bytes / write_s / 1e9,
                        "files": sorted(os.listdir(llm_dir))}

        # The tokenizer gate on the weights-only 8B snapshot.
        try:
            load_tokenizer(llm_dir)
            gate_raised = False
        except FileNotFoundError:
            gate_raised = True
        os.environ["GAIE_BYTE_TOKENIZER_FALLBACK"] = "1"
        rec["tokenizer_gate"] = {
            "raised_without_fallback": gate_raised,
            "byte_with_fallback": isinstance(load_tokenizer(llm_dir),
                                             ByteTokenizer)}

        # Encoders.
        loaded_e, _ = load_bert(emb_dir, dtype=emb_src.cfg.dtype,
                                device=device)
        loaded_r, _ = load_bert(rr_dir, n_labels=1, dtype=rr_src.cfg.dtype,
                                device=device)
        enc_mismatch = (
            _tree_mismatches(bert_lib.fuse_qkv_params(loaded_e),
                             emb_src.params, "embed")
            + _tree_mismatches(bert_lib.fuse_qkv_params(loaded_r),
                               rr_src.params, "rerank"))
        del loaded_e, loaded_r
        emb, rr = build_encoders(device, embed_path=emb_dir,
                                 rerank_path=rr_dir)
        texts = list(keep["queries"]) + list(CHECKPOINT_PDF)
        torch.cuda.synchronize()
        kernels.reset_launches()
        got_e = emb.embed(texts)
        got_s = rr.score(keep["queries"][0], texts)
        torch.cuda.synchronize()
        launches["encoders"] = dict(kernels.LAUNCHES)
        same_e = np.array_equal(got_e, emb_src.embed(texts))
        same_s = np.array_equal(got_s, rr_src.score(keep["queries"][0],
                                                    texts))
        enc_ok = (not enc_mismatch and same_e and same_s
                  and launches["encoders"]["encoder_attention"] > 0)
        rec["encoders"] = {"mismatched_leaves": enc_mismatch,
                           "embed_shape": list(got_e.shape),
                           "embeddings_bit_identical": same_e,
                           "scores_bit_identical": same_s}

        # bf16: the load measured, then the engine built from the path.
        params, load_s, peak = _loaded(
            lambda: load_llama(llm_dir, device=device,
                               dtype=src_cfg.dtype)[0])
        mismatch = _tree_mismatches(params, src_params)
        loaded_bytes = _tree_bytes(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        rec["bf16"] = {"load_s": load_s,
                       "read_gb_per_s": loaded_bytes / load_s / 1e9,
                       "tree_bytes": loaded_bytes, "peak_bytes": peak,
                       "peak_over_tree_bytes": peak - loaded_bytes,
                       "mismatched_leaves": mismatch}
        t0 = time.perf_counter()
        served = ServedEngine(engine=build_engine(
            device=device, warmup=False, engine_cfg=engine_cfg,
            weights_path=llm_dir), warmup_buckets=[128])
        rec["bf16"]["engine_build_s"] = time.perf_counter() - t0
        try:
            torch.cuda.synchronize()
            kernels.reset_launches()
            got = checkpoint_streams(served)
            torch.cuda.synchronize()
            launches["bf16"] = dict(kernels.LAUNCHES)
            chain = _checkpoint_chain(served.engine, emb, rr, keep, root,
                                      device)
        finally:
            served.close()
        streams_equal = (got["chat_tokens"] == ref["chat_tokens"]
                         and got["tokens"] == ref["tokens"]
                         and all(t for t in ref["tokens"]))
        rec["bf16"].update({
            "grouped": [ref["grouped"], got["grouped"]],
            "chat_tokens": len(got["chat_tokens"]),
            "completion_tokens": [len(t or []) for t in got["tokens"]],
            "streams_equal_served": streams_equal})
        rec["chain"] = chain
        del served, emb, rr
        gc.collect()
        torch.cuda.empty_cache()

        # int8: the load measured, then the deployment from the path.
        qparams, qload_s, qpeak = _loaded(
            lambda: load_llama(llm_dir, device=device, dtype=src_cfg.dtype,
                               quantize=True)[0])
        int8_bytes = _tree_bytes(qparams)
        allowance = _largest_layer_bytes(src_params)
        qmismatch, host_checked = [], []
        for key in LLAMA_QUANT_KEYS:
            w = src_params["layers"][key]
            for layer in range(w.shape[0]):
                want = quantize_for_load(w[layer])
                got_q = qparams["layers"][key][layer]
                if not (_bits_equal(got_q.q, want.q)
                        and _bits_equal(got_q.s, want.s)):
                    qmismatch.append(f"{key}[{layer}]")
            # The JAX loader's numpy arithmetic on layer 0, on the host.
            af = w[0].float().cpu().numpy()
            amax = np.abs(af).max(axis=-2, keepdims=True).clip(1e-8)
            s = (amax / 127.0).astype(np.float32)
            q = np.clip(np.round(af / s), -127, 127).astype(np.int8)
            got_q = qparams["layers"][key][0]
            host_checked.append(key)
            if not (np.array_equal(got_q.q.cpu().numpy(), q)
                    and np.array_equal(got_q.s.cpu().numpy(), s[0])):
                qmismatch.append(f"{key}[0] vs numpy")
        if "lm_head" in src_params:
            want = quantize_for_load(src_params["lm_head"])
            if not (_bits_equal(qparams["lm_head"].q, want.q)
                    and _bits_equal(qparams["lm_head"].s, want.s)):
                qmismatch.append("lm_head")
            del want
        qmismatch += [p for p in _tree_mismatches(
            {k: qparams[k] for k in ("tok_emb", "ln_f")},
            {k: src_params[k] for k in ("tok_emb", "ln_f")})]
        qmismatch += _tree_mismatches(
            {k: qparams["layers"][k] for k in ("ln1", "ln2")},
            {k: src_params["layers"][k] for k in ("ln1", "ln2")})
        # qparams stays for phase_tp: the codes the ranks' shards slice.
        rec["int8"] = {"load_s": qload_s,
                       "read_gb_per_s": tree_bytes / qload_s / 1e9,
                       "int8_tree_bytes": int8_bytes, "peak_bytes": qpeak,
                       "allowance_bytes": allowance,
                       "peak_within": qpeak <= int8_bytes + allowance,
                       "host_checked_layer0": host_checked,
                       "mismatched": qmismatch,
                       "quantizers_vs_numpy":
                       _quantizers_match_numpy(device)}
        ecfg = {**(int8_cfg or INT8_DEPLOYMENT)}
        served = ServedEngine(engine=build_engine(
            device=device, warmup=False, engine_cfg=ecfg,
            n_pages=int8_pages, weights_path=llm_dir),
            warmup_buckets=[128])
        try:
            prompts = _int8_prompts(n_requests)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            results = _burst(served.base, prompts, max_tokens)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches["int8"] = dict(kernels.LAUNCHES)
            # The int8 engine's grouped checkpoint completions: what the
            # tensor-parallel int8 ranks are held against.
            int8_ref = checkpoint_streams(served, max_tokens=32)
        finally:
            served.close()
        tokens = sum(r["completion_tokens"] for r in results if r)
        int8_served_ok = all(
            r is not None and r["finish_reason"] in ("length", "stop")
            and r["completion_tokens"] >= 1 for r in results)
        rec["int8"].update({"requests": n_requests, "completion_tokens":
                            tokens, "wall_s": wall,
                            "tokens_per_s": tokens / wall if wall else None,
                            "served_ok": int8_served_ok})
        del served
        gc.collect()
        torch.cuda.empty_cache()
        # Tensor parallelism over the same snapshot, while it is on disk.
        tp = phase_tp(card, llm_dir, src_cfg, ref, src_params, qparams,
                      int8_ref, ranks=tp_ranks, **(tp_kw or {}))
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        tp_kill(tp_ranks)
        shutil.rmtree(root, ignore_errors=True)
        if old_env is None:
            os.environ.pop("GAIE_BYTE_TOKENIZER_FALLBACK", None)
        else:
            os.environ["GAIE_BYTE_TOKENIZER_FALLBACK"] = old_env
    total = {name: sum(v.get(name, 0) for v in launches.values())
             for name in kernels.SIGNATURES}
    ok = (rec["tokenizer_gate"]["raised_without_fallback"]
          and rec["tokenizer_gate"]["byte_with_fallback"]
          and enc_ok and not mismatch and streams_equal
          and ref["grouped"] and got["grouped"]
          and launches["bf16"]["flash_attention"] > 0
          and launches["bf16"]["paged_attention"] > 0
          and chain["ok"] and not qmismatch
          and rec["int8"]["quantizers_vs_numpy"]["match"]
          and rec["int8"]["peak_within"] and int8_served_ok
          and launches["int8"]["int8_matmul"] > 0
          and launches["int8"]["paged_attention_int8"] > 0
          and launches["int8"]["paged_attention"] == 0)
    rec.update({"launches": total, "launches_by_model": launches,
                "snapshot_removed": not os.path.exists(root),
                "seconds": time.perf_counter() - t_phase, "ok": ok,
                "tp_seconds": tp["seconds"]})
    emit(rec)
    rec["tp"] = tp
    return rec


# -- tensor-parallel serving over two rank processes ------------------------

# The rank engines: the prefix cache and the KV pager on, with a tree of
# at most 2% of the pool (5 pages) and one host page record, so the
# finished prompts' pages demote to the host and the spill and a session
# request promotes them back.
TP_ENGINE = {"page_size": 16, "max_batch_size": 4, "max_seq_len": 1024,
             "prefill_buckets": [128], "prefix_cache": True,
             "kv_pager": True, "prefix_cache_capacity": 0.02,
             "kv_host_budget_mb": 1, "multihost": True}
TP_INT8 = {"quantize_weights": "int8", "kv_dtype": "int8"}
# The rank engines' teacher-forced logits (the prefill's last position,
# then TP_TEACHER_STEPS decode steps over the pool, every rank fed the
# single-device engine's tokens) against the single-device engine's, as
# a share of the largest |logit|: each all-reduce rounds a bf16 sum of
# two partial products where one GEMM rounds once, layer after layer.
TP_LOGIT_RTOL = 5e-2
TP_TEACHER_STEPS = 2
TP_RANK_TIMEOUT_S = 600


def _teacher_forced(engine, prompts, forced, steps, leader=True):
    """Teacher-forced logits of `engine`'s own serving path: each prompt
    alone (slot 0 of an idle engine), its sampler calls (the prefill's,
    then each decode step's) answered with forced[i][k] instead of a
    draw, the logits row of the first steps + 1 calls recorded. A
    follower rank (leader=False) replays the leader's records under the
    same forcing. Returns [len(prompts), steps + 1, V] f32 (leader)."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch.serving import engine_model as em
    from generativeaiexamples_tpu_torch.serving.multihost import (
        run_follower)

    real_prefill, real_sample = em.prefill_batch_step, em.sample
    at = {"req": -1, "k": 0}
    rows = [[] for _ in prompts]

    def prefill(*a, **kw):
        at["req"], at["k"] = at["req"] + 1, 0
        return real_prefill(*a, **kw)

    def sample(logits, *a, **kw):
        j, k = at["req"], at["k"]
        at["k"] += 1
        if leader and k <= steps:
            rows[j].append(logits[0].float().cpu().numpy())
        tok = forced[j][min(k, len(forced[j]) - 1)]
        return torch.full((logits.shape[0],), tok, dtype=torch.int32,
                          device=logits.device)

    em.prefill_batch_step, em.sample = prefill, sample
    try:
        if not leader:
            run_follower(engine, timeout_s=TP_RANK_TIMEOUT_S)
            return None
        engine.start()
        for p in prompts:
            list(engine.generate_stream(p, max_new_tokens=steps + 1,
                                        temperature=0.0))
        engine.stop()
    finally:
        em.prefill_batch_step, em.sample = real_prefill, real_sample
    if any(len(r) != steps + 1 for r in rows):
        raise RuntimeError(f"teacher-forced run recorded "
                           f"{[len(r) for r in rows]} logits rows, not "
                           f"{steps + 1} a prompt")
    return np.stack([np.stack(r) for r in rows])


def _tp_swap_kv_heads(params, head_dim: int):
    """A planted fault: `params` with the k and v projections of its
    first two kv heads swapped, so the pool holds each head's k/v in the
    other's place (the teacher-forced gate must see it); a shard of one
    kv head swaps its k and v instead."""
    import torch

    from generativeaiexamples_tpu_torch.ops.quant import QuantizedTensor

    def swap(t):
        idx = torch.arange(t.shape[-1], device=t.device)
        idx[:2 * head_dim] = torch.cat([idx[head_dim:2 * head_dim],
                                        idx[:head_dim]])
        return t.index_select(t.dim() - 1, idx)

    def swapped(w):
        return (QuantizedTensor(swap(w.q), swap(w.s))
                if isinstance(w, QuantizedTensor) else swap(w))

    layers = dict(params["layers"])
    if layers["wk"].shape[-1] >= 2 * head_dim:
        layers["wk"], layers["wv"] = (swapped(layers["wk"]),
                                      swapped(layers["wv"]))
    else:
        layers["wk"], layers["wv"] = layers["wv"], layers["wk"]
    return {**params, "layers": layers}


def _tp_teacher_ecfg(ecfg, multihost: bool) -> dict:
    """The teacher-forced engines' config: the leg's, without the prefix
    cache (every prompt prefills whole) and with one decode block of
    TP_TEACHER_STEPS steps a request."""
    return {**ecfg, "prefix_cache": False, "kv_pager": False,
            "multihost": multihost,
            "decode_steps_per_dispatch": TP_TEACHER_STEPS}


def _tp_leaves(params) -> dict:
    """path -> tensor of a (quantized) tree's int8 leaves (.q and .s)."""
    from generativeaiexamples_tpu_torch.ops.quant import QuantizedTensor

    out = {}
    for key, leaf in params.items():
        for k, v in (leaf.items() if key == "layers" else [(None, leaf)]):
            if isinstance(v, QuantizedTensor):
                name = f"{key}.{k}" if k else key
                out[name + ".q"], out[name + ".s"] = v.q, v.s
    return out


def _tp_leader_run(engine, prompts, max_tokens, session) -> dict:
    """Rank 0: the four completions behind the OpenAI server, held until
    all four wait so they prefill as one group (the same batch shapes in
    every run), then the session request (the first prompt continued by
    the second: a prefix-cache hit on pages the pager demoted); stop()
    publishes the stop record."""
    from generativeaiexamples_tpu_torch.serving.openai_server import (
        make_http_server)

    engine.start()
    app = _recording_server(engine)
    httpd = make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    held, grouped = threading.Event(), {}

    def hold():
        held.set()
        deadline = time.perf_counter() + 60
        while len(engine.waiting) < len(prompts) \
                and time.perf_counter() < deadline:
            time.sleep(0.002)
        grouped["ok"] = len(engine.waiting) == len(prompts)

    holder = threading.Thread(target=engine.run_control_op,
                              args=(hold, 120))
    holder.start()
    held.wait(60)
    results = [None] * len(prompts)

    def run(i):
        results[i] = _complete(base, prompts[i], max_tokens)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    holder.join(timeout=60)
    rec = {"grouped": grouped.get("ok", False), "wall_s": wall,
           "completion_tokens": [r and r["completion_tokens"]
                                 for r in results],
           "tokens": [app.streams.get(tuple(p)) for p in prompts]}
    if session:
        # Two sessions: the first resumes the second prompt (its insert
        # trims the tree, demoting the other prompts' pages), the second
        # resumes the first prompt, whose pages come back from the host
        # or the spill.
        before = engine.metrics.snapshot()
        sess = [_complete(base, prompts[i] + prompts[j], 8)
                for i, j in ((1, 2), (0, 3))]
        after = engine.metrics.snapshot()
        rec["session"] = {k: after[k] - before[k] for k in (
            "prefix_hits", "prefix_hit_tokens", "kv_demotions",
            "kv_promotions")}
        rec["session"]["completion_tokens"] = [
            r["completion_tokens"] for r in sess]
        # The disagg export of the longest prompt's cached pages: every
        # rank's kv heads gathered into whole pages (a demoted tail
        # through the cold_out record), dequantized to f32 for the
        # parent's reference.
        ids = max(prompts, key=len)
        n_cold = engine.run_control_op(
            lambda: len(engine._cached_page_runs(ids)[1]))
        got = engine.run_control_op(lambda: engine.export_prefix_pages(ids))
        if got is None:
            rec["kv_export"] = {"ids": ids, "pages": None}
        else:
            codes, scales, n_tok = got
            pages = codes.float()
            if scales is not None:
                pages = pages * scales[..., None]
            rec["kv_export"] = {"ids": ids, "n_tokens": n_tok,
                                "cold_pages": n_cold,
                                "pages": pages.numpy()}
    httpd.shutdown()
    httpd.server_close()
    engine.stop()  # the final digest and the stop record
    m = engine.metrics.snapshot()
    rec["metrics"] = {k: m[k] for k in (
        "decode_steps", "prefill_tokens", "prefix_hits", "kv_demotions",
        "kv_promotions", "kv_spill_writes", "multihost_processes",
        "replay_records_published", "replay_divergence")}
    return rec


def _tp_rank_main(rank, coordinator, device, cmds, out) -> None:
    """One rank process of phase_tp (spawned; both ranks on `device`):
    the launcher's rank path, driven by (kind, args) commands until
    None."""
    import traceback

    import torch

    try:
        from generativeaiexamples_tpu_torch import kernels
        from generativeaiexamples_tpu_torch.config.schema import MeshConfig
        from generativeaiexamples_tpu_torch.parallel import mesh as mesh_lib
        from generativeaiexamples_tpu_torch.serving.__main__ import (
            build_engine)
        from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
        from generativeaiexamples_tpu_torch.serving.multihost import (
            run_follower)

        torch.backends.cuda.matmul.allow_tf32 = False
        devices = [device, device]
        cuda = torch.device(device).type == "cuda"

        def sync():
            if cuda:
                torch.cuda.synchronize()

        mesh_lib.init_ranks(coordinator, 2, rank, devices)
        mesh = mesh_lib.build_mesh(MeshConfig(ici_tensor=2), devices)
        engine = None
        while True:
            cmd = cmds.get()
            if cmd is None:
                break
            kind, arg = cmd
            rep: dict = {"backend": mesh.backend}
            if kind == "load":
                # The parent's environment as of this load (the ranks may
                # have started before it set the tokenizer fallback).
                os.environ.update(arg["env"])
                engine = None
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                sync()
                t0 = time.perf_counter()
                engine = build_engine(warmup=False, engine_cfg=arg["ecfg"],
                                      weights_path=arg["path"], mesh=mesh)
                sync()
                rep["load_s"] = time.perf_counter() - t0
                rep["peak_bytes"] = (torch.cuda.max_memory_allocated()
                                     if cuda else 0)
                rep["shard_bytes"] = _tree_bytes(engine.params)
                if arg["share"]:
                    rep["leaves"] = _tp_leaves(engine.params)
                    out.put((rank, kind, rep))
                    cmds.get()  # the parent compared them
                    continue
            elif kind == "teacher":
                params = engine.params
                if arg["fault"] and rank == 1:
                    params = _tp_swap_kv_heads(params, engine.cfg.head_dim)
                eng = LLMEngine(params, engine.model_cfg, engine.tokenizer,
                                arg["ecfg"], mesh=mesh)
                rep["logits"] = _teacher_forced(
                    eng, arg["prompts"], arg["forced"], TP_TEACHER_STEPS,
                    leader=rank == 0)
                del eng, params
            elif kind == "serve":
                if arg["first"]:
                    eng = engine.warmup(buckets=[128])
                else:
                    # A second engine over the same shards: this process
                    # already ran every shape it launches.
                    eng = LLMEngine(engine.params, engine.model_cfg,
                                    engine.tokenizer, arg["ecfg"], mesh=mesh)
                mesh_lib.COLLECTIVE_TIMING = arg["timing"]
                mesh_lib.reset_collective_stats()
                sync()
                kernels.reset_launches()
                if rank == 0:
                    rep.update(_tp_leader_run(eng, arg["prompts"],
                                              arg["max_tokens"],
                                              arg["session"]))
                else:
                    rep["replayed"] = run_follower(
                        eng, timeout_s=TP_RANK_TIMEOUT_S)
                    eng.stop()
                    rep["consumed"] = eng._mh_log.consumed
                    rep["metrics"] = {
                        k: eng.metrics.snapshot()[k] for k in (
                            "multihost_processes", "replay_divergence")}
                sync()
                rep["launches"] = dict(kernels.LAUNCHES)
                rep["collectives"] = dict(mesh_lib.COLLECTIVE_STATS)
                mesh_lib.COLLECTIVE_TIMING = False
                del eng
            elif kind == "spec":
                # A new engine over the loaded (int8) shards.
                eng = LLMEngine(engine.params, engine.model_cfg,
                                engine.tokenizer, arg["ecfg"], mesh=mesh)
                plans = _count_plans(eng)
                mesh_lib.COLLECTIVE_TIMING = arg["timing"]
                mesh_lib.reset_collective_stats()
                sync()
                kernels.reset_launches()
                if rank == 0:
                    rep.update(_tp_spec_run(eng, arg["prompts"], arg["long"],
                                            arg["max_tokens"]))
                else:
                    rep["replayed"] = run_follower(
                        eng, timeout_s=TP_RANK_TIMEOUT_S)
                    eng.stop()
                    rep["consumed"] = eng._mh_log.consumed
                    rep["metrics"] = {
                        k: eng.metrics.snapshot()[k] for k in (
                            "multihost_processes", "replay_divergence")}
                sync()
                rep["launches"] = dict(kernels.LAUNCHES)
                rep["collectives"] = dict(mesh_lib.COLLECTIVE_STATS)
                rep["plans"] = dict(plans)
                rep["state"] = _spec_state(eng)
                mesh_lib.COLLECTIVE_TIMING = False
                _release_engine(eng)
                del eng
            elif kind == "warm":
                rep.update(_train_warmup(device))
            elif kind == "train":
                engine = None
                rep.update(_train_rank_leg(rank, mesh_lib, device,
                                           arg["leg"], arg["dims"]))
            out.put((rank, kind, rep))
        engine = None
        mesh_lib.shutdown()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()[-4000:]))
        raise


def tp_spawn(device: str = "cuda:0"):
    """Start phase_tp's two rank processes (`spawn`) on `device`; they
    join their process group and wait for commands, so their start-up
    (interpreter, torch, the card, the group) can overlap other work.
    Returns (procs, cmds, out) for phase_tp."""
    import torch.multiprocessing as tmp

    from generativeaiexamples_tpu_torch.serving.__main__ import (
        free_coordinator)

    ctx = tmp.get_context("spawn")
    cmds, out = [ctx.Queue(), ctx.Queue()], ctx.Queue()
    coordinator = free_coordinator()
    procs = [ctx.Process(target=_tp_rank_main, name=f"tp-rank{r}",
                         args=(r, coordinator, device, cmds[r], out))
             for r in range(2)]
    for p in procs:
        p.start()
    return procs, cmds, out


def tp_kill(ranks) -> None:
    """Kill phase_tp's rank processes that are still alive."""
    for p in ranks[0]:
        if p.is_alive():
            p.kill()
            p.join()


def _tp_ask(procs, cmds, out, kind, arg, timeout_s=TP_RANK_TIMEOUT_S):
    """Send (kind, arg) to both ranks; their replies by rank
    (`_tp_replies`)."""
    for q in cmds:
        q.put((kind, arg))
    return _tp_replies(procs, out, kind, timeout_s)


def _tp_replies(procs, out, kind, timeout_s=TP_RANK_TIMEOUT_S):
    """Both ranks' replies to a (kind, ...) command already sent, by
    rank. A rank that dies, reports an error or runs past the limit
    fails the call."""
    import queue

    got = {}
    deadline = time.perf_counter() + timeout_s
    while len(got) < 2:
        try:
            rank, what, rep = out.get(timeout=1.0)
        except queue.Empty:
            dead = [p.name for p in procs if not p.is_alive()]
            if dead or time.perf_counter() > deadline:
                raise RuntimeError(f"phase_tp {kind}: ranks {dead} dead or "
                                   f"past {timeout_s} s")
            continue
        if what == "error":
            raise RuntimeError(f"phase_tp rank {rank} failed:\n{rep}")
        got[rank] = rep
    return got


def _tp_check_export(kv: dict, tree, cfg, device) -> dict:
    """A rank engine's exported pages ([n, 2, L, KH, ps, Hd] f32, whole
    pages) against the k/v the single-device forward writes for the same
    tokens, as a share of the largest |k|, |v| (TP_LOGIT_RTOL)."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch.models import llama

    pages = kv.pop("pages")
    if pages is None:
        return {**kv, "ok": False}
    n, _, L, KH, ps, Hd = pages.shape
    cache = llama.KVCache.zeros(cfg, 1, max_len=n * ps, device=device)
    with torch.no_grad():
        llama.forward(tree, cfg, torch.tensor([kv["ids"][:n * ps]],
                                              device=device),
                      kv_cache=cache)
    want = torch.stack([cache.k[:, 0], cache.v[:, 0]]).reshape(
        2, L, KH, n, ps, Hd).permute(3, 0, 1, 2, 4, 5).float().cpu().numpy()
    err = float(np.abs(pages - want).max())
    scale = float(np.abs(want).max())
    return {"pages": n, "kv_heads": KH, "n_tokens": kv["n_tokens"],
            "cold_pages": kv["cold_pages"], "max_abs_err": err,
            "max_abs_ref": scale, "rtol": TP_LOGIT_RTOL,
            "ok": KH == cfg.n_kv_heads and err <= TP_LOGIT_RTOL * scale}


def _tp_share(got, want) -> dict:
    """Greedy tokens of the rank engine equal to the single-device
    engine's: the share, and the first divergence (prompt, position)."""
    same = total = 0
    first = None
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g or [], w or []
        total += max(len(g), len(w))
        for j, (a, b) in enumerate(zip(g, w)):
            if a != b:
                first = first or [i, j]
                break
            same += 1
        if first is None and len(g) != len(w):
            first = [i, min(len(g), len(w))]
    return {"equal_share": same / total if total else None,
            "first_divergence": first}


# The speculative leg of phase_tp: the int8 leg's shards under tree
# speculation (k = 3, M = 4) with composed step plans and the fused
# rider, at batch 8 without the prefix cache. The four checkpoint prompts
# and a TP_SPEC_LONG-token prompt are admitted in one pass, so the long
# prompt's 128-token chunks ride the verify steps; then a sampled request
# runs the plain fallback alone.
TP_SPEC = {**TP_INT8, "speculative_k": 3, "speculative_tree_branches": 4,
           "step_plans": True, "fused_prefill": True, "max_batch_size": 8,
           "prefix_cache": False, "kv_pager": False}
TP_SPEC_LONG = 512
TP_SPEC_LONG_TOKENS = 4
TP_SPEC_SAMPLED_TOKENS = 4


def _plan_kind(plan) -> str:
    """A StepPlan's lattice point by name."""
    if not plan.decode_k:
        return "chunk_sample" if plan.rider_sample else "chunk"
    rider = "+rider" if plan.rider_width else ""
    if plan.spec_k:
        return ("tree" if plan.tree_branches > 1 else "linear") + rider
    return "fallback" if plan.spec_state else "decode" + rider


def _count_plans(engine) -> dict:
    """Count the plans `engine` runs (a leader) or replays (a follower)
    by lattice point: the returned dict fills as it runs."""
    from collections import Counter

    from generativeaiexamples_tpu_torch.serving import engine_model as em

    counts = Counter()
    run = engine._exec_plan

    def counted(rec):
        counts[_plan_kind(em.plan_from_record(rec))] += 1
        return run(rec)

    engine._exec_plan = counted
    return counts


def _spec_state(engine) -> dict:
    """A speculative engine's replicated device state: the token chain,
    the draft history and the device lengths (host copies)."""
    return {name: getattr(engine, attr).cpu().numpy() for name, attr in (
        ("last_tokens", "_last_tokens"), ("history", "_history"),
        ("dev_lengths", "_dev_lengths"))}


def _tp_spec_run(engine, prompts, long_prompt, max_tokens) -> dict:
    """The speculative leg's traffic on `engine` (rank 0's, or one
    device's), started here and stopped at the end: the prompts (greedy,
    max_tokens) and the long prompt (greedy, TP_SPEC_LONG_TOKENS) held
    until all wait, so one pass admits them (the prompts prefill as one
    group, the long one chunks beside their verify steps); then, alone,
    a sampled request (temperature 0.8) that runs the plain fallback on
    the generator's draws."""
    from generativeaiexamples_tpu_torch.serving.engine import GenRequest

    engine.start()
    todo = [(list(p), max_tokens) for p in prompts] + [
        (list(long_prompt), TP_SPEC_LONG_TOKENS)]
    held, grouped = threading.Event(), {}

    def hold():
        held.set()
        deadline = time.perf_counter() + 60
        while len(engine.waiting) < len(todo) \
                and time.perf_counter() < deadline:
            time.sleep(0.002)
        grouped["ok"] = len(engine.waiting) == len(todo)

    holder = threading.Thread(target=engine.run_control_op,
                              args=(hold, 120))
    holder.start()
    held.wait(60)
    t0 = time.perf_counter()
    reqs = [engine.submit(GenRequest(prompt_ids=p, max_new_tokens=n))
            for p, n in todo]
    got = [_collect_req(r) for r in reqs]
    wall = time.perf_counter() - t0
    holder.join(timeout=60)
    sampled = engine.submit(GenRequest(
        prompt_ids=list(prompts[0]), max_new_tokens=TP_SPEC_SAMPLED_TOKENS,
        temperature=0.8))
    s_toks, s_finish, _ = _collect_req(sampled)
    engine.stop()  # the final digest and the stop record
    m = engine.metrics.snapshot()
    return {"grouped": grouped.get("ok", False), "wall_s": wall,
            "tokens": [g[0] for g in got], "finish": [g[1] for g in got],
            "sampled": s_toks, "sampled_finish": s_finish,
            "metrics": {k: m[k] for k in (
                "decode_steps", "prefill_tokens", "fused_steps",
                "fused_prefill_tokens", "spec_slot_steps",
                "spec_fallback_steps", "spec_committed",
                "spec_tokens_per_step", "multihost_processes",
                "replay_records_published", "replay_divergence")}}


def _tp_spec_leg(ranks, ecfg, int8_params, cfg, tokenizer, prompts,
                 n_tokens, n_long, device) -> dict:
    """phase_tp's speculative leg (TP_SPEC over the int8 leg's shards,
    no new load): a single-device engine of the same config runs the
    same traffic first (the share of equal tokens is a finding), then
    the ranks twice, each run a new engine (A; B, the second engine,
    with the collectives timed). Gates: each rank launches K1 (the
    prefill group and the riders), K4 (the tree verify, the fallback's
    decode) and K6, and neither K2 nor K5; the plans replayed equal the
    plans run, tree verify with a rider and the fallback among them;
    every record read, no divergence; the token chain, history and
    device lengths equal across the ranks; run B's tokens, the sampled
    stream's included, bit-identical to run A's."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine

    procs, cmds, out = ranks
    long_prompt = np.random.default_rng(19).integers(
        0, min(cfg.vocab_size, 128000), n_long).tolist()
    single = LLMEngine(int8_params, cfg, tokenizer,
                       {**ecfg, "multihost": False}, device=device)
    one = _tp_spec_run(single, prompts, long_prompt, n_tokens)
    _release_engine(single)
    del single
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    runs = {run: _tp_ask(procs, cmds, out, "spec", {
        "ecfg": ecfg, "timing": timing, "prompts": prompts,
        "long": long_prompt, "max_tokens": n_tokens})
        for run, timing in (("A", False), ("B", True))}
    a0, b0 = runs["A"][0], runs["B"][0]
    m = a0["metrics"]
    launches = {r: {run: runs[run][r]["launches"] for run in runs}
                for r in (0, 1)}
    launch_ok = all(
        launches[r]["A"][k] > 0 for r in (0, 1)
        for k in ("flash_attention", "paged_attention_int8",
                  "int8_matmul")) and all(
        launches[r]["A"][k] == 0 for r in (0, 1)
        for k in ("paged_attention", "paged_attention_tree")) and all(
        launches[r]["A"]["paged_attention_int8"]
        >= cfg.n_layers * m["decode_steps"] for r in (0, 1))
    replay_ok = all(
        runs[run][0]["metrics"]["replay_records_published"]
        == runs[run][1]["consumed"] > 0
        and runs[run][0]["metrics"]["replay_divergence"] == 0
        and runs[run][1]["metrics"]["replay_divergence"] == 0
        and runs[run][1]["metrics"]["multihost_processes"] == 2
        for run in runs)
    state_equal = {run: {k: bool(np.array_equal(v, runs[run][1]["state"][k]))
                         for k, v in runs[run][0]["state"].items()}
                   for run in runs}
    plans = {run: {r: runs[run][r]["plans"] for r in (0, 1)} for run in runs}
    plans_ok = all(p[0] == p[1] for p in plans.values()) and all(
        plans["A"][0].get(k, 0) > 0 for k in ("tree+rider", "fallback"))
    coll_b = b0["collectives"]
    steps_b = b0["metrics"]["decode_steps"]
    n_tok = sum(len(t) for t in a0["tokens"])
    lrec = {
        "engine": ecfg, "long_prompt_tokens": n_long,
        "grouped": [r[0]["grouped"] for r in runs.values()],
        "finish": a0["finish"], "sampled_tokens": len(a0["sampled"]),
        "metrics": m, "plans_by_kind": plans,
        "vs_single_device": _tp_share(a0["tokens"], one["tokens"]),
        "sampled_equal_single_device": a0["sampled"] == one["sampled"],
        "single_device_metrics": one["metrics"],
        "tokens_per_s": n_tok / a0["wall_s"],
        "single_device_tokens_per_s": (sum(len(t) for t in one["tokens"])
                                       / one["wall_s"]),
        "tokens_equal_second_run": (b0["tokens"] == a0["tokens"]
                                    and b0["sampled"] == a0["sampled"]),
        "state_equal_across_ranks": state_equal,
        "replay": {run: {"published": runs[run][0]["metrics"][
            "replay_records_published"], "read_by_rank1": runs[run][1][
            "consumed"], "dispatches_replayed": runs[run][1]["replayed"]}
            for run in runs},
        "launches": launches, "collectives_run_A": a0["collectives"],
        "collectives_run_B_timed": coll_b,
        "collectives_per_decode_step": (
            (coll_b["all_reduce"] + coll_b["all_gather"]) / steps_b
            if steps_b else None),
        "collective_ms_per_decode_step": (1e3 * coll_b["seconds"] / steps_b
                                          if steps_b else None),
        "launch_ok": launch_ok, "replay_ok": replay_ok, "plans_ok": plans_ok}
    lrec["ok"] = (launch_ok and replay_ok and plans_ok
                  and all(lrec["grouped"])
                  and all(all(v.values()) for v in state_equal.values())
                  and lrec["tokens_equal_second_run"]
                  and all(t for t in a0["tokens"]) and a0["sampled"]
                  and m["fused_steps"] > 0 and m["spec_slot_steps"] > 0
                  and m["spec_fallback_steps"] > 0)
    return lrec


# The training legs on phase_tp's two rank processes (cuda:0 each): the
# Llama-3-8B width at TRAIN_RANKS_LAYERS layers, batch x seq tokens. The
# bytes gloo moves through host memory a step (bf16): the FSDP leg
# gathers every leaf (each rank's half of ~2.94 GB) and all-reduces
# every gradient whole (~2.94 GB; gloo has no reduce-scatter); the
# pipeline leg sums the embedding's and the head's gradients over the two
# stages (~2.1 GB) and sends 2 x (n_micro + 1) activations of
# [mb, seq, 4096] each way; the tensor leg all-reduces [batch, seq, 4096]
# activations (4 a layer forward, as many again recomputed and backward)
# and gathers [batch, seq, 64128] f32 logits (~0.13 GB a rank); the
# sequence leg (each rank half of the sequence, attention a ring over it)
# all-reduces every gradient whole (~2.94 GB, as FSDP's: no leaf is
# sharded on "sequence") and hops each layer's stacked [2, batch, 8,
# seq / 2, 128] K/V once forward, once recomputed and once backward.
TRAIN_RANKS_LAYERS = 2
TRAIN_RANKS_BATCH = 2
TRAIN_RANKS_SEQ = 256
TRAIN_RANKS_MICRO = 2
# A sharded step against the one-device step, both bf16: each gradient
# leaf's largest difference within TRAIN_RANKS_RTOL of the reference
# leaf's largest magnitude; the loss and the grad norm within
# TRAIN_RANKS_LOSS_RTOL. The updated parameters: AdamW's first step moves
# each element by lr x sign(g) (|g| >> eps), so where a near-zero
# gradient's sign differs the two steps part by 2 lr; each element within
# 2 lr plus one bf16 ulp of the leaf's largest magnitude, and at least
# TRAIN_RANKS_SAME_SHARE of all elements within lr / 2 (a step that moved
# nothing, or by another gradient, fails both).
TRAIN_RANKS_RTOL = 5e-2
TRAIN_RANKS_LOSS_RTOL = 1e-2
TRAIN_RANKS_LR = 1e-3
TRAIN_RANKS_SAME_SHARE = 0.9
# Ring attention at 8B's attention shape over the 2-way sequence axis:
# the forward at RING_SEQ (each rank's half of the queries against the
# plain attention, in RING_REF_ROWS-query blocks), gradients at
# RING_GRAD_SEQ.
RING_SEQ = 8192
RING_GRAD_SEQ = 2048
RING_REF_ROWS = 2048


TRAIN_RANKS_DIMS = {"model": "8b", "layers": TRAIN_RANKS_LAYERS,
                    "batch": TRAIN_RANKS_BATCH, "seq": TRAIN_RANKS_SEQ,
                    "n_micro": TRAIN_RANKS_MICRO, "ring_seq": RING_SEQ,
                    "ring_grad_seq": RING_GRAD_SEQ,
                    "ring_ref_rows": RING_REF_ROWS,
                    "ring_heads": (32, 8, 128)}


def _train_ranks_cfg(dims):
    import dataclasses

    from generativeaiexamples_tpu_torch.models import llama

    base = (llama.LlamaConfig.llama3_8b() if dims["model"] == "8b"
            else llama.LlamaConfig.tiny())
    return dataclasses.replace(base, n_layers=dims["layers"])


class _CudaMem:
    """Peak device bytes above a start point (zeros off CUDA)."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def start(self):
        self.sync()
        if not self.cuda:
            return 0
        self.torch.cuda.reset_peak_memory_stats()
        return self.torch.cuda.memory_allocated()

    def peak_gb(self, base):
        self.sync()
        if not self.cuda:
            return 0.0
        return (self.torch.cuda.max_memory_allocated() - base) / 2**30


def _ring_leg(rank, mesh_lib, device, dims) -> dict:
    """Ring attention over the 2-way sequence axis (bf16 q, k, v at
    B=1, H=32, KH=8, D=128, from seed 0 on both ranks) against the plain
    attention (`mha_reference`) on one device: each rank checks its half
    of the gathered output, then the gradients of out.float().sum() at
    RING_GRAD_SEQ."""
    import torch

    from generativeaiexamples_tpu_torch.config.schema import MeshConfig
    from generativeaiexamples_tpu_torch.ops.attention import mha_reference
    from generativeaiexamples_tpu_torch.ops.ring_attention import (
        ring_attention_sharded)

    mesh = mesh_lib.build_mesh(MeshConfig(ici_sequence=2, ici_tensor=1),
                               [device, device])
    H, KH, D = dims["ring_heads"]
    seq, rows_n = dims["ring_seq"], dims["ring_ref_rows"]
    mem = _CudaMem(device)

    def qkv(S, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        shapes = ((1, H, S, D), (1, KH, S, D), (1, KH, S, D))
        return [torch.randn(s, generator=g, device=device).to(torch.bfloat16)
                for s in shapes]

    rep: dict = {"S": seq, "grad_S": dims["ring_grad_seq"], "ranks": 2,
                 "B_H_KH_D": [1, H, KH, D], "tol": BF16_ATOL}
    q, k, v = qkv(seq, 0)
    base = mem.start()
    mesh_lib.reset_collective_stats()
    mesh_lib.COLLECTIVE_TIMING = True
    t0 = time.perf_counter()
    out = ring_attention_sharded(q, k, v, mesh)
    mem.sync()
    rep["ring_s"] = time.perf_counter() - t0
    mesh_lib.COLLECTIVE_TIMING = False
    rep["collectives"] = dict(mesh_lib.COLLECTIVE_STATS)
    rep["collective_ms"] = 1e3 * rep["collectives"]["seconds"]
    rep["peak_gb_above_start"] = mem.peak_gb(base)
    half = seq // 2
    err = 0.0
    t0 = time.perf_counter()
    for r0 in range(rank * half, (rank + 1) * half, rows_n):
        rows = slice(r0, r0 + rows_n)
        ref = mha_reference(q[:, :, rows], k[:, :, :r0 + rows_n],
                            v[:, :, :r0 + rows_n], causal=True,
                            q_offset=torch.full((1,), r0, device=device))
        err = max(err, float((out[:, :, rows].float()
                              - ref.float()).abs().max()))
    mem.sync()
    rep["plain_half_s"] = time.perf_counter() - t0
    rep["max_abs_err"] = err
    del out, q, k, v
    q, k, v = (t.requires_grad_(True) for t in qkv(dims["ring_grad_seq"], 1))
    with torch.enable_grad():
        g_ring = torch.autograd.grad(
            ring_attention_sharded(q, k, v, mesh).float().sum(), (q, k, v))
        g_ref = torch.autograd.grad(
            mha_reference(q, k, v, causal=True).float().sum(), (q, k, v))
    rep["grad_rel_err"] = [
        float((a.float() - b.float()).abs().max()
              / b.float().abs().max()) for a, b in zip(g_ring, g_ref)]
    rep["ok"] = bool(err <= BF16_ATOL and max(rep["grad_rel_err"])
                     <= TRAIN_RANKS_RTOL)
    return rep


def _shard_errs(got_leaves, ref_leaves, specs, mesh) -> list:
    """Each leaf's largest |shard - the reference's slice| over the
    reference leaf's largest magnitude."""
    from generativeaiexamples_tpu_torch.serving.sharding import shard_slices

    out = []
    for g, r, s in zip(got_leaves, ref_leaves, specs):
        ref = r[shard_slices(r.shape, s, mesh)]
        # In the leaves' dtype: a difference of two close bf16 values is
        # exact, and no f32 copy of a 1 GB leaf is made.
        out.append(float((g - ref).abs().max())
                   / max(float(ref.abs().max()), 1e-30))
    return out


def _param_errs(got_leaves, ref_leaves, specs, mesh, lr) -> dict:
    """Updated shards against the one-device update: the largest
    difference over (2 lr + one bf16 ulp of the leaf's largest
    magnitude), worst leaf, and the share of elements within lr / 2."""
    import torch

    from generativeaiexamples_tpu_torch.serving.sharding import shard_slices

    worst, close, total = 0.0, 0, 0
    for g, r, s in zip(got_leaves, ref_leaves, specs):
        ref = r[shard_slices(r.shape, s, mesh)]
        diff = (g - ref).abs()
        allowed = 2 * lr + float(ref.abs().max()) * 2.0 ** -7
        worst = max(worst, float(diff.max()) / allowed)
        # count_nonzero widens to int64: a whole 8B embedding's mask
        # would take 3.9 GB, so count in slices of <= 2^26 elements.
        rows = max(1, 2 ** 26 // max(1, diff[0].numel())) \
            if diff.dim() else 1
        close += sum(int(torch.count_nonzero(part <= lr / 2))
                     for part in (diff.split(rows) if diff.dim()
                                  else (diff,)))
        total += diff.numel()
    return {"worst_over_allowed": worst, "share_within_half_lr":
            close / total}


def _step_leg(rank, mesh_lib, device, leg: str, dims) -> dict:
    """One sharded train step (bf16, Llama-3-8B width, remat) at fsdp 2,
    tensor 2, pipeline 2 or sequence 2 against the one-device step on
    the same weights (seed 0 on both ranks) and batch: the loss, the grad
    norm, every gradient and every updated leaf (each rank's shards)."""
    import torch

    from generativeaiexamples_tpu_torch.config.schema import MeshConfig
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.parallel import pipeline as pp
    from generativeaiexamples_tpu_torch.training import trainer

    cfg = _train_ranks_cfg(dims)
    mem = _CudaMem(device)
    tcfg = trainer.TrainConfig(learning_rate=TRAIN_RANKS_LR, warmup_steps=0,
                               remat=True)
    part_s = {}
    t0 = time.perf_counter()
    params = llama.init_params(cfg, device)
    batch = trainer.synthetic_batch(cfg, dims["batch"], dims["seq"],
                                    seed=0, device=device)
    opt = trainer.make_optimizer(tcfg)
    mem.sync()
    part_s["init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # The one-device step: loss and gradients first, then the update.
    ref_loss, ref_grads = trainer.value_and_grad(
        lambda p: trainer.loss_fn(p, cfg, batch["tokens"], batch["targets"],
                                  batch["mask"], remat=True), params)
    ref_norm = trainer.global_norm(ref_grads)
    ref_new, _ = opt.update(ref_grads, opt.init(params), params)
    ref_new = trainer.tree_leaves(ref_new)
    mem.sync()
    part_s["one_device_step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = mesh_lib.build_mesh(MeshConfig(**{
        "fsdp": dict(ici_fsdp=2, ici_tensor=1),
        "tensor": dict(ici_tensor=2),
        "pipeline": dict(dcn_pipeline=2, ici_tensor=1),
        "sequence": dict(ici_sequence=2, ici_tensor=1)}[leg]),
        [device, device])
    if leg == "pipeline":
        local, state, specs = pp.shard_pp_train_state(params, cfg, opt, mesh)

        def loss_of(p):
            return pp.pipeline_loss(p, cfg, batch["tokens"],
                                    batch["targets"], batch["mask"],
                                    mesh=mesh, n_micro=dims["n_micro"],
                                    remat=True)
    else:
        local, state, specs = trainer.shard_train_state(params, cfg, opt,
                                                        mesh)

        def loss_of(p):
            return trainer.loss_fn(p, cfg, batch["tokens"],
                                   batch["targets"], batch["mask"],
                                   remat=True, mesh=mesh)
    leaf_specs = trainer.aligned_specs(specs, local)
    full_gb = 3 * sum(t.numel() * t.element_size()
                      for t in trainer.tree_leaves(params)) / 2**30
    del params  # the shards are copies; the references are ref_*
    mem.sync()
    part_s["shard"] = time.perf_counter() - t0
    shard_bytes = sum(t.numel() * t.element_size()
                      for t in trainer.tree_leaves(local)
                      + state["mu"] + state["nu"])
    base = mem.start()
    mesh_lib.reset_collective_stats()
    mesh_lib.COLLECTIVE_TIMING = True
    t0 = time.perf_counter()
    with mesh_lib.active(mesh):
        loss, grads = trainer.value_and_grad(loss_of, local)
    grads = trainer.sync_grads(grads, leaf_specs, mesh)
    gnorm = trainer.sharded_global_norm(grads, leaf_specs, mesh)
    new, state = opt.update(grads, state, local, g_norm=gnorm)
    mem.sync()
    step_s = time.perf_counter() - t0
    mesh_lib.COLLECTIVE_TIMING = False
    coll = dict(mesh_lib.COLLECTIVE_STATS)
    peak_gb = mem.peak_gb(base)
    t0 = time.perf_counter()
    grad_err = max(_shard_errs(grads, ref_grads, leaf_specs, mesh))
    param_err = _param_errs(trainer.tree_leaves(new), ref_new, leaf_specs,
                            mesh, TRAIN_RANKS_LR)
    part_s["compare"] = time.perf_counter() - t0
    rep = {
        "leg": leg, "layers": cfg.n_layers, "dim": cfg.dim,
        "vocab": cfg.vocab_size, "batch": dims["batch"],
        "seq": dims["seq"], "mesh": {a: n for a, n in mesh.shape.items()
                                         if n > 1},
        "loss": float(loss), "ref_loss": float(ref_loss),
        "grad_norm": float(gnorm), "ref_grad_norm": float(ref_norm),
        "grad_rel_err": grad_err, "params": param_err,
        # bf16 norm weights at 1.0 do not move by lr 1e-3 (their ulp is
        # 2^-7): the count is printed, not held.
        "moved": sum(not torch.equal(a, b) for a, b in zip(
            trainer.tree_leaves(new), trainer.tree_leaves(local))),
        "leaves": len(leaf_specs), "step_s": step_s, "part_s": part_s,
        "collectives": coll,
        "collective_ms": 1e3 * coll["seconds"],
        "shard_gb": shard_bytes / 2**30,
        "full_gb": full_gb,
        "step_peak_gb_above_start": peak_gb,
        "tol": {"loss_rtol": TRAIN_RANKS_LOSS_RTOL,
                "grad_leaf_rtol": TRAIN_RANKS_RTOL,
                "param_within": "2 lr + 1 bf16 ulp of max|p|",
                "param_share_within_half_lr": TRAIN_RANKS_SAME_SHARE}}
    if leg == "pipeline":
        rep["n_micro"] = dims["n_micro"]
    if leg == "sequence":
        # K/V rotations of the ring: one a layer forward, one recomputed
        # (remat), one backward.
        rep["ring_hops"] = coll["ppermute"]
        rep["seq_local"] = dims["seq"] // 2
    rep["ok"] = bool(
        abs(rep["loss"] - rep["ref_loss"])
        <= TRAIN_RANKS_LOSS_RTOL * abs(rep["ref_loss"])
        and abs(rep["grad_norm"] - rep["ref_grad_norm"])
        <= TRAIN_RANKS_LOSS_RTOL * rep["ref_grad_norm"]
        and rep["grad_rel_err"] <= TRAIN_RANKS_RTOL
        and param_err["worst_over_allowed"] <= 1.0
        and param_err["share_within_half_lr"] >= TRAIN_RANKS_SAME_SHARE)
    return rep


def _train_warmup(device) -> dict:
    """One step of the tiny model in bf16 on `device`: the first launch
    of each op the legs run (module loads, library handles) happens here,
    while the smoke's checkpoint phase runs, not inside a timed leg."""
    import dataclasses

    import torch

    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.training import trainer

    t0 = time.perf_counter()
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.bfloat16)
    tcfg = trainer.TrainConfig(warmup_steps=0, remat=True)
    opt = trainer.make_optimizer(tcfg)
    params = llama.init_params(cfg, device)
    step = trainer.make_train_step(cfg, tcfg, opt)
    step(params, opt.init(params), trainer.synthetic_batch(
        cfg, 2, 16, device=device))
    _CudaMem(device).sync()
    return {"warmup_s": time.perf_counter() - t0}


def _train_rank_leg(rank, mesh_lib, device, leg: str, dims) -> dict:
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    rep = _ring_leg(rank, mesh_lib, device, dims) if leg == "ring" else \
        _step_leg(rank, mesh_lib, device, leg, dims)
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def phase_train_ranks(card: str, ranks, device: str = "cuda:0",
                      dims=None) -> dict:
    """The sharded training rest on two rank processes that `tp_spawn`
    started (phase_tp's rank program; both on `device`, gloo through host
    memory), to which the caller sent a "warm" command at spawn (its
    replies are read first), and which it shuts down at its end: ring
    attention over the sequence axis, then one step each of the pipeline
    (GPipe, n_micro TRAIN_RANKS_MICRO), FSDP, tensor-parallel and
    sequence-parallel (ring attention inside the blocks) trainers, each
    against the one-device computation in the same rank. It exercises the math,
    not the memory a second card would give. Each leg prints its
    tolerance, seconds, collectives and their ms, and each rank's peak
    memory against its shard's bytes."""
    procs, cmds, out = ranks
    dims = dims or TRAIN_RANKS_DIMS
    rec: dict = {"phase": "train_ranks", "card": card, "device": device,
                 "dims": dims, "legs": {}}
    t0 = time.perf_counter()
    got = _tp_replies(procs, out, "warm")
    rec["warmup_s"] = [got[r]["warmup_s"] for r in (0, 1)]
    for leg in ("ring", "pipeline", "fsdp", "tensor", "sequence"):
        time_mark(f"train_ranks_{leg}")
        got = _tp_ask(procs, cmds, out, "train", {"leg": leg,
                                                   "dims": dims})
        rec["legs"][leg] = {"ok": all(got[r]["ok"] for r in (0, 1)),
                            "ranks": [got[0], got[1]]}
    for q in cmds:
        q.put(None)
    for p in procs:
        p.join(timeout=120)
    rec["exitcodes"] = [p.exitcode for p in procs]
    rec["seconds"] = time.perf_counter() - t0
    rec["ok"] = (all(v["ok"] for v in rec["legs"].values())
                 and rec["exitcodes"] == [0, 0])
    emit(rec)
    return rec


def phase_tp(card: str, llm_dir: str, cfg, ref: dict, bf16_params,
             int8_params, int8_ref: dict, max_tokens: int = 8,
             int8_tokens: int = 8, second_tokens: int = 4,
             spec_tokens: int = 8, spec_long: int = TP_SPEC_LONG,
             device: str = "cuda:0", engine_cfg=None, ranks=None) -> dict:
    """Tensor parallelism: two rank processes on cuda:0 serve the 8B
    snapshot at `llm_dir` sharded, bf16 then int8 (see the docstring's
    13c). `ref` / `int8_ref` are the single-device engines' grouped
    completions of the same prompts (checkpoint_streams; max_tokens and
    int8_tokens long), `bf16_params` / `int8_params` the single-device
    trees (the teacher-forced engine's and the export's references and,
    for int8, the codes the ranks' shards must slice). Each leg's second
    engine serves second_tokens of each completion, held to the first
    run's tokens. Then the speculative leg over the int8 shards
    (`_tp_spec_leg`, spec_tokens a completion, a spec_long-token
    prompt riding). `ranks` are
    processes tp_spawn started (default: started here)."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch.config.schema import MeshConfig
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.parallel import mesh as mesh_lib
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
    from generativeaiexamples_tpu_torch.serving.sharding import (
        shard_slices)
    from generativeaiexamples_tpu_torch.utils.tokenizer import (
        load_tokenizer)

    t_phase = time.perf_counter()
    prompts = ref["prompts"]
    tokenizer = load_tokenizer(llm_dir)
    eos = tokenizer.eos_id
    ranks = ranks or tp_spawn(device)
    procs, cmds, out = ranks
    rec = {"phase": "tp", "card": card, "tensor": 2, "devices":
           [device, device], "legs": {}}
    base_cfg = {**TP_ENGINE, **(engine_cfg or {})}
    oks = []
    try:
        for leg, ecfg, tree, want, n_tokens in (
                ("bf16", dict(base_cfg), bf16_params, ref, max_tokens),
                ("int8", {**base_cfg, **TP_INT8}, int8_params, int8_ref,
                 int8_tokens)):
            time_mark(f"tp_{leg}")
            lrec = {}
            got = _tp_ask(procs, cmds, out, "load",
                          {"path": llm_dir, "ecfg": ecfg,
                           "share": leg == "int8",
                           "env": {k: v for k, v in os.environ.items()
                                   if k.startswith("GAIE_")}})
            lrec["backend"] = got[0]["backend"]
            lrec["ranks"] = {r: {k: got[r][k] for k in (
                "load_s", "peak_bytes", "shard_bytes")} for r in got}
            mismatch = []
            if leg == "int8":
                for r in (0, 1):
                    mesh = mesh_lib.build_mesh(MeshConfig(ici_tensor=2),
                                               [device, device], rank=r)
                    mine = _tp_leaves(int8_params)
                    spec_of = {**{k: v for k, v in llama.param_specs(
                        cfg).items() if k != "layers"},
                        **{f"layers.{k}": v for k, v in llama.param_specs(
                            cfg)["layers"].items()}}
                    for path, t in got[r]["leaves"].items():
                        name, part = path.rsplit(".", 1)
                        spec = tuple(spec_of[name])
                        if part == "s" and len(spec) >= 2:
                            spec = spec[:-2] + (spec[-1],)
                        full = mine[path]
                        want_t = full[shard_slices(full.shape, spec, mesh)]
                        if not (want_t.shape == t.shape
                                and torch.equal(want_t, t)):
                            mismatch.append(f"rank{r}:{path}")
                    got[r]["leaves"] = None
                # Every reference to the ranks' shared tensors goes before
                # they may free them.
                del got, t, want_t
                for q in cmds:
                    q.put("ack")
                lrec["codes_scales_mismatched"] = mismatch
            # The rank engines' own serving path against one device's:
            # teacher-forced logits of the prefill and of the decode steps
            # over the pool, both fed the single-device engine's tokens
            # (never EOS, which would end a request early).
            forced = [[t for t in list(w or []) + list(p) if t != eos][
                :TP_TEACHER_STEPS + 1] for w, p in zip(want["tokens"],
                                                      prompts)]
            single = LLMEngine(tree, cfg, tokenizer,
                               _tp_teacher_ecfg(ecfg, False), device=device)
            ref_logits = _teacher_forced(single, prompts, forced,
                                         TP_TEACHER_STEPS)
            del single
            gc.collect()
            torch.cuda.empty_cache()
            teach = {"ecfg": _tp_teacher_ecfg(ecfg, True),
                     "prompts": prompts, "forced": forced, "fault": False}
            got = _tp_ask(procs, cmds, out, "teacher", teach)
            scale = float(np.abs(ref_logits).max())
            err = np.abs(got[0]["logits"] - ref_logits).max(axis=(0, 2))
            lrec["logits"] = {
                "steps": ["prefill"] + [f"decode_{k}" for k in range(
                    1, TP_TEACHER_STEPS + 1)],
                "max_abs_err_by_step": err.tolist(), "max_abs_ref": scale,
                "rtol": TP_LOGIT_RTOL,
                "ok": float(err.max()) <= TP_LOGIT_RTOL * scale,
                "argmax_equal_share": float(np.mean(
                    got[0]["logits"].argmax(-1) == ref_logits.argmax(-1)))}
            if leg == "bf16":
                # The gate against a planted fault: rank 1's first two kv
                # heads swapped, on two prompts.
                got = _tp_ask(procs, cmds, out, "teacher", {
                    **teach, "prompts": prompts[:2], "forced": forced[:2],
                    "fault": True})
                ferr = np.abs(got[0]["logits"] - ref_logits[:2]).max(
                    axis=(0, 2))
                lrec["logits"]["planted_fault"] = {
                    "max_abs_err_by_step": ferr.tolist(),
                    "caught": float(ferr.max()) > TP_LOGIT_RTOL * scale}
                lrec["logits"]["ok"] &= lrec["logits"]["planted_fault"][
                    "caught"]
            del got
            runs = {}
            # The second engine: bit-identical tokens and the timed
            # collectives.
            for run, first, timing, tokens in (
                    ("A", True, False, n_tokens),
                    ("B", False, True, second_tokens)):
                runs[run] = _tp_ask(procs, cmds, out, "serve", {
                    "ecfg": ecfg, "first": first, "timing": timing,
                    "prompts": prompts, "max_tokens": tokens,
                    "session": first})
            a0 = runs["A"][0]
            b0 = runs["B"][0] if "B" in runs else None
            layers = cfg.n_layers
            paged = ("paged_attention_int8" if leg == "int8"
                     else "paged_attention")
            need = ["flash_attention", paged] + (
                ["int8_matmul"] if leg == "int8" else [])
            launches = {r: {run: runs[run][r]["launches"] for run in runs}
                        for r in (0, 1)}
            steps = a0["metrics"]["decode_steps"]
            launch_ok = all(
                launches[r]["A"][k] > 0 for r in (0, 1) for k in need) and \
                all(launches[r]["A"][paged] >= layers * steps
                    for r in (0, 1)) and \
                (leg == "int8" or all(launches[r]["A"][
                    "int8_matmul"] == 0 for r in (0, 1)))
            replay_ok = all(
                runs[run][0]["metrics"]["replay_records_published"]
                == runs[run][1]["consumed"] > 0
                and runs[run][0]["metrics"]["replay_divergence"] == 0
                and runs[run][1]["metrics"]["replay_divergence"] == 0
                and runs[run][1]["metrics"]["multihost_processes"] == 2
                for run in runs)
            n_tok = sum(len(t or []) for t in a0["tokens"])
            sess = a0["session"]
            lrec["kv_export"] = _tp_check_export(a0.pop("kv_export"), tree,
                                                 cfg, device)
            lrec.update({
                "grouped": [r[0]["grouped"] for r in runs.values()],
                "completion_tokens": a0["completion_tokens"],
                # The second engine's tokens against the first run's
                # leading second_tokens (greedy: a shorter run is a
                # prefix of a longer one).
                "tokens_equal_second_run": (
                    [t[:second_tokens] for t in a0["tokens"]]
                    == b0["tokens"] if b0 else None),
                # The single-device runs served more tokens: their
                # leading n_tokens (greedy: a prefix of the longer run).
                "vs_single_device": _tp_share(a0["tokens"], [
                    (w or [])[:n_tokens] for w in want["tokens"]]),
                "tokens_per_s": n_tok / a0["wall_s"],
                "single_device_tokens_per_s": (
                    sum(len(t or []) for t in want["tokens"])
                    / want["completions_wall_s"]),
                "session": sess, "metrics": a0["metrics"],
                "replay": {run: {
                    "published": runs[run][0]["metrics"][
                        "replay_records_published"],
                    "read_by_rank1": runs[run][1]["consumed"],
                    "dispatches_replayed": runs[run][1]["replayed"]}
                    for run in runs},
                "launches": launches,
                "collectives_run_A": a0["collectives"],
                "launch_ok": launch_ok, "replay_ok": replay_ok})
            if b0:
                coll_b = b0["collectives"]
                lrec.update({
                    "collectives_run_B_timed": coll_b,
                    "collective_ms_per_decode_step": (
                        1e3 * coll_b["seconds"]
                        / b0["metrics"]["decode_steps"])})
            ok = (lrec["logits"]["ok"] and launch_ok and replay_ok
                  and not mismatch and all(lrec["grouped"])
                  and lrec["tokens_equal_second_run"] is True
                  and all(t and t >= 1 for t in a0["completion_tokens"])
                  and lrec["kv_export"]["ok"]
                  and sess["prefix_hits"] >= 2
                  and sess["kv_demotions"] > 0
                  and sess["kv_promotions"] > 0)
            lrec["ok"] = ok
            oks.append(ok)
            rec["legs"][leg] = lrec
        time_mark("tp_spec_int8")
        lrec = _tp_spec_leg(ranks, {**base_cfg, **TP_SPEC}, int8_params, cfg,
                            tokenizer, prompts, spec_tokens, spec_long,
                            device)
        oks.append(lrec["ok"])
        rec["legs"]["spec_int8"] = lrec
        for q in cmds:
            q.put(None)
        for p in procs:
            p.join(timeout=120)
        rec["exitcodes"] = [p.exitcode for p in procs]
    finally:
        tp_kill(ranks)
    rec["seconds"] = time.perf_counter() - t_phase
    rec["ok"] = all(oks) and len(oks) == 3 and rec["exitcodes"] == [0, 0]
    emit(rec)
    return rec


# -- K1, K3, K4 and K6 against another tree (--compare-parent) -------------

# (name, B, H, KH, Sq, Sk, lengths, q_offset) at head_dim 128, causal.
AB_FLASH = (("8b_s2048", 4, 32, 8, 2048, 2048, [2048] * 4, [0] * 4),
            ("8b_chunk_q_offset", 1, 32, 8, 2048, 8192, [6000], [4096]))


def time_kernels() -> dict:
    """K1-K6 times through the public wrappers of whichever port package
    is first on sys.path: AB_FLASH, K2's, K3's, K4's and K5's timed cases
    (K2, K4 and K5 alternating two layers as in their phases; these also
    with their device time, `<case>_device`, since a small case's loop
    time is the host's; K2 and K5 with their host time, `<case>_host`,
    and K2's 8b_short with a CPU profile of a call), and every
    K6_SHAPES x K6_ROWS case (the weights rotated through copies as in
    int8_mm_case)."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.ops import attention as attn
    from generativeaiexamples_tpu_torch.ops.int8_matmul import int8_matmul
    from generativeaiexamples_tpu_torch.ops.quant import quantize_tensor

    from generativeaiexamples_tpu_torch.ops import encoder_attention as ea
    from generativeaiexamples_tpu_torch.serving import paged_attention as pa
    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_int8 as pa8)
    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_tree as pt)

    kernels.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ms = {}
    for name, B, H, KH, Sq, Sk, lengths, q_offset in AB_FLASH:
        q = torch.randn((B, H, Sq, 128), generator=g, device=dev).bfloat16()
        k = torch.randn((B, KH, Sk, 128), generator=g, device=dev).bfloat16()
        v = torch.randn((B, KH, Sk, 128), generator=g, device=dev).bfloat16()
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        off = torch.tensor(q_offset, dtype=torch.int32, device=dev)
        ms[name] = time_ms(lambda: attn.flash_attention(
            q, k, v, causal=True, lengths=ln, q_offset=off))
    for name, B, lengths, seed in K2_TIMED:
        q, kp, vp, table, ln = _paged_inputs(B, 32, 8, 128, 128, 64,
                                             lengths, seed)
        turn = [0]

        def k2():
            turn[0] ^= 1
            pa.paged_attention(q, kp[turn[0]], vp[turn[0]], table, ln)

        ms[f"k2_{name}"] = time_ms(k2)
        ms[f"k2_{name}_device"] = device_ms(k2, _kernel_fn(
            "paged_attention"))
        ms[f"k2_{name}_host"] = host_ms(k2)
        if name == "8b_short":  # host-bound: where a call's time goes
            ms[f"k2_{name}_host_profile"] = host_profile(k2)
        del kp, vp
        torch.cuda.empty_cache()
    for name, B, maxp, lengths, tree, seed in K5_TIMED:
        q, kp, vp, table, ln, _ = _tree_inputs(B, 32, 8, 128, 128, maxp,
                                               lengths, tree, seed, False)
        turn = [0]

        def k5():
            turn[0] ^= 1
            pt.paged_tree_attention(q, kp[turn[0]], vp[turn[0]], table, ln,
                                    tree)

        ms[f"k5_{name}"] = time_ms(k5)
        ms[f"k5_{name}_device"] = device_ms(k5, _kernel_fn(
            "paged_attention_tree"))
        ms[f"k5_{name}_host"] = host_ms(k5)
        del kp, vp
        torch.cuda.empty_cache()
    for name, B, H, S, lengths, seed in _encoder_timed_cases():
        q, k, v, ln = _encoder_inputs(B, H, S, lengths, seed, True)

        def k3():
            ea.encoder_attention(q, k, v, ln)

        ms[f"k3_{name}"] = time_ms(k3)
        ms[f"k3_{name}_device"] = device_ms(k3, _kernel_fn(
            "encoder_attention"))
    for name, B, maxp, lengths, seed, R, tree in _paged_int8_timed_cases():
        q, kv, sc, table, ln, _ = _paged_int8_inputs(
            B, 32, 8, 128, 128, maxp, lengths, 2, 1, seed, False, R)
        turn = [0]

        def alternating():
            turn[0] ^= 1
            pa8.paged_attention_int8(q, kv, sc, table, ln, turn[0], q_rep=R,
                                     tree=tree)

        ms[f"k4_{name}"] = time_ms(alternating)
        ms[f"k4_{name}_device"] = device_ms(alternating, _kernel_fn(
            "paged_attention_int8"))
        del kv, sc
        torch.cuda.empty_cache()
    for wname, (K, M) in K6_SHAPES.items():
        qt = quantize_tensor(torch.randn((K, M), generator=g, device=dev)
                             * K ** -0.5)
        copies = [qt.q] + [qt.q.clone() for _ in range(
            min(15, int(150e6 // (K * M))))]
        for R in K6_ROWS:
            x = torch.randn((R, K), generator=g, device=dev).bfloat16()
            turn = [0]

            def kernel():
                turn[0] = (turn[0] + 1) % len(copies)
                int8_matmul(x, copies[turn[0]], qt.s)

            ms[f"{wname}_r{R}"] = time_ms(kernel)
        del copies, qt
        torch.cuda.empty_cache()
    return ms


# -- plan variants of K4 (--variants) ---------------------------------------

# K4's plan variants at its timed cases: fields of paged_int8_plan's
# result replaced ({} is the shipped plan).
K4_PLAN_VARIANTS = (
    ("8b_decode", {}), ("8b_decode", {"key_slices": 4}),
    ("8b_decode", {"pages_per_split": 8}),
    ("8b_decode", {"pages_per_split": 32}),
    ("qrep2_b8", {}), ("qrep2_b8", {"key_slices": 4}),
    ("8b_b128", {}), ("8b_b128", {"key_slices": 8}),
    ("8b_b128", {"key_slices": 2}),
    ("tree34_b128", {}), ("tree34_b128", {"key_slices": 1}),
    ("tree34_burst", {}), ("tree34_burst", {"key_slices": 1}))


def kernel_variants() -> list:
    """K4's plan variants at its timed cases, in one process on one card:
    each checked against its plain version (max error relative to each
    row's max |out|) and timed (loop and device)."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_int8 as pa8)

    kernels.build(["paged_attention_int8"])
    rows = []
    cases = {c[0]: c for c in _paged_int8_timed_cases()}
    shipped = pa8.paged_int8_plan
    for name, override in K4_PLAN_VARIANTS:
        _, B, maxp, lengths, seed, R, tree = cases[name]
        q, kv, sc, table, ln, _ = _paged_int8_inputs(
            B, 32, 8, 128, 128, maxp, lengths, 2, 1, seed, False, R)

        def plan(B_, KH, rows_, Hd, ps, maxp_, n_sms):
            p = shipped(B_, KH, rows_, Hd, ps, maxp_, n_sms)._replace(
                **override)
            splits = -(-maxp_ // p.pages_per_split)
            step = 32 if (ps // p.key_slices) % 32 == 0 else 16
            ws = (4 * B_ * KH * splits * p.row_tiles * (Hd // 2 + 4) * 32
                  if splits > 1 else 0)
            return p._replace(keys_per_step=step, splits=splits,
                              workspace_bytes=ws)

        turn = [0]

        def kernel():
            turn[0] ^= 1
            return pa8.paged_attention_int8(q, kv, sc, table, ln, turn[0],
                                            q_rep=R, tree=tree)

        pa8.paged_int8_plan = plan
        try:
            got = kernel().float().reshape(B * R, -1)
            want = pa8.paged_attention_int8_rep_reference(
                (q if R > 1 else q[:, None]).float(), kv[:, 1], sc[:, 1],
                table, ln.clamp(min=1), tree=tree).reshape(B * R, -1)
            rel = float(((got - want).abs().amax(1)
                         / want.abs().amax(1)).max())
            rows.append({"kernel": "paged_attention_int8", "case": name,
                         "plan": plan(B, 8, 4 * R, 128, 128, maxp,
                                      n_sms())._asdict(),
                         "shipped_plan": not override,
                         "max_row_rel_err": rel, "ms": time_ms(kernel),
                         "device_ms": device_ms(kernel, _kernel_fn(
                             "paged_attention_int8"))})
        finally:
            pa8.paged_int8_plan = shipped
        del kv, sc
        torch.cuda.empty_cache()
    return rows


# K2's and K5's plan variants at their timed cases: (kernel, case, fields
# of paged_bf16_plan's result replaced; {} is the shipped plan).
# The first plan of this design (64-slot stages, 3 deep, 2 CTAs an SM
# targeted, no shortest run) is kept as a variant of each.
BF16_PLAN_VARIANTS = (
    ("paged_attention", "8b_decode", {}),
    ("paged_attention", "8b_decode", {"stage_keys": 64, "key_slices": 4,
                                      "ring_stages": 3,
                                      "pages_per_split": 16}),
    ("paged_attention", "8b_decode", {"pages_per_split": 16}),
    ("paged_attention", "8b_decode", {"pages_per_split": 8}),
    ("paged_attention", "8b_decode", {"ring_stages": 3}),
    ("paged_attention", "8b_decode", {"key_slices": 4}),
    ("paged_attention", "8b_b1_6000", {}),
    ("paged_attention", "8b_b1_6000", {"stage_keys": 64, "key_slices": 4,
                                       "ring_stages": 3,
                                       "pages_per_split": 2}),
    ("paged_attention", "8b_b1_6000", {"pages_per_split": 2}),
    ("paged_attention", "8b_b1_6000", {"pages_per_split": 8}),
    ("paged_attention", "8b_b1_6000", {"ring_stages": 3}),
    ("paged_attention", "8b_short", {}),
    ("paged_attention", "8b_short", {"pages_per_split": 64}),
    ("paged_attention_tree", "8b_tree34", {}),
    ("paged_attention_tree", "8b_tree34", {"stage_keys": 64,
                                           "ring_stages": 3,
                                           "pages_per_split": 17}),
    ("paged_attention_tree", "8b_tree34", {"pages_per_split": 17}),
    ("paged_attention_tree", "8b_tree34", {"pages_per_split": 8}),
    ("paged_attention_tree", "8b_tree34", {"ring_stages": 3}),
    ("paged_attention_tree", "8b_tree34", {"key_slices": 1}))


def bf16_variants() -> list:
    """K2's and K5's plan variants at their timed cases, in one process
    on one card: each checked against its plain version (K2: max abs
    error; K5: max error relative to each node's max |out|) and timed
    (loop and device, alternating two layers)."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving import paged_attention as pa
    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_tree as pt)

    kernels.build(["paged_attention", "paged_attention_tree"])
    k2_cases = {c[0]: c for c in K2_TIMED}
    k5_cases = {c[0]: c for c in K5_TIMED}
    shipped = pa.paged_bf16_plan
    rows = []
    for kernel_name, name, override in BF16_PLAN_VARIANTS:
        tree = None
        if kernel_name == "paged_attention":
            _, B, lengths, seed = k2_cases[name]
            maxp = 64
            q, kp, vp, table, ln = _paged_inputs(B, 32, 8, 128, 128, maxp,
                                                 lengths, seed)
        else:
            _, B, maxp, lengths, tree, seed = k5_cases[name]
            q, kp, vp, table, ln, _ = _tree_inputs(
                B, 32, 8, 128, 128, maxp, lengths, tree, seed, False)

        def plan(B_, KH, rows_, Hd, ps, maxp_, n_sms_):
            p = shipped(B_, KH, rows_, Hd, ps, maxp_, n_sms_)._replace(
                **override)
            splits = -(-maxp_ // p.pages_per_split)
            width = p.stage_keys // p.key_slices
            ws = (4 * B_ * KH * splits * p.row_tiles * (Hd // 2 + 4) * 32
                  if splits > 1 else 0)
            return p._replace(keys_per_step=32 if width % 32 == 0 else 16,
                              splits=splits, workspace_bytes=ws)

        turn = [0]

        def kernel():
            turn[0] ^= 1
            if tree is None:
                return pa.paged_attention(q, kp[turn[0]], vp[turn[0]],
                                          table, ln)
            return pt.paged_tree_attention(q, kp[turn[0]], vp[turn[0]],
                                           table, ln, tree)

        pa.paged_bf16_plan = plan
        try:
            turn[0] = 0  # the next call reads layer 1
            got = kernel().float()
            if tree is None:
                want = pa.paged_attention_reference(
                    q.float(), kp[1].float(), vp[1].float(), table, ln)
                err = {"max_abs_err": float((got - want).abs().max())}
            else:
                want = pa.paged_tree_attention_reference(
                    q.float(), kp[1].float(), vp[1].float(), table,
                    ln.clamp(min=1), pt._canonical_tree(*tree))
                diff = (got - want).abs().amax((1, 3))        # [B, r]
                err = {"max_node_rel_err": float((
                    diff / want.abs().amax((1, 3))).max())}
            group_rows = 4 * (q.shape[2] if tree is not None else 1)
            rows.append({"kernel": kernel_name, "case": name,
                         "plan": plan(B, 8, group_rows, 128, 128, maxp,
                                      n_sms())._asdict(),
                         "shipped_plan": not override, **err,
                         "ms": time_ms(kernel),
                         "device_ms": device_ms(kernel,
                                                _kernel_fn(kernel_name)),
                         "host_ms": host_ms(kernel)})
        finally:
            pa.paged_bf16_plan = shipped
        del kp, vp, got, want
        torch.cuda.empty_cache()
    return rows


def compare_parent(parent: str) -> dict:
    """time_kernels of the tree at `parent` and of this one in turns
    (parent, change, change, parent), each in its own process on the
    same card; {case: [four ms]}."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for root in (parent, here, here, parent):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-kernels",
             os.path.abspath(root)], capture_output=True, text=True,
            timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"--time-kernels {root} failed "
                               f"(rc {out.returncode}):\n{out.stderr[-4000:]}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    return {case: [r[case] for r in runs] for case in runs[0]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--time-kernels":
        # The port package of another tree (e.g. an unpacked parent).
        sys.path.insert(0, args[1])
        emit(time_kernels())
        return 0
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if len(args) == 2 and args[0] == "--compare-parent":
        emit({"card": nvidia_smi(), "order": "parent, change, change, parent",
              "compare_parent_ms": compare_parent(args[1])})
        return 0
    if args == ["--variants"]:
        emit({"card": nvidia_smi(),
              "variants": kernel_variants() + bf16_variants()})
        return 0
    if args == ["--graphs"]:
        rec = graphs_only(nvidia_smi())
        emit({"phase": "graphs_only", **rec})
        return 0 if all(rec["ok"].values()) else 1
    if args:
        print("usage: chip_smoke.py [--compare-parent DIR | "
              "--time-kernels DIR | --variants | --graphs]",
              file=sys.stderr)
        return 2
    try:
        from generativeaiexamples_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 2
    # Plain f32 matmuls in full precision on the card (the references).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi()
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    secs = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": secs,
          "ptxas": {n: _ptxas_summary(n) for n in kernels.SIGNATURES}})

    flash = phase_flash()
    paged = phase_paged()
    encoder = phase_encoder()
    t_tools = time.perf_counter()
    tools_enc = phase_tools_encoders(card)
    t_tools = time.perf_counter() - t_tools
    paged_int8 = phase_paged_int8()
    tree = phase_tree()
    int8_mm = phase_int8_matmul()
    model = phase_model()
    served = ServedEngine("8b", "cuda")
    rag_keep = {}
    # Seconds per phase since the build began (the build, the kernel
    # phases, phase_model and the served engine's set-up come first).
    phase_s = {"build_to_served": time.perf_counter() - t0,
               "tools_encoders": t_tools}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        time_mark(name)
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t
        return out

    try:
        serving = timed("serving", phase_serving, card, served)
        flight = timed("flight", phase_flight, card, served)
        pacer = timed("pacer", phase_pacer, card, served)
        chunked = timed("chunked", phase_chunked, served)
        fused = timed("fused_prefill", phase_fused_prefill, card, served)
        rag = timed("rag", phase_rag, card, served, keep=rag_keep)
        ingest = timed("ingest", phase_ingest, card, rag_keep)
        chain = timed("chain", phase_chain, card, served, rag_keep)
        eval_rec = timed("eval", phase_eval, card, served, rag_keep)
        ui = timed("ui", phase_ui, card, served, rag_keep)
        streaming = timed("streaming", phase_streaming, card, served,
                          rag_keep)
        ann = timed("ann", phase_ann, card, served, rag_keep)
        pipelines = timed("pipelines", phase_pipelines, card, served,
                          rag_keep)
        spec_bf16 = timed("spec_bf16", phase_spec_bf16, card, served)
        graphs_bf16 = timed("graphs_bf16", phase_graphs_bf16, card, served)
        graphs_hits = timed("graphs_hits", phase_graphs_hits, card, served)
        prefix = timed("prefix", phase_prefix, card, served)
        fleet = timed("fleet", phase_fleet, card, served)
        # What the engine loaded from the snapshot of these weights must
        # give, taken before this engine goes.
        ckpt_ref = timed("checkpoint_streams", checkpoint_streams, served)
    finally:
        served.close()
    # The bf16 engine's pool and the RAG phase's 1M-row store go before
    # the int8 engine comes; its weights, encoders and ingested store stay
    # for the checkpoint phase (~16 GB beside the int8 phases' ~45).
    bf16_params, bf16_cfg = served.engine.params, served.engine.cfg
    del served
    gc.collect()
    torch.cuda.empty_cache()
    serving_int8, int8_served = timed("serving_int8", phase_serving_int8,
                                      card)
    tools_int8, int8_pages = timed("tools_int8", phase_tools_int8, card,
                                   int8_served)
    tutorial = timed("tutorial_02", phase_tutorial, card)
    spec_int8 = timed("spec_int8", phase_spec_int8, card, int8_served,
                      n_pages=int8_pages)
    int8_engine = int8_served.engine
    fused_int8 = timed("fused_prefill_int8", phase_fused_prefill_int8,
                       card, int8_engine.params, int8_engine.cfg,
                       int8_engine.tokenizer)
    graphs_int8 = timed("graphs_int8", phase_graphs_int8, card,
                        int8_engine.params, int8_engine.cfg,
                        int8_engine.tokenizer)
    del int8_served, int8_engine
    gc.collect()
    torch.cuda.empty_cache()
    # The sharded training legs' rank processes start now, so their
    # start-up overlaps the checkpoint phase; they run last, when this
    # process has freed the weights (each rank holds ~25 GB at its peak).
    train_procs = tp_spawn("cuda:0")
    for q in train_procs[1]:
        q.put(("warm", None))
    try:
        checkpoint = timed("checkpoint", phase_checkpoint, card,
                           bf16_params, bf16_cfg, ckpt_ref, rag_keep)
        train = timed("train", phase_train, card, bf16_params, bf16_cfg,
                      rag_keep)
        del bf16_params, rag_keep
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "memory", "before": "train_ranks",
              **_release_device_memory()})
        train_ranks = timed("train_ranks", phase_train_ranks, card,
                            train_procs)
    finally:
        tp_kill(train_procs)
    phase_s["total"] = time.perf_counter() - t0
    emit({"phase": "timing", "seconds": phase_s, "marks": _MARKS})

    line = []
    for name, rep, cases, main_case, launches, tol in (
            ("flash_attention", K1_REPLACES, flash, "8b_s2048",
             serving["launches"], BF16_ATOL),
            ("paged_attention", K2_REPLACES, paged, "8b_decode",
             serving["launches"], BF16_ATOL),
            ("encoder_attention", K3_REPLACES, encoder, "arctic_s512",
             rag["launches"], BF16_ATOL),
            ("paged_attention_int8", K4_REPLACES, paged_int8, "8b_decode",
             serving_int8["launches"],
             f"{PAGED_INT8_RTOL} x max|out| of each row"),
            ("paged_attention_tree", K5_REPLACES, tree, "8b_tree34",
             spec_bf16["launches"],
             f"{TREE_RTOL} x max|out| of each (row, node)"),
            ("int8_matmul", K6_REPLACES, int8_mm, "w_gate_up_r8",
             serving_int8["launches"], f"{INT8_MM_RTOL} x max|y|")):
        c = next(c for c in cases if c["case"] == main_case)
        line.append({
            "name": name, "route": "cuda",
            "source": f"generativeaiexamples_tpu_torch/csrc/{name}.cu",
            "replaces": rep, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tol": tol, "parity_ok": all(c["ok"] for c in cases),
            "case": main_case, "ms": c["ms"], "device_ms": c.get("device_ms"),
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    # K4's verify forms (launched on spec_int8's path).
    k4 = next(e for e in line if e["name"] == "paged_attention_int8")
    k4["spec_launches"] = {r["config"]: r["launches"]["paged_attention_int8"]
                           for r in spec_int8}
    k4["verify_cases"] = {
        c["case"]: {k: c[k] for k in ("q_rep", "tree", "ms", "device_ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "sdpa_gathered_ms",
                                      "sdpa_gathered_device_ms")}
        for c in paged_int8 if c["q_rep"] > 1 and "ms" in c}
    main_k4 = next(c for c in paged_int8 if c["case"] == "8b_decode")
    k4["sdpa_gathered_ms"] = main_k4["sdpa_gathered_ms"]
    k4["sdpa_gathered_device_ms"] = main_k4["sdpa_gathered_device_ms"]
    k4["cases"] = {c["case"]: {k: c[k] for k in (
        "ms", "device_ms", "bound_ms", "sdpa_gathered_ms",
        "sdpa_gathered_device_ms", "plan")} for c in paged_int8
        if c["q_rep"] == 1 and "ms" in c}
    k3 = next(e for e in line if e["name"] == "encoder_attention")
    k3["cases"] = {c["case"]: {k: c[k] for k in (
        "ms", "device_ms", "bound_ms", "library_ms", "library_device_ms",
        "k1_d64_ms")} for c in encoder if "ms" in c}
    # K2's and K5's timed cases (K2 also launches on spec_bf16's plain
    # fallback), each beside SDPA over K/V gathered beforehand.
    for name, cases in (("paged_attention", paged),
                        ("paged_attention_tree", tree)):
        entry = next(e for e in line if e["name"] == name)
        entry["cases"] = {c["case"]: {k: c[k] for k in (
            "ms", "device_ms", "bound_ms", "sdpa_gathered_ms",
            "sdpa_gathered_device_ms", "plan")} for c in cases if "ms" in c}
    k2 = next(e for e in line if e["name"] == "paged_attention")
    k2["spec_bf16_launches"] = spec_bf16["launches"]["paged_attention"]
    # The fused prefill rider: K1 and K2 on run B of the bf16 phase, K4
    # and K6 on the int8 rider run; K1's rider chunk case. The rider
    # beside verify steps: K1 and K5 on run E, K1, K4 and K6 on the int8
    # tree composition.
    for e in line:
        run = (fused["runs"]["B_rider"] if e["name"] in (
            "flash_attention", "paged_attention") else fused_int8)
        if e["name"] in run["launches"]:
            e["fused_launches"] = run["launches"][e["name"]]
        spec_runs = {"E_spec_rider": fused["runs"]["E_spec_rider"],
                     "int8_spec_rider": fused_int8["spec_rider"]}
        launched = {run: r["launches"][e["name"]]
                    for run, r in spec_runs.items()
                    if r["launches"].get(e["name"])}
        if launched:
            e["spec_rider_launches"] = launched
    k1 = next(e for e in line if e["name"] == "flash_attention")
    k1["rider_case"] = {k: c[k] for c in flash
                        if c["case"] == "8b_rider_q_offset"
                        for k in ("max_abs_err", "ok", "ms", "device_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "library")}
    # K1 (a hit's suffix at q_offset) and K2 (decode over adopted and
    # promoted pages) on the prefix-cache path.
    for e in line:
        # The fleet phase: two replicas, disagg, HTTP replicas and QoS (K1
        # and K2 only).
        e["fleet_launches"] = fleet["launches"][e["name"]]
        if e["name"] in ("flash_attention", "paged_attention"):
            e["prefix_launches"] = prefix["launches"][e["name"]]
            # The pacer phase: two bursts of greedy streams.
            e["pacer_launches"] = pacer["launches"][e["name"]]
        # Launches on the models loaded from their snapshots (K5 is not
        # on that path).
        e["checkpoint_launches"] = checkpoint["launches"][e["name"]]
        # Each tensor-parallel rank's launches, run A of each leg (K1,
        # K2: bf16; K1, K4, K6: int8).
        tp_launches = {
            f"{leg}_rank{r}": lrec["launches"][r]["A"][e["name"]]
            for leg, lrec in checkpoint["tp"]["legs"].items()
            for r in (0, 1) if lrec["launches"][r]["A"][e["name"]]}
        if tp_launches:
            e["tp_launches"] = tp_launches
        if e["name"] in K123:
            # This slice's phases: the ingest pipeline (K3), the eval
            # harness, the playground and the training parts' kernel-route
            # checks.
            for tag, prec in (("ingest", ingest), ("eval", eval_rec),
                              ("ui", ui), ("streaming", streaming),
                              ("train", train)):
                if prec["launches"][e["name"]]:
                    e[f"{tag}_launches"] = prec["launches"][e["name"]]
            # The chain phase: coalesced search, traced and augmented
            # answers.
            e["chain_launches"] = sum(
                launches[e["name"]] for launches in (
                    chain["search"]["launches"], chain["traced"]["launches"],
                    chain["augmented_launches"]))
            # The ann phase: the chain over an IVF store.
            e["ann_launches"] = ann["launches"][e["name"]]
            # The pipelines phase: multi_turn_rag, api_catalog,
            # multimodal, query_decomposition and knowledge_graph.
            e["pipelines_launches"] = pipelines["launches"][e["name"]]
    # The attribution tools' launches (outside every counted window of
    # the main path): decompose_decode and profile_card on the int8
    # deployment, the BERT tools at arctic-embed-l, tutorial 02's own
    # process.
    tool_launches = {
        "decompose_decode": tools_int8["decompose_decode"]["launches"],
        "profile_card": tools_int8["profile_card"]["launches"],
        "decompose_bert_forward": tools_enc["decompose_bert_forward"][
            "launches"],
        "decompose_encoders": tools_enc["decompose_encoders"]["launches"],
        "tutorial_02": tutorial["launches"]}
    for e in line:
        launched = {tool: counts[e["name"]]
                    for tool, counts in tool_launches.items()
                    if counts.get(e["name"])}
        if launched:
            e["tools_launches"] = launched
        # The graphs phase: each deployment's warmed engine, whose decode
        # blocks were CUDA graph replays (the eager twin launched as many).
        launched = {rec["deployment"]: rec["runs"]["graphs"]["launches"][
            e["name"]] for rec in [graphs_bf16, graphs_hits] + graphs_int8
            if rec["runs"]["graphs"]["launches"][e["name"]]}
        if launched:
            e["graphs_launches"] = launched
    emit({"kernels": line})
    ok = (all(c["ok"] for c in flash + paged + encoder + paged_int8 + tree
              + int8_mm) and model["ok"] and serving["ok"] and flight["ok"]
          and pacer["ok"] and chunked["ok"]
          and fused["ok"] and fused_int8["ok"]
          and rag["ok"] and chain["ok"] and ann["ok"] and pipelines["ok"]
          and ingest["ok"] and eval_rec["ok"] and ui["ok"] and train["ok"]
          and streaming["ok"]
          and serving_int8["ok"] and spec_bf16["ok"]
          and prefix["ok"] and fleet["ok"]
          and all(r["ok"] for r in spec_int8)
          and checkpoint["ok"] and checkpoint["tp"]["ok"]
          and train_ranks["ok"] and tools_enc["ok"] and tools_int8["ok"]
          and tutorial["ok"] and graphs_bf16["ok"] and graphs_hits["ok"]
          and all(r["ok"] for r in graphs_int8))
    print(card, flush=True)
    if not ok:
        print("chip_smoke: FAILED (see the phase lines above)",
              file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _ptxas_summary(name: str) -> list:
    from generativeaiexamples_tpu_torch import kernels

    log = kernels.library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    return [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln]


if __name__ == "__main__":
    sys.exit(main())
