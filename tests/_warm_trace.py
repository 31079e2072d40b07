"""A warmed engine's lattice and its dispatch over a request trace, for
either package's LLMEngine (tests/test_torch_warmup.py).

The helpers take the engine and its GenRequest class, so the JAX engine
and the port's run the same code. Run as a script, this builds the JAX
package's engine on LlamaConfig.tiny() (init_params at PRNGKey(3)),
warms it and, given a trace, steps it inline, and prints the result as
JSON on its last line; each JAX engine runs in a process of its own.

The JAX engine gets a fresh chunk staging array per chunk: its own
`_chunk_buf` refills one array per width, and on the CPU backend
`jnp.asarray` of a 64-byte-aligned numpy array shares its memory, so a
refill can land before the asynchronously dispatched chunk has read it
(ROADMAP's third reference-side fault; whether it strikes depends on
where numpy placed the array).

    python tests/_warm_trace.py '{"ecfg": {...}, "warmup": {...} | null,
                                  "trace": [...] | null}'
"""

import json
import os
import queue
import sys

# Every plan coordinate of a `plan` dispatch record, in StepPlan's order
# (both packages use the JAX record's names).
PLAN_KEYS = ("plan_decode_k", "plan_spec_k", "plan_tree", "plan_rw",
             "plan_rs", "plan_spec_state", "plan_rider_sample")


def lattice(eng) -> dict:
    """The warmed lattice as JSON-ready sorted lists."""
    def pairs(s):
        return sorted([int(a), int(b)] for a, b in s)

    return {"ks": sorted(int(k) for k in eng._warm_ks),
            "plans": sorted([int(v) for v in p] for p in eng._warm_plans),
            "fused": pairs(eng._warm_fused),
            "spec_fused": pairs(eng._warm_spec_fused),
            "chunk_widths": pairs(eng._warm_chunk_widths),
            "sample_chunks": pairs(eng._warm_sample_chunks),
            "plan_variants_compiled": int(
                eng.metrics.plan_variants_compiled)}


def step(eng):
    """One deterministic scheduler iteration (the body of _loop, single
    threaded), as both packages' inline tests step it."""
    eng._admit_waiting()
    eng._advance_long_prefills()
    eng._emit_ready_first_tokens()
    while (len(eng._inflight) < eng.pipeline_depth
           and any(s is not None for s in eng.slots)):
        if not eng._dispatch_decode():
            break
    if not eng._inflight:
        return
    fl = eng._inflight.popleft()
    eng._process_block_host(fl, eng._fetch_block_host(fl))
    for seq in fl.releases:
        seq.release()
    fl.releases = []
    eng._reap_starved()
    eng._beat += 1
    eng._note_prefill_stalls()


def _idle(eng) -> bool:
    return (all(s is None for s in eng.slots) and not eng.waiting
            and not eng._long_prefills and not eng._inflight
            and not eng._pending_first)


def _ids(req) -> list:
    out = []
    while True:
        try:
            ev = req.stream.get_nowait()
        except queue.Empty:
            return out
        if ev["token_id"] >= 0:
            out.append(int(ev["token_id"]))


def run_trace(eng, request_cls, trace, max_steps: int = 400) -> dict:
    """Submit each trace entry ({"at": step, "prompt": ids,
    "max_new_tokens": n}) before that inline step and step to idle.
    Returns every `plan` record's coordinates in dispatch order, every
    `seed` and `commit` record as [kind, scratch length] in dispatch
    order ("points") and each request's token ids."""
    plans, points = [], []
    real = eng._exec_plan
    ps = eng.pool.page_size

    def spy(rec):
        plans.append([int(rec[k]) for k in PLAN_KEYS])
        return real(rec)

    def point(kind, fn):
        def run(rec):
            points.append([kind, len(rec["row"]) * ps])
            return fn(rec)
        return run

    eng._exec_plan = spy
    eng._exec_seed = point("seed", eng._exec_seed)
    eng._exec_commit = point("commit", eng._exec_commit)
    reqs = [None] * len(trace)
    for i in range(max_steps):
        for j, t in enumerate(trace):
            if t["at"] == i:
                reqs[j] = eng.submit(request_cls(
                    prompt_ids=list(t["prompt"]),
                    max_new_tokens=t["max_new_tokens"]))
        step(eng)
        if all(r is not None for r in reqs) and _idle(eng):
            break
    else:
        raise AssertionError("engine did not go idle")
    return {"plans": plans, "points": points,
            "streams": [_ids(r) for r in reqs]}


def _main(spec: dict) -> dict:
    import jax
    import numpy as np

    from generativeaiexamples_tpu.config.schema import EngineConfig
    from generativeaiexamples_tpu.models import llama
    from generativeaiexamples_tpu.serving.engine import GenRequest, LLMEngine
    from generativeaiexamples_tpu.utils.tokenizer import ByteTokenizer

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, jax.random.PRNGKey(3))
    eng = LLMEngine(params, cfg, ByteTokenizer(),
                    EngineConfig(**spec["ecfg"]), use_pallas=False)
    eng._chunk_buf = lambda width: np.zeros((1, width), np.int32)
    out = {}
    if spec.get("warmup") is not None:
        eng.warmup(**spec["warmup"])
        out["lattice"] = lattice(eng)
    if spec.get("trace"):
        out.update(run_trace(eng, GenRequest, spec["trace"]))
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    print(json.dumps(_main(json.loads(sys.argv[1]))))
