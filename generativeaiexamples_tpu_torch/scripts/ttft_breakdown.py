"""TTFT stage breakdown from the flight recorder, on the card.

The port's counterpart of the JAX package's scripts/ttft_breakdown.py.
Boots the int8 deployment (Llama-3-8B geometry, random int8 weights,
int8 KV, batch 128) through `serving.__main__.build_engine`, warms it,
then reads each request's path through the scheduler from the flight
recorder (serving/flight.py): submit -> admit (slot reserved) ->
prefill dispatched -> first token emitted. The recorder is on by
default, so the same table reads any engine config (fused, speculative,
prefix-cached), and `/debug/timeline` shows the same requests as spans.

    python -m generativeaiexamples_tpu_torch.scripts.ttft_breakdown \\
        [n_requests] [--device cpu]

Prints one stage table per request and the median row. On the CPU the
engine is the tiny geometry.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, List, Sequence

from generativeaiexamples_tpu_torch.serving import flight

STAGES = ["admit", "prefill_dispatched", "first_token"]
_STAGE_KINDS = {
    flight.EV_ADMIT: "admit",
    flight.EV_PREFILL_DISPATCH: "prefill_dispatched",
    # Chunked and prefix-hit prompts dispatch chunks instead of one
    # group; the FIRST chunk marks the same "prefill started" stage.
    flight.EV_PREFILL_CHUNK: "prefill_dispatched",
    flight.EV_FIRST_TOKEN: "first_token",
}

# The JAX script's own EngineConfig (its main(): B = 128, a 384-token
# cap, one 128 prefill bucket) on a fixed 4097-page pool. It is not
# chip_smoke.INT8_DEPLOYMENT, whose 8192-token cap and planner-sized pool
# serve the smoke's long prompts; this table times 128-token prompts.
DEPLOYMENT = {"quantize_weights": "int8", "kv_dtype": "int8",
              "max_batch_size": 128, "max_seq_len": 384, "page_size": 128,
              "prefill_buckets": (128,), "decode_steps_per_dispatch": 8,
              "pipeline_depth": 2}
N_PAGES = 4097


def stage_rows(recorder, rids: Sequence[str]) -> List[Dict[str, float]]:
    """Per-request stage tables (ms since the previous stage; "total":
    ms from submit to the first token) read from the recorder's
    lifecycle ring. A request with no submit event gives {}."""
    by_rid: Dict[str, list] = {}
    for ev in recorder.snapshot_events():
        by_rid.setdefault(ev["rid"], []).append(ev)
    rows = []
    for rid in rids:
        evs = by_rid.get(rid, [])
        submit = next((e["ts"] for e in evs
                       if e["kind"] == flight.EV_SUBMIT), None)
        if submit is None:
            rows.append({})
            continue
        row = {}
        prev = submit
        for stage in STAGES:
            ts = next((e["ts"] for e in evs
                       if _STAGE_KINDS.get(e["kind"]) == stage), None)
            if ts is not None:
                row[stage] = (ts - prev) * 1e3
                prev = ts
        last = next((e["ts"] for e in evs
                     if e["kind"] == flight.EV_FIRST_TOKEN), prev)
        row["total"] = (last - submit) * 1e3
        rows.append(row)
    return rows


def median_row(rows: Sequence[Dict[str, float]]) -> Dict[str, float]:
    return {s: statistics.median([r[s] for r in rows if s in r])
            for s in STAGES + ["total"] if any(s in r for r in rows)}


def format_row(label: str, row: Dict[str, float]) -> str:
    return f"[ttft] {label}: " + "  ".join(
        f"{s}={row.get(s, float('nan')):.1f}ms" for s in STAGES + ["total"])


def main(argv=None) -> None:
    from generativeaiexamples_tpu_torch.device import resolve_device
    from generativeaiexamples_tpu_torch.serving.__main__ import build_engine
    from generativeaiexamples_tpu_torch.serving.engine import GenRequest

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("n_requests", nargs="?", type=int, default=9)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    size = "8b" if dev.type == "cuda" else "tiny"
    eng = build_engine(size, dev, warmup=False, engine_cfg=DEPLOYMENT,
                       n_pages=N_PAGES)
    eng.warmup(buckets=[128])
    eng.start()
    try:
        prompt = list(range(2, 130))
        list(eng.generate_stream(prompt, max_new_tokens=4))  # e2e warm
        print("[ttft] engine warm", flush=True)
        eng.metrics.reset_window()
        rids = []
        for r in range(args.n_requests):
            req = GenRequest(prompt_ids=list(prompt), max_new_tokens=2,
                             request_id=f"ttft-{r}")
            rids.append(req.request_id)
            eng.submit(req)
            ev = req.stream.get()
            # Drain the stream so the next request sees an idle engine.
            while not ev["finished"]:
                ev = req.stream.get()
            time.sleep(0.2)
        rows = stage_rows(eng.flight, rids)
        rate = eng.metrics.tokens_per_sec()
    finally:
        eng.stop()
    for r, row in enumerate(rows):
        print(format_row(f"req {r}", row))
    print(format_row("MEDIAN", median_row(rows)))
    print(f"[ttft] tokens/s over the timed requests: {rate:.1f}")


if __name__ == "__main__":
    main()
