# %% [markdown]
# # 04 — Streaming RAG, ingest pipelines, agents
#
# The reference's experimental capability surface (fm-asr streaming,
# Morpheus ingest, CVE agents) end to end, hermetically.

# %%
import argparse
import json
import os
import sys

# __file__ is undefined inside a Jupyter kernel; fall back to cwd.
_here = (os.path.dirname(os.path.abspath(__file__))
         if "__file__" in globals() else os.getcwd())
sys.path.insert(0, os.path.abspath(os.path.join(_here, "..", "..", "..")))

from generativeaiexamples_tpu_torch.connectors.fakes import EchoLLM, HashEmbedder
from generativeaiexamples_tpu_torch.device import resolve_device

# The card unless `--device cpu`; without CUDA that raises (no fallback).
# parse_known_args lets a notebook kernel's own argv pass through.
_ap = argparse.ArgumentParser()
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
DEVICE = resolve_device(_ap.parse_known_args()[0].device)

# %% [markdown]
# ## FM radio -> ASR -> time-indexed RAG
# Synthetic audio is FM-modulated, demodulated by the DSP chain
# (`streaming/dsp.py`, torch on `DEVICE`), "transcribed" by a scripted
# ASR, accumulated, and queried by time.

# %%
from generativeaiexamples_tpu_torch.streaming import replay
from generativeaiexamples_tpu_torch.streaming.accumulator import (
    StreamingStore, TextAccumulator)
from generativeaiexamples_tpu_torch.streaming.asr import FakeASR
from generativeaiexamples_tpu_torch.streaming.chains import StreamingRagChain

store = StreamingStore(HashEmbedder(32))
acc = TextAccumulator(store, chunk_size=48, chunk_overlap=0)
asr = FakeASR(script=["the launch window opens tonight",
                      "weather is clearing on the coast",
                      "all systems are go for liftoff"])
# Narrowband IQ keeps the demo snappy; real SDR rates just change the
# numbers (the DSP chain's filters are built once per receiver).
pump = replay.StreamPump(asr, on_transcript=lambda sid, t: acc.update(sid, t),
                         fs_audio=8_000, fs_iq=48_000, device=DEVICE)
delivered = pump.run(replay.synth_speech_like(3.0, fs=8_000),
                     chunk_time=1.0)
for sid in list(acc.accumulators):
    acc.flush(sid)
print(f"streamed {delivered} transcripts, {len(acc.timestamp_db)} indexed")

llm = EchoLLM(script=[
    ("Classify the intent", '{"intentType": "RecentSummary"}'),
    ("Extract how far back", '{"timeNum": 5, "timeUnit": "minutes"}')])
chain = StreamingRagChain(llm, acc, store, max_docs=8)
print("".join(chain.answer("what happened in the last 5 minutes?"))[:200])

# %% [markdown]
# ## Declarative multi-source ingest

# %%
from generativeaiexamples_tpu_torch.ingest import IngestPipeline, QueueSource
from generativeaiexamples_tpu_torch.rag.splitter import RecursiveCharacterSplitter
from generativeaiexamples_tpu_torch.rag.vectorstore import MemoryVectorStore

bus = QueueSource(source_name="kafka")
bus.push("a streamed message about ring attention on tpu slices")
bus.close()
vstore = MemoryVectorStore(32)
stats = IngestPipeline([bus], RecursiveCharacterSplitter(120, 0),
                       HashEmbedder(32), vstore).run()
print("ingest stats:", stats)

# %% [markdown]
# ## Event-driven CVE analysis

# %%
from generativeaiexamples_tpu_torch.agents.cve import CVEAgent, SBOM, run_cve_pipeline

llm = EchoLLM(script=[
    ("security analyst", "Check the SBOM for dvb-core"),
    ("(no tool results yet)",
     json.dumps({"action": "check_sbom", "input": "dvb-core"})),
    ("check_sbom(dvb-core)",
     json.dumps({"action": "finish", "finding": "component present"})),
    ("Findings:", "VULNERABLE - component deployed"),
])
agent = CVEAgent(llm, sbom=SBOM({"dvb-core": "1.0"}), max_workers=1)
results = run_cve_pipeline(
    ["use-after-free in dvb-core allows privilege escalation"], agent)
print("verdict:", results[0]["verdict"])
