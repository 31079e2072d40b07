"""Streaming RAG: the continuous-ingest path of the fm-asr app.

Counterpart of generativeaiexamples_tpu/streaming/: live signal -> FM
demod and resampling in torch on the card (dsp.py) -> ASR (asr.py, a
client seam) -> incremental text accumulation -> a time-indexed store
answered by relevance, recency or a past time window (chains.py) behind
an SSE server (server.py). replay.py is the file-replay source, over UDP
into the native ring (native/ring.py) or in-process.
"""

from generativeaiexamples_tpu_torch.streaming.accumulator import (
    TextAccumulator)
from generativeaiexamples_tpu_torch.streaming.chains import (
    StreamingRagChain, TimeResponse, UserIntent)
from generativeaiexamples_tpu_torch.streaming.timestamps import (
    TimestampDatabase)

__all__ = ["TextAccumulator", "TimestampDatabase", "StreamingRagChain",
           "TimeResponse", "UserIntent"]
