"""Declarative streaming ingest: sources -> chunk -> embed -> store
(counterpart of generativeaiexamples_tpu/ingest/)."""

from generativeaiexamples_tpu_torch.ingest.pipeline import (
    FileSource, IngestPipeline, QueueSource, RSSSource, build_sources)

__all__ = ["IngestPipeline", "FileSource", "RSSSource", "QueueSource",
           "build_sources"]
