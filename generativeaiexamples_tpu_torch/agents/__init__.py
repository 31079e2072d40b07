"""Agentic pipelines (counterpart of generativeaiexamples_tpu/agents/)."""
