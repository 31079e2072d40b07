"""Streaming RAG's voice seam (the rest of the JAX `streaming/` package
is not ported yet: ROADMAP A.20)."""
