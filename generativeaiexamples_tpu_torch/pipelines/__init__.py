"""Pipelines: the pluggable example layer.

Importing this package registers the built-in examples, the seven the
JAX package registers.
"""

from generativeaiexamples_tpu_torch.pipelines import (  # noqa: F401
    api_catalog, developer_rag, knowledge_graph, multi_turn_rag, multimodal,
    query_decomposition, structured_data)
