"""Pipelines: the pluggable example layer.

Importing this package registers the ported examples (developer_rag;
the other five are queued in ROADMAP A.11(f)).
"""

from generativeaiexamples_tpu_torch.pipelines import developer_rag  # noqa: F401
