"""graftlint for the PyTorch port: serving-aware static analysis.

Counterpart of generativeaiexamples_tpu/lint/, file for file, with its
own copy of every module (the port imports nothing of the JAX package).
It parses source and imports neither torch nor jax.

The serving stack is heavily multithreaded (engine scheduler and pacer
threads, micro-batcher dispatchers, single-flight sidecar writers,
background k-means) and launches device work asynchronously from the
scheduler thread. The bug classes that sink such systems — attributes
mutated both with and without their lock, a stray `.item()` or
`.cpu()` that stalls the dispatch pipeline, a launch that skips the
multihost replay log, broad `except` swallowing on daemon threads,
config knobs drifting out of the generated docs — are invisible to
pytest. graftlint is the AST-based pass that makes them visible:

- ``python -m generativeaiexamples_tpu_torch.lint <paths>`` runs every
  check; exit 0 = clean, 1 = findings, 2 = usage error. ``--changed``
  scopes to git-diffed files + their reverse call-graph dependents;
  ``--explain-hot-path <func>`` prints the root->func chain behind the
  inferred hot set; ``--explain-dispatch-site <func>`` the GL701
  inventory; ``--format sarif`` feeds CI code annotations.
- The check ids, messages and severities of the framework-neutral
  checks (GL201/202 locks and races, GL301/302 threads, GL501/505/506
  config drift, GL502 persistence, GL601 metrics) are the JAX
  linter's. Four are rewritten in torch's vocabulary under the same
  ids: GL101 capture purity (CUDA graph capture, make_graphed_callables,
  torch.compile), GL401/GL402 host syncs (`.item()`, `.cpu()`,
  `.numpy()`, `.tolist()`, `synchronize`, `float()` of a tensor) and
  GL701-GL704 multihost replay safety (dispatch entries named in
  callgraph.py's `DISPATCH_ENTRIES` instead of jit decorators).
- Justified findings live in the checked-in ``lint-baseline-torch.json``
  (content-hash keyed, so line drift and file moves don't invalidate
  suppressions), each with a human reason string; the JAX package's
  ``lint-baseline.json`` is not read.
- ``tests/test_torch_lint.py`` gates regressions: every check fires on
  its seeded-violation fixture, the neutral checks equal the JAX
  linter's findings on shared fixtures, and the shipped port tree has
  zero non-baselined findings.
"""

from generativeaiexamples_tpu_torch.lint.core import (  # noqa: F401
    Finding, Project, SourceFile, all_checks, load_project, run_checks)
from generativeaiexamples_tpu_torch.lint.baseline import (  # noqa: F401
    Baseline)
from generativeaiexamples_tpu_torch.lint.cli import (  # noqa: F401
    lint_paths, main)
