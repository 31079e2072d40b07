"""graftlint check plugins. Adding a check = new module here defining
a `Check` subclass, listed in ALL_CHECKS (docs/static_analysis.md has
the walkthrough)."""

from generativeaiexamples_tpu_torch.lint.checks.trace_purity import \
    TracePurityCheck
from generativeaiexamples_tpu_torch.lint.checks.lock_discipline import \
    LockDisciplineCheck
from generativeaiexamples_tpu_torch.lint.checks.cross_thread import \
    CrossThreadRaceCheck
from generativeaiexamples_tpu_torch.lint.checks.thread_hygiene import (
    ThreadDaemonCheck, ThreadSwallowCheck)
from generativeaiexamples_tpu_torch.lint.checks.host_sync import (
    HostSyncCheck, HostSyncInferredCheck)
from generativeaiexamples_tpu_torch.lint.checks.config_drift import \
    ConfigDriftCheck
from generativeaiexamples_tpu_torch.lint.checks.persistence import \
    AtomicPersistenceCheck
from generativeaiexamples_tpu_torch.lint.checks.metrics_contract import \
    MetricsContractCheck
from generativeaiexamples_tpu_torch.lint.checks.multihost_safety import (
    MultihostPublishCheck, MultihostFetchSeamCheck,
    MultihostDivergenceCheck, MultihostRankBranchCheck)

ALL_CHECKS = [
    TracePurityCheck,
    LockDisciplineCheck,
    CrossThreadRaceCheck,
    ThreadDaemonCheck,
    ThreadSwallowCheck,
    HostSyncCheck,
    HostSyncInferredCheck,
    ConfigDriftCheck,
    AtomicPersistenceCheck,
    MetricsContractCheck,
    MultihostPublishCheck,
    MultihostFetchSeamCheck,
    MultihostDivergenceCheck,
    MultihostRankBranchCheck,
]
