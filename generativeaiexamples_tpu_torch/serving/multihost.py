"""Tensor-parallel serving runtime over rank processes: dispatch replay.

Counterpart of generativeaiexamples_tpu/serving/multihost.py. The JAX
package serves one host's mesh from ONE process (GSPMD) and needs this
protocol only across hosts; PyTorch runs one process per rank, so here
every tensor-parallel engine, even on one host, is this protocol:

**Dispatch replay.** Collectives pair up by LAUNCH ORDER: every rank
must enter the same forwards in the same sequence or the group
deadlocks. Rank 0 runs the real scheduler (admission, QoS, the radix
tree, the allocator) and publishes a self-describing `(kind, host
arrays)` record of each device dispatch to the coordinator's key-value
store (the process group's TCPStore) *before* launching it; the
follower ranks replay the records through the engine's replay table
(`LLMEngine._mh_replay_table`) on their own shard of the params and the
pool. The vocabulary: `prefill` (batched prefill + first-token
scatter), `plan` (every StepPlan the scheduler runs: decode blocks and
chunks), `seed` (a prefix hit's pool -> scratch gather), `commit` (the
chunked-prefill finish: scratch -> pool scatter + first-token sample),
`pages_out` / `pages_in` / `publish_pages` (page export / import), and
`pager_out` / `pager_in` (the KV pager's demote / promote, each rank
parking only its own kv-head slice), then `stop`. Leader-only state
(the tree, the allocator, QoS) never crosses the wire; only its outputs
(launch order, page-index rows, sampling scalars) do.

Divergence detection is the JAX package's: the follower CRC-chains every
consumed record blob; the leader interleaves a `digest` record every
DIGEST_EVERY publishes and before `stop`; a mismatch raises
`MultihostDivergenceError` naming the record's key and kind instead of
deadlocking at the next collective.

The fetch seams keep the JAX names. A rank's shard is a plain tensor of
its own, so `fetch_replicated` / `fetch_addressable` are host copies and
`fetch_addressable_slice` / `put_local_slice` carry the global index of
the rank's slice (the KV pager's per-rank host and disk tiers).

The replayed profile is the whole serving feature set
(`MULTIHOST_ACCEPTED`): plain decode, chunked prefill, fused-sampling
finishes, speculative verify (linear and tree, with the sampled
request's plain fallback), composed step plans, the fused prefill rider,
the prefix cache and the KV pager. Every StepPlan crosses the wire whole
in its `plan` record; the speculation's device state (the token history,
the device lengths) and the sampler's generator move in step on every
rank because every rank runs the same launches on the same gathered
logits. The one refusal left is the JAX package's: a batch-sharded mesh.
"""

from __future__ import annotations

import base64
import datetime
import io
import logging
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_LOG = logging.getLogger(__name__)

# Key prefix of the dispatch records in the coordinator's store.
_KEY_PREFIX = "gaiemh"
_BARRIER_TIMEOUT_MS = 600_000

# Leader digest cadence: one digest record per DIGEST_EVERY published
# records (plus one before the stop record), so a diverging follower
# fails within a bounded window. The follower window cap only bounds
# memory if a leader never digests.
DIGEST_EVERY = 32
_WINDOW_CAP = 1024


class MultihostError(RuntimeError):
    pass


class MultihostFetchError(MultihostError):
    """A host fetch touched shards owned by another process."""


class MultihostDivergenceError(MultihostError):
    """The follower's consumed record stream does not CRC-match what
    the leader published — replay has diverged; entering the next
    collective would deadlock the group."""


def is_active() -> bool:
    from generativeaiexamples_tpu_torch.parallel.mesh import is_multihost

    return is_multihost()


class StoreClient:
    """The JAX coordination client's key-value and barrier calls over a
    torch.distributed Store (the process group's TCPStore)."""

    def __init__(self, store):
        self.store = store

    def key_value_set(self, key: str, value: str) -> None:
        self.store.set(key, value)

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        try:
            self.store.wait([key], datetime.timedelta(milliseconds=timeout_ms))
        except Exception as e:  # torch's DistStoreError: "wait timeout"
            if "timeout" not in str(e).lower():
                raise
            raise RuntimeError(f"Deadline Exceeded waiting for {key}") from e
        return self.store.get(key).decode("ascii")

    def wait_at_barrier(self, name: str, timeout_ms: int,
                        world_size: int) -> None:
        if int(self.store.add(name, 1)) == world_size:
            self.store.set(name + "/done", "1")
        self.blocking_key_value_get(name + "/done", timeout_ms)


def coordination_client() -> StoreClient:
    """The coordinator's key-value client. Raises if the rank processes'
    process group was never initialized."""
    from generativeaiexamples_tpu_torch.parallel.mesh import (
        coordination_store)

    store = coordination_store()
    if store is None:
        raise MultihostError(
            "the rank processes' process group is not initialized — "
            "engine.multihost needs mesh.coordinator_address/"
            "num_processes/process_id (or the JAX_COORDINATOR_ADDRESS "
            "env), or the launcher's local rank processes")
    return StoreClient(store)


_NAMESPACES = [0]


def next_namespace() -> str:
    """The dispatch-log namespace of this process's next engine: "" for
    the first, then "1", "2", ... (every rank builds its engines in the
    same order, so the ranks of one engine agree)."""
    n = _NAMESPACES[0]
    _NAMESPACES[0] += 1
    return str(n) if n else ""


def barrier(name: str, timeout_ms: int = _BARRIER_TIMEOUT_MS) -> None:
    coordination_client().wait_at_barrier(
        f"{_KEY_PREFIX}_{name}", timeout_ms,
        torch.distributed.get_world_size())


# ---------------------------------------------------------------------------
# Fetch seams
# ---------------------------------------------------------------------------


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def fetch_replicated(arr, seam: str) -> np.ndarray:
    """Host fetch of a value every rank holds in full (sampled tokens,
    scalar flags): the gathered logits make every rank's tokens the same
    bits, so a rank's copy IS the value."""
    return _host(arr)


def fetch_addressable(arr, seam: str) -> np.ndarray:
    """Host fetch of this rank's tensor. A rank's shard is a tensor of
    its own: what it can fetch is exactly its slice (see
    fetch_addressable_slice for the slice's place in the global value)."""
    return _host(arr)


def fetch_addressable_slice(arr, seam: str,
                            index: Optional[Tuple] = None
                            ) -> Tuple[np.ndarray, Tuple]:
    """Per-rank SLICE fetch: (this rank's block on the host, the global
    slice it occupies). `index` is that slice (the caller knows its
    shard: `sharding.shard_slices`); default, the whole array (a rank
    alone, or a replicated value)."""
    out = _host(arr)
    if index is None:
        return out, tuple(slice(0, s) for s in out.shape)
    index = tuple(index)
    want = tuple(s.stop - s.start for s in index)
    if want != tuple(out.shape):
        raise MultihostFetchError(
            f"seam {seam!r}: the rank's block {tuple(out.shape)} does not "
            f"cover its global slice {index}")
    return out, index


def put_local_slice(local: np.ndarray, index: Tuple, global_shape,
                    shard: Tuple, device=None) -> torch.Tensor:
    """Per-rank SLICE restore, the inverse of `fetch_addressable_slice`:
    this rank's shard (the global slice `shard` of `global_shape`) cut
    out of `local` (which covers the global slice `index`), as a tensor
    on `device`. Collective-free: every rank supplies its own bytes."""
    global_shape = tuple(int(s) for s in global_shape)
    base = tuple((s.start or 0) for s in index)
    rel = []
    for d, s in enumerate(shard):
        start = (s.start or 0) - base[d]
        stop = (global_shape[d] if s.stop is None else s.stop) - base[d]
        if start < 0 or stop > local.shape[d]:
            raise MultihostError(
                f"put_local_slice: this rank wants global "
                f"[{(s.start or 0)}:{s.stop}] on dim {d} but the "
                f"local block only covers {index[d]} — the sharding "
                f"does not match the fetched slice")
        rel.append(slice(start, stop))
    block = np.ascontiguousarray(local[tuple(rel)])
    return torch.from_numpy(block).to(device or "cpu")


# ---------------------------------------------------------------------------
# Dispatch-record transport
# ---------------------------------------------------------------------------


def _encode(kind: str, payload: Dict[str, Any]) -> str:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in payload.items()})
    return kind + ":" + base64.b64encode(buf.getvalue()).decode("ascii")


def _decode(blob: str) -> Tuple[str, Dict[str, np.ndarray]]:
    kind, _, b64 = blob.partition(":")
    raw = base64.b64decode(b64.encode("ascii")) if b64 else b""
    if not raw:
        return kind, {}
    with np.load(io.BytesIO(raw)) as z:
        return kind, {k: z[k] for k in z.files}


class DispatchLog:
    """Ordered dispatch-record stream over the coordinator's store.

    Rank 0 `publish`es; followers `next_record` in the same order. Keys
    are a monotone sequence so both sides agree on position without any
    extra coordination; values are npz-in-base64.

    Both sides CRC-chain the record blobs (zlib.crc32, chained — the
    running value at record N commits to every byte of records 0..N).
    The leader interleaves a `digest` record every DIGEST_EVERY
    publishes (and right before `stop`) carrying its (seq, kind, crc)
    window; `next_record` consumes digests transparently and raises
    `MultihostDivergenceError` naming the first diverging key+kind on a
    mismatch. Digest records occupy a sequence slot on both sides but
    are excluded from the CRC chain itself. `consumed` counts every
    record a follower read (digests and stop included), which equals a
    leader's publishes at the end of a clean stream.

    `namespace` keeps the streams of successive engines of one process
    group apart (the store keeps every key for the group's lifetime):
    the engines of a rank take `next_namespace()` in build order, the
    same on every rank; the first is "" (the JAX key names)."""

    def __init__(self, client=None, namespace: str = ""):
        self._client = client if client is not None else coordination_client()
        self._prefix = _KEY_PREFIX + namespace
        self._seq = 0
        self._crc = 0
        self._window: List[Tuple[int, str, int]] = []  # (seq, kind, crc)
        self.consumed = 0
        # Optional hook called with the record kind after each publish
        # (incl. digests): the engine counts replay_records_published.
        self.on_publish = None

    def publish(self, kind: str, **payload) -> None:
        if kind == "stop":
            # The final digest must cover every record before the stop,
            # so a divergence can never hide behind shutdown.
            self._flush_digest()
        blob = _encode(kind, payload)
        self._crc = zlib.crc32(blob.encode("ascii"), self._crc)
        self._window.append((self._seq, kind, self._crc))
        self._client.key_value_set(f"{self._prefix}/{self._seq:09d}", blob)
        self._seq += 1
        if self.on_publish is not None:
            self.on_publish(kind)
        if len(self._window) >= DIGEST_EVERY:
            self._flush_digest()

    def _flush_digest(self) -> None:
        if not self._window:
            return
        blob = _encode("digest", {
            "seqs": np.asarray([s for s, _, _ in self._window], np.int64),
            "kinds": np.asarray([k for _, k, _ in self._window]),
            "crcs": np.asarray([c for _, _, c in self._window], np.uint32),
        })
        self._client.key_value_set(f"{self._prefix}/{self._seq:09d}", blob)
        self._seq += 1
        self._window = []
        if self.on_publish is not None:
            self.on_publish("digest")

    def next_record(
        self, timeout_s: Optional[float] = None,
        poll_s: float = 60.0,
    ) -> Tuple[str, Dict[str, np.ndarray]]:
        """Blocking read of the next record. `timeout_s=None` waits
        forever (idle serving gaps are unbounded), polling in `poll_s`
        chunks so a dead leader is survivable with a finite timeout.
        Digest records are verified and consumed internally — callers
        only ever see dispatch records (and `stop`)."""
        while True:
            key = f"{self._prefix}/{self._seq:09d}"
            waited = 0.0
            while True:
                chunk = poll_s if timeout_s is None else min(
                    poll_s, max(0.001, timeout_s - waited))
                try:
                    blob = self._client.blocking_key_value_get(
                        key, int(chunk * 1000))
                    break
                except Exception as e:  # deadline — keep waiting
                    if "eadline" not in str(e) and "imeout" not in str(e):
                        raise
                    waited += chunk
                    if timeout_s is not None and waited >= timeout_s:
                        raise MultihostError(
                            f"no dispatch record {key} within "
                            f"{timeout_s}s — leader gone?") from e
            seq = self._seq
            self._seq += 1
            self.consumed += 1
            kind, payload = _decode(blob)
            if kind == "digest":
                self._verify_digest(payload)
                continue
            self._crc = zlib.crc32(blob.encode("ascii"), self._crc)
            self._window.append((seq, kind, self._crc))
            if len(self._window) > _WINDOW_CAP:
                del self._window[:-_WINDOW_CAP]
            return kind, payload

    def _verify_digest(self, payload: Dict[str, np.ndarray]) -> None:
        have = {s: (k, c) for s, k, c in self._window}
        # Ascending seq order: the FIRST mismatch is the record where
        # the streams actually diverged (the chained CRC poisons every
        # later entry too).
        for s, kind, crc in zip(payload["seqs"], payload["kinds"],
                                payload["crcs"]):
            s, crc, kind = int(s), int(crc), str(kind)
            if s not in have:
                continue
            mine = int(have[s][1])
            if mine != crc:
                raise MultihostDivergenceError(
                    f"replay divergence at record {self._prefix}/{s:09d} "
                    f"(kind {kind!r}): follower stream CRC {mine:#010x} "
                    f"!= leader {crc:#010x} — the consumed records do "
                    f"not match what rank 0 published; refusing to enter "
                    f"further collectives")
        verified = {int(s) for s in payload["seqs"]}
        self._window = [w for w in self._window if w[0] not in verified]


# ---------------------------------------------------------------------------
# Profile validation + follower loop
# ---------------------------------------------------------------------------


# Features the replay protocol carries in this port, each with the
# mechanism that keeps the ranks in lockstep (the JAX table's names and
# mechanisms; the port has no graftlint check ids).
MULTIHOST_ACCEPTED = (
    ("speculative_k",
     "draft/verify widths ride the plan record (plan_to_record); "
     "acceptance state is device state, identical on every rank"),
    ("step_plans",
     "the chosen StepPlan lattice point crosses the wire in full — "
     "followers never re-derive it from scheduler state"),
    ("fused_prefill",
     "rider chunk tokens/width/slot ride the plan record, published "
     "before the fused launch"),
    ("fused_sampling",
     "sample_token_into params ride the commit record, published "
     "before the fused sample launch"),
    ("prefix_cache",
     "seed/commit records carry the leader's page-index rows; "
     "followers launch the identical gather/scatter without running "
     "the radix tree"),
    ("kv_pager",
     "demote parks each rank's own kv-head slice "
     "(fetch_addressable_slice); promote scatters it back "
     "(put_local_slice) — no rank ever fetches another's shard"),
    ("kv_pager",
     "pager pressure branches stay leader-only; followers replay the "
     "published pager_out/pager_in stream in launch order"),
)


def validate_multihost_profile(ecfg, mesh=None) -> None:
    """Reject engine configs the replay protocol cannot keep in lockstep,
    each with the reason and the fix — a silently-diverging dispatch
    sequence deadlocks the group, which is strictly worse. The whole
    serving feature set is accepted (MULTIHOST_ACCEPTED); the only
    rejection is a batch-sharded mesh."""
    bad = []
    if mesh is not None:
        for ax in ("data", "fsdp"):
            if int(mesh.shape.get(ax, 1)) > 1:
                bad.append(
                    f"mesh {ax} axis = {mesh.shape[ax]}: batch-sharded "
                    f"token outputs are not fully replicated, so rank 0 "
                    f"cannot read sampled tokens through the replicated "
                    f"fetch seam (fetch-seam, GL702); keep {ax}=1 and "
                    f"put devices on tensor/sequence")
    if bad:
        raise MultihostError(
            "engine.multihost=true rejects this config:\n  - "
            + "\n  - ".join(bad))


def run_follower(engine, timeout_s: Optional[float] = None) -> int:
    """Follower main loop: replay the leader's dispatch records until a
    stop record arrives, dispatching each through the engine's replay
    table (kind -> executor). Blocks the calling thread (a follower
    rank's main loop — followers serve no HTTP). A stream divergence
    bumps the engine's replay_divergence counter and re-raises — the
    caller must NOT swallow it and keep serving. Returns the dispatch
    records replayed."""
    log = engine._mh_log
    if log is None:
        raise MultihostError("engine was not built with multihost=true")
    # A replaying engine is by definition not the leader: the record
    # executors publish when `_mh_leader` is set.
    engine._mh_leader = False
    table = engine._mh_replay_table()
    n = 0
    while True:
        try:
            kind, payload = log.next_record(timeout_s=timeout_s)
        except MultihostDivergenceError:
            metrics = getattr(engine, "metrics", None)
            if metrics is not None:
                metrics.replay_divergence += 1
            raise
        if kind == "stop":
            _LOG.info("follower: stop record after %d dispatches", n)
            return n
        fn = table.get(kind)
        if fn is None:
            raise MultihostError(
                f"unknown dispatch record kind {kind!r} — leader and "
                f"follower builds disagree on the replay vocabulary")
        fn(payload)
        n += 1
