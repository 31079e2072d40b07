"""Port parity and gate: graftlint's torch side
(generativeaiexamples_tpu_torch/lint/).

- Every check fires on its seeded-violation fixture and stays quiet on
  its clean twin. The framework-neutral checks (GL2xx, GL3xx, GL5xx,
  GL601) run on the JAX suite's own fixtures (tests/test_lint.py), and
  their findings equal the JAX linter's: check, file, line and message.
  The torch rewrites (GL101 capture purity, GL401/402 host syncs,
  GL701-704 multihost replay) run on torch fixtures.
- The dispatch inventory names the JAX inventory's entries, but for the
  differences listed below with their reasons.
- The baseline, suppression and CLI machinery behave as JAX's; the CLI
  runs as a subprocess with the repo on PYTHONPATH, from any cwd.
- The shipped port tree has zero non-baselined findings against
  lint-baseline-torch.json, no stale entry, and a reason on every entry.

Pure AST work: nothing here touches a device.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

import test_lint as jt
from generativeaiexamples_tpu.lint import lint_paths as jax_lint_paths
from generativeaiexamples_tpu_torch.lint import Baseline, lint_paths
from generativeaiexamples_tpu_torch.lint.cli import UsageError, resolve_checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "generativeaiexamples_tpu_torch")
BASELINE = os.path.join(REPO, "lint-baseline-torch.json")
CLI = [sys.executable, "-m", "generativeaiexamples_tpu_torch.lint"]
ENV = {**os.environ, "PYTHONPATH": os.pathsep.join(
    p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)}
ALL_IDS = ("GL101", "GL201", "GL202", "GL301", "GL302", "GL401", "GL402",
           "GL501", "GL502", "GL601", "GL701", "GL702", "GL703", "GL704")
NEUTRAL = ("GL201", "GL202", "GL301", "GL302", "GL501", "GL502", "GL601")
GL70X = ("GL701", "GL702", "GL703", "GL704")

write_tree = jt.write_tree
ids_of = jt.ids_of


def run_cli(*args, cwd=None):
    return subprocess.run(CLI + list(args), cwd=cwd or REPO, text=True,
                          capture_output=True, timeout=120, env=ENV)


@pytest.fixture(scope="module")
def port_project():
    """The port's tree, parsed once (its call graph memoizes on it)."""
    from generativeaiexamples_tpu_torch.lint.core import load_project

    return load_project([PKG])


@pytest.fixture(scope="module")
def jax_project():
    from generativeaiexamples_tpu.lint.core import load_project

    return load_project([os.path.join(REPO, "generativeaiexamples_tpu")])


@pytest.fixture(scope="module")
def port_findings(port_project):
    """Every finding on the port's tree, no baseline."""
    from generativeaiexamples_tpu_torch.lint.core import run_checks

    return run_checks(port_project)


# ---------------------------------------------------------------------------
# torch fixtures: one seeded violation + one clean twin per torch check
# ---------------------------------------------------------------------------

TRACE_BAD = """\
    import numpy as np
    import torch


    def capture(g, x: torch.Tensor, static_out):
        with torch.cuda.graph(g):
            y = x * 2
            v = y.item()            # host sync in a capture
            if y.sum() > 0:         # branch on a tensor's value
                y = y + 1
            static_out.copy_(y)
        return v


    @torch.compile
    def step(x, n):
        f = float(x)                # concretization
        a = np.asarray(x)           # host materialization
        return x, f, a


    def body(x):
        return x.cpu()              # graphed callable syncs


    graphed = torch.cuda.make_graphed_callables(body, (torch.zeros(4),))
"""

TRACE_CLEAN = """\
    import torch


    def capture(g, x: torch.Tensor, static_out, n):
        with torch.cuda.graph(g):
            y = torch.where(x > 0, x * 2, x)
            if y.dim() > 1:         # metadata: static
                y = y.reshape(-1)
            if n > 2:               # a host int: static
                y = y + 1
            static_out.copy_(y)
        return float(static_out.sum())  # after the capture: fine


    @torch.compile
    def step(x, y=None):
        if y is None:               # identity test: static
            y = torch.zeros_like(x)
        if x.shape[0] > 1:          # shape metadata: static
            x = x[:1]
        return x + y + float(1.5)   # literal coercion: fine


    def host_side(x):
        return x.cpu().numpy()      # not captured: fine
"""

HOT_BAD = """\
    import numpy as np
    import torch


    class Engine:
        def __init__(self):
            self._tokens = torch.zeros(4, dtype=torch.int32)

        def _step(self):  # graftlint: hot-path
            torch.cuda.synchronize()
            n = self._tokens.item()
            host = self._tokens.cpu()
            out = np.asarray(self._tokens)
            return n, host, out
"""

HOT_CLEAN = """\
    import torch


    class Engine:
        def __init__(self):
            self._tokens = torch.zeros(4, dtype=torch.int32)
            self._n_beats = 0

        def warmup(self):  # not a hot path: syncs are fine here
            torch.cuda.synchronize()
            return self._tokens.cpu()

        def _step(self):  # graftlint: hot-path
            n = int(self._n_beats)   # a host int: no device
            return self._dispatch(n)  # async launch only
"""

# GL402: the syncs live in a helper the root reaches only through the
# call graph (self-dispatch + a module-level function).
INFER_BAD = """\
    import torch


    def fetch_stats(t: torch.Tensor):
        return t.tolist()


    class Engine:
        def __init__(self):
            self._tokens = torch.zeros(4)

        def _loop(self):
            while True:
                self._dispatch()

        def _dispatch(self):
            torch.cuda.current_stream().synchronize()  # helper, not a root
            return fetch_stats(self._tokens)
"""

INFER_CLEAN = """\
    import torch


    def fetch_stats(t: torch.Tensor):
        return t.tolist()  # never called from a hot root


    class Engine:
        def __init__(self):
            self._tokens = torch.zeros(4)

        def _loop(self):
            while True:
                self._dispatch()

        def _dispatch(self):
            return self._issue()  # async; syncs stay off this path

        def _issue(self):
            return 1

        def debug_dump(self):
            return fetch_stats(self._tokens)  # cold path: fine
"""

# GL70x: files named engine.py so `_loop` is the scheduler root; the
# dispatch entry is marked `# graftlint: dispatch` on its def line.
MH_PUBLISH_BAD = """\
    import torch


    def plan_step(state, n):  # graftlint: dispatch
        return state + n


    class DispatchLog:
        def publish(self, kind, **rec):
            return rec


    class Engine:
        def __init__(self):
            self._mh_log = DispatchLog()
            self._state = torch.zeros(4)

        def _loop(self):
            self._dispatch_plan(1)

        def _dispatch_plan(self, n):
            out = plan_step(self._state, n)      # launched first ...
            self._mh_log.publish("plan", n=n)    # ... published after
            return out
"""

# The clean twin publishes through a one-line wrapper, the port
# engine's `_publish` shape, before it launches.
MH_PUBLISH_CLEAN = """\
    import torch


    def plan_step(state, n):  # graftlint: dispatch
        return state + n


    class DispatchLog:
        def publish(self, kind, **rec):
            return rec


    class Engine:
        def __init__(self):
            self._mh_log = DispatchLog()
            self._mh_leader = True
            self._state = torch.zeros(4)

        def _loop(self):
            self._dispatch_plan(1)

        def _publish(self, kind, rec):
            if self._mh_log is not None and self._mh_leader:
                self._mh_log.publish(kind, **rec)

        def _dispatch_plan(self, n):
            self._publish("plan", {"n": n})      # publish, THEN launch
            return plan_step(self._state, n)
"""

MH_FETCH_BAD = """\
    import torch


    class Engine:
        def __init__(self):
            self._last = torch.zeros(4, dtype=torch.int32)

        def _loop(self):
            self._emit()

        def _emit(self):
            return self._last.cpu()  # bypasses the fetch seams
"""

MH_FETCH_CLEAN = """\
    import torch


    def _host(t):
        return t.detach().cpu().numpy()  # inside the seam


    def fetch_replicated(arr, seam):
        return _host(arr)


    class Engine:
        def __init__(self):
            self._last = torch.zeros(4, dtype=torch.int32)

        def _loop(self):
            self._emit()

        def _emit(self):
            return fetch_replicated(self._last, "emit")
"""

MH_DIVERGE_BAD = """\
    import time

    import torch


    def plan_step(state, n):  # graftlint: dispatch
        return state + n


    class DispatchLog:
        def publish(self, kind, **rec):
            return rec


    class Engine:
        def __init__(self):
            self._mh_log = DispatchLog()
            self._tiers = {"bulk", "interactive"}
            self._state = torch.zeros(4)

        def _loop(self):
            n = self._pick_width()
            self._mh_log.publish("plan", n=n)
            plan_step(self._state, n)

        def _pick_width(self):
            for tier in self._tiers:               # unordered iteration
                if tier == "interactive":
                    return 1
            return int(time.perf_counter()) % 4    # wall-clock decision
"""

MH_DIVERGE_CLEAN = """\
    import torch


    def plan_step(state, n):  # graftlint: dispatch
        return state + n


    class DispatchLog:
        def publish(self, kind, **rec):
            return rec


    class Engine:
        def __init__(self):
            self._mh_log = DispatchLog()
            self._widths = [1, 2, 4]
            self._state = torch.zeros(4)

        def _loop(self):
            n = self._pick_width()
            self._mh_log.publish("plan", n=n)
            plan_step(self._state, n)

        def _pick_width(self):
            return self._widths[0]   # deterministic scheduler state
"""

MH_RANK_BAD = """\
    import torch


    def plan_step(state, n):  # graftlint: dispatch
        return state + n


    class DispatchLog:
        def publish(self, kind, **rec):
            return rec


    class Engine:
        def __init__(self):
            self._mh_log = DispatchLog()
            self._state = torch.zeros(4)

        def _loop(self):
            self._mh_log.publish("plan")
            if torch.distributed.get_rank() == 0:
                plan_step(self._state, 1)   # guarded launch: ranks diverge
"""

MH_RANK_CLEAN = """\
    import torch


    def plan_step(state, n):  # graftlint: dispatch
        return state + n


    class DispatchLog:
        def publish(self, kind, **rec):
            return rec


    class Engine:
        def __init__(self):
            self._mh_log = DispatchLog()
            self.rank = torch.distributed.get_rank()
            self._state = torch.zeros(4)

        def _loop(self):
            if self.rank == 0:                   # rank-guarded PUBLISH
                self._mh_log.publish("plan")     # is the protocol: quiet
            plan_step(self._state, 1)            # launch on every rank
"""

# The dispatch table (callgraph.DISPATCH_ENTRIES) names entries by
# module: `decode_multi_step` in engine_model.py, launched from
# engine.py.
TABLE_ENGINE_MODEL = """\
    import torch


    def decode_multi_step(state, n):
        return state + n
"""

TABLE_ENGINE = """\
    from pkg import engine_model


    class Engine:
        def _loop(self):
            engine_model.decode_multi_step(self._state, 1)  # unpublished
"""


# ---------------------------------------------------------------------------
# the torch rewrites
# ---------------------------------------------------------------------------


class TestCapturePurity:
    def test_fires_on_seeded_violations(self, tmp_path):
        findings = lint_paths([write_tree(tmp_path, {"mod.py": TRACE_BAD})])
        gl101 = [f for f in findings if f.check == "GL101"]
        # .item() + tensor if in the capture; float() + np.asarray in
        # the compiled step; .cpu() in the graphed callable
        assert len(gl101) == 5, [f.format() for f in gl101]
        msgs = " ".join(f.message for f in gl101)
        for shape in (".item()", "float()", "np.asarray()", ".cpu()",
                      "`if`"):
            assert shape in msgs, shape

    def test_quiet_on_clean(self, tmp_path):
        findings = lint_paths([write_tree(tmp_path, {"mod.py": TRACE_CLEAN})])
        assert ids_of(findings) == set(), [f.format() for f in findings]

    def test_quiet_on_the_port_tree(self, port_findings):
        """The port captures nothing yet: the check guards A.22."""
        assert [f for f in port_findings if f.check == "GL101"] == []


class TestHostSync:
    def test_fires_in_marked_hot_path(self, tmp_path):
        findings = lint_paths([write_tree(tmp_path, {"mod.py": HOT_BAD})])
        gl401 = [f for f in findings if f.check == "GL401"]
        # synchronize + item + cpu + asarray
        assert len(gl401) == 4, [f.format() for f in gl401]

    def test_item_in_the_engine_loop_fires_without_marker(self, tmp_path):
        src = HOT_BAD.replace("def _step(self):  # graftlint: hot-path",
                              "def _loop(self):")
        findings = lint_paths([write_tree(tmp_path, {"engine.py": src})])
        gl401 = [f for f in findings if f.check == "GL401"]
        assert any(".item()" in f.message for f in gl401)

    def test_quiet_outside_hot_path(self, tmp_path):
        findings = lint_paths([write_tree(tmp_path, {"mod.py": HOT_CLEAN})])
        assert ids_of(findings) == set(), [f.format() for f in findings]

    @pytest.mark.parametrize("fname,fn", [
        ("engine.py", "_loop"), ("batcher.py", "_run"),
        ("router.py", "place"), ("fleet.py", "submit"),
        ("qos.py", "pick"), ("tiered.py", "search"),
        ("autoscaler.py", "tick"), ("autoscaler.py", "wake_for_submit")])
    def test_all_declared_roots_apply(self, tmp_path, fname, fn):
        src = HOT_BAD.replace("def _step(self):  # graftlint: hot-path",
                              f"def {fn}(self):")
        root = write_tree(tmp_path, {fname: src})
        assert "GL401" in ids_of(lint_paths([root])), (fname, fn)

    def test_roots_equal_jax(self):
        from generativeaiexamples_tpu.lint.checks import host_sync as jhs
        from generativeaiexamples_tpu_torch.lint.checks import host_sync

        assert host_sync.HOT_ROOTS == jhs.HOT_ROOTS

    def test_sanctioned_fetch_is_not_scanned(self, tmp_path):
        """HostCopy.numpy waits on its CUDA event by design; a copy of
        its body under another name fires. (The `.numpy()` call sites in
        the loop fire GL401: the port baselines each with its reason.)"""
        src = textwrap.dedent("""\
            class HostCopy:
                def numpy(self):
                    if self.event is not None:
                        self.event.synchronize()
                    return self.host.numpy()

                def fetch(self):
                    self.event.synchronize()
                    return self.host.numpy()


            class Engine:
                def __init__(self):
                    self.copy = HostCopy()

                def _loop(self):
                    self.copy.numpy()
                    self.copy.fetch()
        """)
        findings = lint_paths([write_tree(tmp_path, {"engine.py": src})])
        lines = {f.line for f in findings if f.check == "GL402"}
        assert lines == {8, 9}, [f.format() for f in findings]
        assert {f.line for f in findings if f.check == "GL401"} == {17}


class TestHotPathInference:
    def test_fires_through_the_call_graph(self, tmp_path):
        findings = lint_paths([write_tree(tmp_path,
                                          {"engine.py": INFER_BAD})])
        gl402 = [f for f in findings if f.check == "GL402"]
        assert len(gl402) == 2, [f.format() for f in gl402]
        msgs = " ".join(f.message for f in gl402)
        assert "hot via" in msgs
        assert "engine.py:Engine._loop" in msgs
        assert ".tolist()" in msgs and "synchronize()" in msgs

    def test_quiet_off_the_hot_graph(self, tmp_path):
        findings = lint_paths([write_tree(tmp_path,
                                          {"engine.py": INFER_CLEAN})])
        assert ids_of(findings) == set()

    def test_port_hot_set_covers_the_jax_markers(self, port_project,
                                                 jax_project):
        """The port carries the JAX tree's `# graftlint: hot-path`
        markers on its counterparts (all but the multihost fetch seams,
        whose job is the host fetch): every function JAX marks and the
        port has is in the port's declared hot set."""
        from generativeaiexamples_tpu.lint import callgraph as jcg
        from generativeaiexamples_tpu.lint.checks import host_sync as jhs
        from generativeaiexamples_tpu_torch.lint import callgraph
        from generativeaiexamples_tpu_torch.lint.checks import host_sync

        jg = jcg.build(jax_project)
        g = callgraph.build(port_project)
        want = {k for k in jhs.hot_root_keys(jg)
                if not k.startswith("serving/multihost.py::")}
        have = host_sync.hot_root_keys(g)
        missing = {k for k in want - have if k in g.nodes}
        assert not missing, sorted(missing)
        # the one JAX-marked function the port does not have
        assert sorted(k for k in want if k not in g.nodes) == [
            "serving/engine.py::LLMEngine._flight_first"]


class TestMultihostPublish:
    def test_fires_on_publish_after_launch(self, tmp_path):
        findings = lint_paths(
            [write_tree(tmp_path, {"engine.py": MH_PUBLISH_BAD})])
        gl701 = [f for f in findings if f.check == "GL701"]
        assert len(gl701) == 1, [f.format() for f in findings]
        msg = gl701[0].message
        assert "plan_step" in msg and "DispatchLog.publish" in msg
        assert "Engine._loop" in msg and "Engine._dispatch_plan" in msg
        assert "--explain-dispatch-site" in msg

    def test_quiet_when_published_through_the_wrapper_first(self, tmp_path):
        findings = lint_paths(
            [write_tree(tmp_path, {"engine.py": MH_PUBLISH_CLEAN})])
        assert ids_of(findings) == set(), [f.format() for f in findings]

    def test_wrapper_after_the_launch_fires(self, tmp_path):
        src = MH_PUBLISH_CLEAN.replace(
            '            self._publish("plan", {"n": n})      # publish, '
            'THEN launch\n            return plan_step(self._state, n)\n',
            '            out = plan_step(self._state, n)\n'
            '            self._publish("plan", {"n": n})\n'
            '            return out\n')
        assert src != MH_PUBLISH_CLEAN
        findings = lint_paths([write_tree(tmp_path, {"engine.py": src})])
        assert [f.check for f in findings] == ["GL701"]

    def test_table_entry_launch_fires(self, tmp_path):
        findings = lint_paths([write_tree(tmp_path, {
            "pkg/__init__.py": "", "pkg/engine_model.py": TABLE_ENGINE_MODEL,
            "pkg/engine.py": TABLE_ENGINE})])
        gl701 = [f for f in findings if f.check == "GL701"]
        assert len(gl701) == 1 and "decode_multi_step" in gl701[0].message


class TestMultihostFetchSeam:
    def test_fires_on_cpu_off_the_seam(self, tmp_path):
        findings = lint_paths(
            [write_tree(tmp_path, {"engine.py": MH_FETCH_BAD})])
        gl702 = [f for f in findings if f.check == "GL702"]
        assert len(gl702) == 1, [f.format() for f in findings]
        assert ".cpu()" in gl702[0].message
        assert "fetch_replicated" in gl702[0].message

    def test_quiet_through_the_seam_and_what_it_calls(self, tmp_path):
        """The seam and its helper are quiet under GL702. (On the
        scheduler thread the seam's fetch is still a host sync: GL402
        sees it, which is why the engine reads through HostCopy.)"""
        root = write_tree(tmp_path, {"engine.py": MH_FETCH_CLEAN})
        assert lint_paths([root], select=GL70X) == []
        assert ids_of(lint_paths([root])) == {"GL402"}


class TestMultihostDivergence:
    def test_fires_on_clock_and_set_iteration(self, tmp_path):
        findings = lint_paths(
            [write_tree(tmp_path, {"engine.py": MH_DIVERGE_BAD})])
        gl703 = [f for f in findings if f.check == "GL703"]
        msgs = " ".join(f.message for f in gl703)
        assert len(gl703) == 2, [f.format() for f in findings]
        assert "wall-clock" in msgs and "unordered set" in msgs

    def test_quiet_on_deterministic_decision(self, tmp_path):
        findings = lint_paths(
            [write_tree(tmp_path, {"engine.py": MH_DIVERGE_CLEAN})])
        assert ids_of(findings) == set()


class TestMultihostRankBranch:
    def test_fires_on_a_launch_under_rank_zero(self, tmp_path):
        findings = lint_paths(
            [write_tree(tmp_path, {"engine.py": MH_RANK_BAD})])
        gl704 = [f for f in findings if f.check == "GL704"]
        assert len(gl704) == 1, [f.format() for f in findings]
        assert "plan_step" in gl704[0].message

    def test_rank_guarded_publish_is_quiet(self, tmp_path):
        findings = lint_paths(
            [write_tree(tmp_path, {"engine.py": MH_RANK_CLEAN})])
        assert ids_of(findings) == set(), [f.format() for f in findings]


class TestDispatchInventory:
    # Entries that differ between the two inventories, each with why.
    JAX_ONLY = {
        # jitted top-k over one chunk; the port computes it inline in
        # centroid_candidates, an entry in both packages
        "ops/ivf.py::_chunk_candidates",
        # JAX's jit shell over _score_probed; the port calls
        # _score_probed directly
        "ops/ivf.py::_ivf_search",
    }
    PORT_ONLY = {
        # the probed scan: the port's entry for JAX's _ivf_search
        "ops/ivf.py::_score_probed",
        # calls _score_probed in its module, so the closure adds it;
        # JAX's sharded search launches a cached shard_map program
        # the call graph cannot resolve
        "ops/ivf.py::ShardedIVFIndex.search",
        # the port's shared helper over assign_partitions; JAX inlines
        # its two rules in their callers
        "ops/ivf.py::extend_assignments",
    }

    def test_entries_equal_jax_but_the_listed_ones(self, port_project,
                                                   jax_project):
        from generativeaiexamples_tpu.lint.checks.multihost_safety import \
            inventory_for as jax_inventory
        from generativeaiexamples_tpu_torch.lint.checks.multihost_safety \
            import inventory_for

        want = set(jax_inventory(jax_project).entries)
        got = set(inventory_for(port_project).entries)
        assert len(want) == 47
        assert want - got == self.JAX_ONLY
        assert got - want == self.PORT_ONLY

    def test_scheduler_reaches_the_replayed_dispatches(self, port_project):
        """The entries engine._loop (and the control-op seam) dispatch
        are JAX's eleven, each published before it launches."""
        from generativeaiexamples_tpu_torch.lint import callgraph
        from generativeaiexamples_tpu_torch.lint.checks.multihost_safety \
            import inventory_for

        inv = inventory_for(port_project)
        reachable = {callgraph.entry_name(dst)
                     for _, _, dst in inv.reachable_sites()}
        assert reachable == {
            "cache_to_pool", "pages_to_pool", "plan_step", "pool_to_cache",
            "pool_to_pages", "prefill_batch_step", "sample_token",
            "sample_token_into", "set_history_rows", "set_last_token",
            "set_last_tokens"}


# ---------------------------------------------------------------------------
# the framework-neutral checks: the JAX suite's fixtures, the JAX findings
# ---------------------------------------------------------------------------

NEUTRAL_TREES = {
    "lock_bad": {"mod.py": jt.LOCK_BAD},
    "lock_clean": {"mod.py": jt.LOCK_CLEAN},
    "thread_bad": {"mod.py": jt.THREAD_BAD},
    "thread_clean": {"mod.py": jt.THREAD_CLEAN},
    "race_bad": {"mod.py": jt.RACE_BAD},
    "race_clean": {"mod.py": jt.RACE_CLEAN},
    "docstring_bad": {"mod.py": jt.DOCSTRING_BAD},
    "metrics_bad": {"mod.py": jt.METRICS_BAD},
    "metrics_clean": {"mod.py": jt.METRICS_CLEAN},
    "hist_bad": {"mod.py": jt.HIST_METRICS_BAD},
    "hist_clean": {"mod.py": jt.HIST_METRICS_CLEAN},
    "persist_bad": {"mod.py": jt.PERSIST_BAD},
    "persist_clean": {"mod.py": jt.PERSIST_CLEAN},
    "config_bad": {"pkg/config/schema.py": jt.CONFIG_SCHEMA,
                   "pkg/app.py": jt.CONFIG_APP_BAD,
                   "docs/configuration.md": jt.CONFIG_DOCS_MISSING_BETA},
    "config_clean": {"pkg/config/schema.py": jt.CONFIG_SCHEMA,
                     "pkg/app.py": jt.CONFIG_APP_CLEAN,
                     "docs/configuration.md": jt.CONFIG_DOCS_FULL},
}
NEUTRAL_EXPECT = {  # the checks each bad tree must raise
    "lock_bad": {"GL201"}, "thread_bad": {"GL301", "GL302"},
    "race_bad": {"GL202"}, "docstring_bad": {"GL202"},
    "metrics_bad": {"GL601"}, "hist_bad": {"GL601"},
    "persist_bad": {"GL502"}, "config_bad": {"GL501", "GL505", "GL506"},
}


def _rows(findings):
    return [(f.check, f.path, f.line, f.message, f.severity)
            for f in findings]


@pytest.mark.parametrize("name", sorted(NEUTRAL_TREES))
def test_neutral_findings_equal_the_jax_linter(tmp_path, name):
    root = write_tree(tmp_path, NEUTRAL_TREES[name])
    got = lint_paths([root], select=NEUTRAL)
    want = jax_lint_paths([root], select=NEUTRAL)
    assert _rows(got) == _rows(want)
    assert ids_of(got) == NEUTRAL_EXPECT.get(name, set()), \
        [f.format() for f in got]


def test_neutral_findings_equal_jax_on_the_port_tree(port_findings):
    """The JAX linter's neutral checks over the port's own tree, no
    baseline, equal the port linter's: none (the port's suppressions
    are JAX's)."""
    # GL501's plugin also emits GL505 / GL506
    got = [f for f in port_findings
           if f.check in NEUTRAL + ("GL505", "GL506")]
    want = jax_lint_paths([PKG], select=NEUTRAL)
    assert _rows(got) == _rows(want) == []


def test_check_catalog_equals_jax():
    from generativeaiexamples_tpu.lint.core import all_checks as jax_checks
    from generativeaiexamples_tpu_torch.lint.core import all_checks

    got = [(c.id, c.name, c.severity) for c in all_checks()]
    assert got == [(c.id, c.name, c.severity) for c in jax_checks()]
    assert tuple(c.id for c in all_checks()) == ALL_IDS


# ---------------------------------------------------------------------------
# suppression, baseline, selection
# ---------------------------------------------------------------------------


class TestSuppression:
    def test_inline_ignore_on_finding_line(self, tmp_path):
        src = HOT_BAD.replace("n = self._tokens.item()",
                              "n = self._tokens.item()  "
                              "# graftlint: ignore[GL401]")
        got = [f for f in lint_paths([write_tree(tmp_path, {"mod.py": src})])
               if ".item()" in f.message]
        assert got == []

    def test_inline_ignore_on_def_line_covers_function(self, tmp_path):
        src = HOT_BAD.replace("def _step(self):  # graftlint: hot-path",
                              "def _step(self):  # graftlint: hot-path "
                              "# graftlint: ignore[GL401]")
        assert ids_of(lint_paths([write_tree(tmp_path,
                                             {"mod.py": src})])) == set()

    def test_inline_ignore_wrong_id_keeps_finding(self, tmp_path):
        src = jt.LOCK_BAD.replace(
            "self._n = 0  # bare write to a lock-guarded attribute",
            "self._n = 0  # graftlint: ignore[GL999]")
        assert "GL201" in ids_of(
            lint_paths([write_tree(tmp_path, {"mod.py": src})]))


class TestBaseline:
    def test_roundtrip_suppresses(self, tmp_path):
        findings = lint_paths([write_tree(tmp_path, {"mod.py": HOT_BAD})])
        assert findings
        bl = Baseline.from_findings(findings)
        assert bl.filter(findings) == []
        assert bl.unused_entries() == []

    def test_save_load_roundtrip(self, tmp_path):
        findings = lint_paths([write_tree(tmp_path / "a",
                                          {"mod.py": jt.LOCK_BAD})])
        path = str(tmp_path / "baseline.json")
        Baseline.from_findings(findings).save(path)
        bl = Baseline.load(path)
        assert bl.filter(findings) == []
        data = json.load(open(path))
        assert data["version"] == 1
        assert all({"check", "file", "line", "hash", "reason"}
                   <= set(e) for e in data["entries"])

    def test_line_drift_and_file_move_tolerated(self, tmp_path):
        findings = lint_paths([write_tree(tmp_path / "a",
                                          {"mod.py": HOT_BAD})])
        bl = Baseline.from_findings(findings)
        drifted = "# pad\n" * 7 + textwrap.dedent(HOT_BAD)
        f2 = lint_paths([write_tree(tmp_path / "b",
                                    {"moved/renamed.py": drifted})])
        assert f2 and f2[0].line != findings[0].line
        assert bl.filter(f2) == []

    def test_edited_line_invalidates(self, tmp_path):
        findings = lint_paths([write_tree(tmp_path / "a",
                                          {"mod.py": HOT_BAD})])
        bl = Baseline.from_findings(findings)
        edited = HOT_BAD.replace("n = self._tokens.item()",
                                 "m = self._tokens.item()")
        f2 = lint_paths([write_tree(tmp_path / "b", {"mod.py": edited})])
        assert len(bl.filter(f2)) == 1

    def test_regenerate_preserves_curated_reasons(self, tmp_path):
        findings = lint_paths([write_tree(tmp_path / "a",
                                          {"mod.py": jt.LOCK_BAD})])
        bl = Baseline.from_findings(findings)
        bl.entries[0]["reason"] = "carefully justified"
        regen = Baseline.from_findings(findings, previous=Baseline(
            bl.entries))
        assert regen.entries[0]["reason"] == "carefully justified"

    def test_the_port_reads_its_own_baseline_file(self, tmp_path):
        """Discovery finds lint-baseline-torch.json, never the JAX
        package's lint-baseline.json beside it."""
        root = write_tree(tmp_path, {"pkg/mod.py": jt.LOCK_BAD})
        findings = lint_paths([root])
        Baseline.from_findings(findings).save(
            str(tmp_path / "lint-baseline.json"))
        assert Baseline.discover([root]) is None
        Baseline.from_findings(findings).save(
            str(tmp_path / "lint-baseline-torch.json"))
        assert Baseline.discover([root]).filter(findings) == []


class TestSeverityAndSelection:
    def test_min_severity_filters_warnings(self, tmp_path):
        root = write_tree(tmp_path, {"mod.py": HOT_BAD})
        assert "GL401" in ids_of(lint_paths([root]))
        assert ids_of(lint_paths([root], min_severity="error")) == set()

    def test_select_and_ignore(self, tmp_path):
        root = write_tree(tmp_path, {"lk.py": jt.LOCK_BAD,
                                     "tr.py": TRACE_BAD})
        assert ids_of(lint_paths([root], select=["GL101"])) == {"GL101"}
        rest = lint_paths([root], ignore=["GL101"])
        assert "GL101" not in ids_of(rest) and "GL201" in ids_of(rest)

    def test_unknown_check_id_rejected(self):
        with pytest.raises(UsageError):
            resolve_checks(["GL999"], None)

    def test_syntax_error_surfaces_as_finding(self, tmp_path):
        root = write_tree(tmp_path, {"broken.py": "def f(:\n"})
        assert ids_of(lint_paths([root])) == {"GL000"}


# ---------------------------------------------------------------------------
# CLI exit-code contract: 0 clean, 1 findings, 2 usage error
# ---------------------------------------------------------------------------


class TestCLI:
    @pytest.mark.parametrize("check_id,files", [
        ("GL101", {"mod.py": TRACE_BAD}),
        ("GL201", {"mod.py": jt.LOCK_BAD}),
        ("GL202", {"mod.py": jt.RACE_BAD}),
        ("GL301", {"mod.py": jt.THREAD_BAD}),
        ("GL302", {"mod.py": jt.THREAD_BAD}),
        ("GL401", {"mod.py": HOT_BAD}),
        ("GL402", {"engine.py": INFER_BAD}),
        ("GL501", NEUTRAL_TREES["config_bad"]),
        ("GL502", {"mod.py": jt.PERSIST_BAD}),
        ("GL601", {"mod.py": jt.METRICS_BAD}),
        ("GL701", {"engine.py": MH_PUBLISH_BAD}),
        ("GL702", {"engine.py": MH_FETCH_BAD}),
        ("GL703", {"engine.py": MH_DIVERGE_BAD}),
        ("GL704", {"engine.py": MH_RANK_BAD}),
    ])
    def test_exit_1_per_seeded_fixture(self, tmp_path, check_id, files):
        proc = run_cli(write_tree(tmp_path, files), "--no-baseline")
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert check_id in proc.stdout

    @pytest.mark.parametrize("files,select", [
        ({"mod.py": TRACE_CLEAN}, ()),
        ({"mod.py": HOT_CLEAN}, ()),
        ({"engine.py": INFER_CLEAN}, ()),
        ({"engine.py": MH_PUBLISH_CLEAN}, ()),
        ({"engine.py": MH_FETCH_CLEAN}, ("--select", ",".join(GL70X))),
        ({"engine.py": MH_DIVERGE_CLEAN}, ()),
        ({"engine.py": MH_RANK_CLEAN}, ()),
    ])
    def test_exit_0_per_clean_counterpart(self, tmp_path, files, select):
        proc = run_cli(write_tree(tmp_path, files), "--no-baseline", *select)
        assert proc.returncode == 0, proc.stdout + proc.stderr

    def test_exit_2_on_bad_flag_missing_path_and_no_paths(self):
        assert run_cli("--definitely-not-a-flag").returncode == 2
        proc = run_cli("/nonexistent/path/xyz")
        assert proc.returncode == 2 and "does not exist" in proc.stderr
        assert run_cli().returncode == 2

    def test_exit_2_on_unknown_select(self, tmp_path):
        proc = run_cli(write_tree(tmp_path, {"mod.py": TRACE_CLEAN}),
                       "--select", "GL999")
        assert proc.returncode == 2 and "unknown check" in proc.stderr

    def test_list_checks(self):
        proc = run_cli("--list-checks")
        assert proc.returncode == 0
        for cid in ALL_IDS:
            assert cid in proc.stdout

    def test_json_and_sarif_formats(self, tmp_path):
        root = write_tree(tmp_path, {"mod.py": jt.LOCK_BAD})
        proc = run_cli(root, "--no-baseline", "--format", "json")
        assert proc.returncode == 1
        payload = json.loads(proc.stdout)
        assert payload[0]["check"] == "GL201" and payload[0]["hash"]
        out = str(tmp_path / "lint.sarif")
        proc = run_cli(root, "--no-baseline", "--format", "sarif",
                       "--sarif-out", out)
        assert proc.returncode == 1
        for doc in (json.loads(proc.stdout), json.load(open(out))):
            assert doc["version"] == "2.1.0"
            run = doc["runs"][0]
            assert run["tool"]["driver"]["name"] == "graftlint"
            assert set(ALL_IDS) <= {r["id"] for r in
                                    run["tool"]["driver"]["rules"]}
            assert run["results"][0]["ruleId"] == "GL201"

    def test_write_baseline_then_clean_then_stale(self, tmp_path):
        root = write_tree(tmp_path, {"mod.py": jt.LOCK_BAD})
        bl_path = str(tmp_path / "bl.json")
        assert run_cli(root, "--write-baseline", bl_path).returncode == 0
        proc = run_cli(root, "--baseline", bl_path)
        assert proc.returncode == 0 and "1 baselined" in proc.stdout
        fixed = write_tree(tmp_path / "fixed", {"mod.py": jt.LOCK_CLEAN})
        assert run_cli(fixed, "--baseline", bl_path).returncode == 0
        gated = run_cli(fixed, "--baseline", bl_path, "--fail-stale")
        assert gated.returncode == 1
        assert "stale baseline entry" in gated.stderr
        assert "GL201" in gated.stderr

    def test_explain_hot_path(self, tmp_path):
        root = write_tree(tmp_path, {"engine.py": INFER_BAD})
        proc = run_cli(root, "--explain-hot-path", "fetch_stats")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "is HOT" in proc.stdout and "(root)" in proc.stdout
        assert proc.stdout.index("Engine._loop") \
            < proc.stdout.index("Engine._dispatch") \
            < proc.stdout.rindex("fetch_stats")
        root = write_tree(tmp_path / "c", {"engine.py": INFER_CLEAN})
        assert run_cli(root, "--explain-hot-path",
                       "debug_dump").returncode == 1
        assert run_cli(root, "--explain-hot-path",
                       "no_such_function").returncode == 2

    def test_explain_dispatch_site(self, tmp_path):
        root = write_tree(tmp_path, {"engine.py": MH_PUBLISH_BAD})
        proc = run_cli(root, "--explain-dispatch-site", "_dispatch_plan")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "plan_step" in proc.stdout and "UNPUBLISHED" in proc.stdout
        assert proc.stdout.index("Engine._loop (root)") \
            < proc.stdout.rindex("Engine._dispatch_plan")
        root = write_tree(tmp_path / "c", {"engine.py": MH_PUBLISH_CLEAN})
        proc = run_cli(root, "--explain-dispatch-site", "plan_step")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "dispatch entry" in proc.stdout
        assert "published in-function" in proc.stdout
        assert run_cli(root, "--explain-dispatch-site",
                       "publish").returncode == 1
        assert run_cli(root, "--explain-dispatch-site",
                       "nope_never").returncode == 2

    def test_changed_rejects_write_baseline(self, tmp_path):
        root = write_tree(tmp_path, {"mod.py": jt.LOCK_BAD})
        proc = run_cli(root, "--changed", "--write-baseline",
                       str(tmp_path / "bl.json"))
        assert proc.returncode == 2 and "--write-baseline" in proc.stderr


class TestChangedScope:
    """`--changed` in a git checkout of its own, the CLI run from that
    checkout with the repo on PYTHONPATH."""

    def _seed(self, root):
        for args in (("init", "-q"), ("add", "-A"),
                     ("-c", "user.email=t@t", "-c", "user.name=t",
                      "commit", "-qm", "seed")):
            proc = subprocess.run(["git", *args], cwd=root, text=True,
                                  capture_output=True, timeout=60)
            assert proc.returncode == 0, proc.stderr

    def test_changed_scopes_to_diff_and_dependents(self, tmp_path):
        root = write_tree(tmp_path, {
            "pkg/helper.py": "def helper():\n    return 1\n",
            "pkg/caller.py": "from pkg.helper import helper\n\n\n"
                             "def use():\n    return helper()\n",
            "pkg/loner.py": jt.LOCK_BAD,
        })
        self._seed(root)
        with open(os.path.join(root, "pkg", "helper.py"), "w") as fh:
            fh.write(textwrap.dedent(jt.RACE_BAD))
        proc = run_cli(os.path.join(root, "pkg"), "--no-baseline",
                       "--changed", cwd=root)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "GL202" in proc.stdout
        assert "loner.py" not in proc.stdout
        assert "--changed" in proc.stdout

    def test_changed_scopes_gl701_through_reverse_deps(self, tmp_path):
        root = write_tree(tmp_path, {
            "pkg/__init__.py": "",
            "pkg/engine_model.py": TABLE_ENGINE_MODEL,
            "pkg/engine.py": TABLE_ENGINE,
        })
        self._seed(root)
        with open(os.path.join(root, "pkg", "engine_model.py"), "a") as fh:
            fh.write("\n\nEXTRA = 1\n")
        proc = run_cli(os.path.join(root, "pkg"), "--no-baseline",
                       "--changed", cwd=root)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "GL701" in proc.stdout and "engine.py" in proc.stdout

    def test_changed_clean_when_nothing_changed(self, tmp_path):
        root = write_tree(tmp_path, {"pkg/loner.py": jt.LOCK_BAD})
        self._seed(root)
        proc = run_cli(os.path.join(root, "pkg"), "--no-baseline",
                       "--changed", cwd=root)
        assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# the shipped port tree
# ---------------------------------------------------------------------------


class TestShippedTree:
    def test_package_has_zero_nonbaselined_findings(self, port_findings):
        bl = Baseline.load(BASELINE)
        left = bl.filter(port_findings)
        assert left == [], "\n".join(f.format() for f in left)
        # ... and without the baseline the CLI's gate would exit 1
        assert port_findings

    def test_baseline_has_no_stale_entry_and_every_reason(self,
                                                          port_findings):
        bl = Baseline.load(BASELINE)
        bl.filter(port_findings)
        assert bl.unused_entries() == []
        for e in bl.entries:
            assert e.get("reason", "").strip(), e
            assert "justify or fix" not in e["reason"], e

    def test_cli_exits_0_with_torch_and_jax_blocked(self, tmp_path):
        """The CLI over the port's tree, from another cwd with the repo
        on PYTHONPATH, exits 0 against the discovered baseline with
        --fail-stale; it parses source, so it runs with torch, jax and
        the JAX package blocked."""
        code = "\n".join([
            "import sys",
            "for m in ('torch', 'jax', 'generativeaiexamples_tpu'):",
            "    sys.modules[m] = None",
            "from generativeaiexamples_tpu_torch.lint.cli import main",
            f"sys.exit(main([{PKG!r}, '--fail-stale']))",
        ])
        proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                              text=True, capture_output=True, timeout=120,
                              env=ENV)
        assert proc.returncode == 0, proc.stdout + proc.stderr
