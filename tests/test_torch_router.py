"""Port parity: the prefix-locality router (serving/router.py).

The port's `PrefixLocalityRouter` and the JAX package's are driven by the
same scripted replica registrations, cache reports, submits, progress,
drains, evictions, role flips, sessions and placements, under each of the
three policies; every call must return the same value (or raise the same
exception type) on both, and `snapshot()`, `roles()`, `queue_depths()`
and `tier_queue_depths()` must be equal after every op. The shadow tree's
`remove_path` and `match_tokens` are held against the JAX one the same
way. Pure Python on both sides: no engine is built.
"""

import random
import time

import pytest

from generativeaiexamples_tpu.serving import router as jrouter
from generativeaiexamples_tpu_torch.serving import router as trouter

PS = 4
POLICIES = ("prefix", "least_load", "round_robin")
TIERS = ("latency", "standard", "batch", "bogus", "")


def _prompt(rng, families):
    """A prompt that shares a page-granular prefix with a family (the
    locality the router scores), or a fresh cold one."""
    if rng.random() < 0.8:
        base = rng.choice(families)
        cut = rng.randrange(0, len(base) + 1)
        return base[:cut] + [rng.randrange(256)
                             for _ in range(rng.randrange(0, 9))]
    return [rng.randrange(256) for _ in range(rng.randrange(1, 30))]


def _script(seed: int, n_ops: int = 240):
    rng = random.Random(seed)
    families = [[rng.randrange(256) for _ in range(PS * rng.randrange(2, 7))]
                for _ in range(4)]
    sessions = ["", "", "s1", "s2", "s3"]
    ops = [("add", "r0", False, "mixed"), ("add", "r1", True, "mixed"),
           ("add", "r2", False, "prefill"), ("add", "r3", True, "decode")]
    rids = ["r0", "r1", "r2", "r3"]
    for _ in range(n_ops):
        x = rng.random()
        rid = rng.choice(rids)
        if x < 0.25:
            ops.append(("place", _prompt(rng, families),
                        rng.choice(sessions)))
        elif x < 0.4:
            ops.append(("place_disagg", _prompt(rng, families),
                        rng.choice(sessions)))
        elif x < 0.55:
            ids = _prompt(rng, families)
            ids = ids[: len(ids) // PS * PS]
            kind = "insert" if rng.random() < 0.7 else "evict"
            if kind == "evict" and ids:
                ids = ids[: PS * rng.randrange(1, len(ids) // PS + 1)]
            ops.append(("report", rid, kind, tuple(ids)))
        elif x < 0.68:
            ops.append(("submit", rid, rng.randrange(1, 64),
                        rng.choice(TIERS)))
        elif x < 0.74:
            ops.append(("progress", rid, rng.randrange(1, 8)))
        elif x < 0.82:
            ops.append(("finish", rid, rng.randrange(0, 16),
                        rng.choice(TIERS)))
        elif x < 0.88:
            ops.append(("admitting", rid, rng.random() < 0.6))
        elif x < 0.91:
            ops.append(("drop", rid))
        elif x < 0.94:
            ops.append(("evicted", rid))
        elif x < 0.96:
            ops.append(("requeued",))
        else:
            ops.append(("role", rid, rng.choice(("prefill", "decode",
                                                 "mixed"))))
    return ops


def _apply(router, op, reporters):
    kind = op[0]
    if kind == "add":
        router.add_replica(op[1], self_feed=op[2], role=op[3])
        reporters[op[1]] = router.reporter_for(op[1])
        return None
    if kind == "place":
        return router.place(op[1], op[2])
    if kind == "place_disagg":
        return router.place_disagg(op[1], op[2])
    if kind == "report":
        reporters[op[1]](op[2], op[3])
        return None
    if kind == "submit":
        return router.note_submitted(op[1], op[2], op[3])
    if kind == "progress":
        return router.note_progress(op[1], op[2])
    if kind == "finish":
        return router.note_finished(op[1], op[2], op[3])
    if kind == "admitting":
        return router.set_admitting(op[1], op[2])
    if kind == "drop":
        return router.drop_shadow(op[1])
    if kind == "evicted":
        return router.note_evicted(op[1])
    if kind == "requeued":
        return router.note_requeued()
    if kind == "role":
        return router.set_role(op[1], op[2])
    raise AssertionError(op)


def _outcome(router, op, reporters):
    try:
        return ("ok", _apply(router, op, reporters))
    except Exception as e:  # the same type must raise on both sides
        return ("raise", type(e).__name__)


def _state(router):
    return (router.snapshot(), router.roles(), router.queue_depths(),
            router.tier_queue_depths())


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_ops_equal_jax_op_for_op(policy, seed):
    kw = dict(policy=policy, affinity_ttl_s=300.0, load_penalty_tokens=6,
              shadow_capacity_pages=24)
    ours = trouter.PrefixLocalityRouter(PS, **kw)
    theirs = jrouter.PrefixLocalityRouter(PS, **kw)
    rep_t, rep_j = {}, {}
    placed = 0
    for i, op in enumerate(_script(seed)):
        got = _outcome(ours, op, rep_t)
        want = _outcome(theirs, op, rep_j)
        assert got == want, (i, op)
        assert _state(ours) == _state(theirs), (i, op)
        placed += op[0].startswith("place") and got[0] == "ok"
    assert placed > 40  # the script reached placements, not just refusals
    snap = ours.snapshot()
    if policy == "prefix":
        assert snap["router_prefix_hits"] > 0
        assert snap["router_affinity_hits"] > 0
    assert snap["router_disagg_plans"] > 0


def test_affinity_ttl_expiry_equal_jax(monkeypatch):
    """A session pin expires after affinity_ttl_s on both sides (clock
    driven by hand)."""
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    routers = [m.PrefixLocalityRouter(PS, affinity_ttl_s=5.0,
                                      load_penalty_tokens=100)
               for m in (trouter, jrouter)]
    out = []
    for r in routers:
        r.add_replica("a", self_feed=True)
        r.add_replica("b", self_feed=True)
        first = r.place([1] * 8, "sess")
        r.note_submitted(first, 4)
        r.note_submitted(first, 4)
        seq = [first, r.place([9] * 8, "sess")]
        now[0] += 10.0  # past the TTL: placement by score again
        seq.append(r.place([7] * 8, "sess"))
        now[0] -= 10.0
        out.append((seq, r.snapshot()))
    assert out[0] == out[1]
    (seq, snap), _ = out
    assert seq[1] == seq[0] and snap["router_affinity_hits"] == 1


def test_unknown_policy_and_role_raise_like_jax():
    for m in (trouter, jrouter):
        with pytest.raises(ValueError, match="router_policy"):
            m.PrefixLocalityRouter(PS, policy="random")
        r = m.PrefixLocalityRouter(PS)
        with pytest.raises(ValueError, match="replica role"):
            r.add_replica("x", self_feed=True, role="leader")
        with pytest.raises(LookupError):
            r.place([1, 2, 3])
    assert trouter.ROUTER_COUNTER_KEYS == jrouter.ROUTER_COUNTER_KEYS
    assert trouter.REPLICA_ROLES == jrouter.REPLICA_ROLES


@pytest.mark.parametrize("seed", [0, 1])
def test_shadow_tree_remove_path_and_trim_equal_jax(seed):
    rng = random.Random(seed)
    trees = [m.ShadowRadixTree(PS, 10) for m in (trouter, jrouter)]
    for _ in range(200):
        ids = [rng.randrange(6) for _ in range(PS * rng.randrange(1, 6))]
        op = rng.random()
        res = []
        for t in trees:
            if op < 0.5:
                res.append((t.insert(ids), t.trim()))
            elif op < 0.8:
                res.append(t.remove_path(ids[:PS * (1 + len(ids) // PS
                                                    // 2)]))
            else:
                res.append(t.match_tokens(ids))
        assert res[0] == res[1]
        assert trees[0].n_cached_pages == trees[1].n_cached_pages
        assert trees[0].evictions == trees[1].evictions
