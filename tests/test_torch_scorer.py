"""The port's scorer against the JAX package on the CPU.

Same inputs (fuzzed annotation stores built from a seed) go through the
JAX ``BatchedScorer`` (f64 and f32), the fused Pallas kernel in interpret
mode, and the port's ``BatchedScorer`` / K1 plain version. Tolerance:
exact equality of every verdict and score.
"""

import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crane_scheduler_tpu.loadstore import NodeLoadStore
from crane_scheduler_tpu.policy import DEFAULT_POLICY, compile_policy
from crane_scheduler_tpu.policy.types import (
    DynamicSchedulerPolicy,
    PolicySpec,
    PredicatePolicy,
    PriorityPolicy,
    SyncPolicy,
)
from crane_scheduler_tpu.scorer import BatchedScorer
from crane_scheduler_tpu.scorer import oracle as jax_oracle
from crane_scheduler_tpu.scorer.hybrid import compute_overrides as jax_compute_overrides
from crane_scheduler_tpu.scorer.pallas_kernel import PallasScorer
from crane_scheduler_tpu.utils import format_local_time
from crane_scheduler_tpu_torch.convert import policy_tensors_from_numpy
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY as PORT_DEFAULT_POLICY
from crane_scheduler_tpu_torch.policy import compile_policy as port_compile_policy
from crane_scheduler_tpu_torch.policy import types as port_types
from crane_scheduler_tpu_torch.scorer import BatchedScorer as PortScorer
from crane_scheduler_tpu_torch.scorer import oracle as port_oracle
from crane_scheduler_tpu_torch.scorer.batched import PolicyConstants
from crane_scheduler_tpu_torch.scorer.hybrid import compute_overrides as port_compute_overrides
from crane_scheduler_tpu_torch.scorer.score_kernel import fused_score

NOW = 1753776000.0

PATHOLOGICAL = {
    "empty": PolicySpec(),
    "predicates-only": PolicySpec(
        sync_period=(SyncPolicy("a", 60.0),),
        predicate=(PredicatePolicy("a", 0.5), PredicatePolicy("a", 0.0)),
    ),
    "zero-weight-sum": PolicySpec(
        sync_period=(SyncPolicy("a", 60.0),),
        priority=(PriorityPolicy("a", 0.0),),
    ),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here and leaves the
    other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def build_store(tensors, n_nodes, seed):
    """The fuzzed store of tests/test_pallas_scorer.py: missing, bogus,
    negative and stale entries, values on both sides of thresholds."""
    rng = random.Random(seed)
    store = NodeLoadStore(tensors)
    for i in range(n_nodes):
        anno = {}
        for m in tensors.metric_names:
            roll = rng.random()
            if roll < 0.15:
                continue
            age = rng.choice([0, 100, 479, 481, 1000])
            if roll < 0.25:
                anno[m] = "bogus," + format_local_time(NOW - age)
            elif roll < 0.3:
                anno[m] = f"{-rng.random():.5f},{format_local_time(NOW - age)}"
            else:
                v = rng.choice([0.1, 0.3, 0.5, 0.649, 0.651, 0.9, 1.2])
                anno[m] = f"{v:.5f},{format_local_time(NOW - age)}"
        if rng.random() < 0.5:
            anno["node_hot_value"] = (
                f"{rng.randint(0, 5)},{format_local_time(NOW - rng.choice([0, 299, 301]))}"
            )
        store.ingest_node_annotations(f"n{i}", anno)
    return store


def port_tensors(tensors):
    """The JAX package's compiled policy carried across as numpy."""
    return policy_tensors_from_numpy(vars(tensors))


def snap_args(snap):
    return (snap.values, snap.ts, snap.hot_value, snap.hot_ts, snap.node_valid)


def assert_same(want, got):
    np.testing.assert_array_equal(np.asarray(want.schedulable), got.schedulable.numpy())
    np.testing.assert_array_equal(np.asarray(want.scores), got.scores.numpy())


DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed,n_nodes", [(0, 100), (1, 300)])
def test_batched_scorer_matches_jax(seed, n_nodes, dtype):
    jd, td = DTYPES[dtype]
    tensors = compile_policy(DEFAULT_POLICY)
    snap = build_store(tensors, n_nodes, seed).snapshot(bucket=128)
    want = BatchedScorer(tensors, dtype=jd)(*snap_args(snap), NOW)
    got = PortScorer(port_tensors(tensors), dtype=td, device="cpu")(*snap_args(snap), NOW)
    assert got.scores.dtype == torch.int32
    assert_same(want, got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", PATHOLOGICAL)
def test_pathological_policies_match_jax(policy, dtype):
    jd, td = DTYPES[dtype]
    tensors = compile_policy(DynamicSchedulerPolicy(spec=PATHOLOGICAL[policy]))
    snap = build_store(tensors, 50, seed=7).snapshot(bucket=128)
    want = BatchedScorer(tensors, dtype=jd)(*snap_args(snap), NOW)
    got = PortScorer(port_tensors(tensors), dtype=td, device="cpu")(*snap_args(snap), NOW)
    assert_same(want, got)


def _k1_plain(tensors, snap, now):
    """K1's plain version on rebased f32 inputs, as the step calls it."""
    consts = PolicyConstants(port_tensors(tensors), torch.float32, "cpu")
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    return fused_score(
        f32(snap.values), f32(np.asarray(snap.ts) - now), f32(snap.hot_value),
        f32(np.asarray(snap.hot_ts) - now),
        torch.from_numpy(np.asarray(snap.node_valid)), 0.0, consts,
    )


@pytest.mark.parametrize(
    "policy,seed,n_nodes",
    [("default", 0, 100), ("default", 1, 300)]
    + [(name, 7, 50) for name in PATHOLOGICAL],
)
def test_k1_plain_version_matches_pallas_interpret(policy, seed, n_nodes):
    """On the stores of tests/test_pallas_scorer.py (where the Pallas
    kernel and the f32 XLA scorer agree) K1's plain version equals
    PallasScorer in interpret mode."""
    spec = DEFAULT_POLICY.spec if policy == "default" else PATHOLOGICAL[policy]
    tensors = compile_policy(DynamicSchedulerPolicy(spec=spec))
    snap = build_store(tensors, n_nodes, seed).snapshot(bucket=128)
    want = PallasScorer(tensors, block_nodes=128, interpret=True)(*snap_args(snap), NOW)
    sched, scores = _k1_plain(tensors, snap, NOW)
    np.testing.assert_array_equal(np.asarray(want.schedulable), sched.numpy())
    np.testing.assert_array_equal(np.asarray(want.scores), scores.numpy())


@pytest.mark.parametrize("seed", [11, 3])
def test_k1_follows_xla_f32_where_pallas_folds_weight(seed):
    """PallasScorer computes (1-u)*w*100 without the reference's barrier,
    so XLA may fold w*100 into one multiply: at an exact truncation
    boundary it then differs by one from BatchedScorer(float32), which
    rounds twice like Go. K1 follows BatchedScorer(float32) everywhere;
    every row where the Pallas kernel differs is one the hybrid risk
    scan rescues with the exact f64 verdict."""
    from crane_scheduler_tpu.scorer.hybrid import risk_mask_f64

    tensors = compile_policy(DEFAULT_POLICY)
    snap = build_store(tensors, 300, seed).snapshot(bucket=128)
    xla = BatchedScorer(tensors, dtype=jnp.float32)(*snap_args(snap), NOW)
    pallas = PallasScorer(tensors, block_nodes=128, interpret=True)(*snap_args(snap), NOW)
    sched, scores = _k1_plain(tensors, snap, NOW)
    np.testing.assert_array_equal(np.asarray(xla.schedulable), sched.numpy())
    np.testing.assert_array_equal(np.asarray(xla.scores), scores.numpy())
    differ = np.flatnonzero(np.asarray(pallas.scores) != scores.numpy())
    assert differ.size > 0
    risk = risk_mask_f64(tensors, *snap_args(snap)[:4], NOW)
    assert risk[differ].all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_nan_usage_with_hot_value_wraps_to_full_score(dtype):
    """A NaN annotation gives base = INT_MIN; minus a fresh hot-value
    penalty it wraps to near INT_MAX and clips to 100, as in Go."""
    jd, td = DTYPES[dtype]
    tensors = compile_policy(DEFAULT_POLICY)
    store = NodeLoadStore(tensors)
    fresh = format_local_time(NOW - 10)
    nan_anno = {m: f"NaN,{fresh}" for m in tensors.metric_names}
    cases = [
        dict(nan_anno, node_hot_value=f"0.1,{fresh}"),
        dict(nan_anno, node_hot_value=f"3,{fresh}"),
        dict(nan_anno),  # no penalty: stays INT_MIN, clips to 0
        {m: f"0.2,{fresh}" for m in tensors.metric_names},
    ]
    for i, anno in enumerate(cases):
        store.ingest_node_annotations(f"n{i}", anno)
    snap = store.snapshot(bucket=8)
    want = BatchedScorer(tensors, dtype=jd)(*snap_args(snap), NOW)
    got = PortScorer(port_tensors(tensors), dtype=td, device="cpu")(*snap_args(snap), NOW)
    assert_same(want, got)
    assert got.scores[:4].tolist() == [100, 100, 0, 80]
    assert [port_oracle.score_node(a, DEFAULT_POLICY.spec, NOW) for a in cases][:3] == [100, 100, 0]
    if dtype == "f32":
        sched, scores = _k1_plain(tensors, snap, NOW)
        assert scores[:4].tolist() == [100, 100, 0, 80]


def _port_spec(spec):
    """A JAX-package PolicySpec rebuilt from the port's policy types."""
    t = port_types
    return t.PolicySpec(
        sync_period=tuple(t.SyncPolicy(s.name, s.period_seconds) for s in spec.sync_period),
        predicate=tuple(t.PredicatePolicy(p.name, p.max_limit_percent) for p in spec.predicate),
        priority=tuple(t.PriorityPolicy(p.name, p.weight) for p in spec.priority),
        hot_value=tuple(t.HotValuePolicy(h.time_range_seconds, h.count) for h in spec.hot_value),
    )


def test_oracle_copy_matches_jax_package_oracle():
    rng = random.Random(5)
    spec = DEFAULT_POLICY.spec
    pspec = _port_spec(spec)
    metrics = [sp.name for sp in spec.sync_period]
    for _ in range(300):
        anno = {}
        for m in metrics + ["node_hot_value"]:
            roll = rng.random()
            if roll < 0.2:
                continue
            ts = format_local_time(NOW - rng.choice([0, 100, 299, 301, 479, 481, 2000]))
            val = rng.choice(["0.1", "0.64999", "0.65", "0.65001", "NaN", "-0.2",
                              "1e400", "bogus", f"{rng.random():.5f}", "2"])
            anno[m] = f"{val},{ts}" if roll > 0.25 else val
        now = NOW + rng.choice([0.0, 0.5, 3.0])
        assert port_oracle.score_node(anno, pspec, now) == jax_oracle.score_node(anno, spec, now)
        assert port_oracle.filter_node(anno, pspec, now) == jax_oracle.filter_node(anno, spec, now)


def test_port_compile_policy_equals_converted_tensors():
    want = port_tensors(compile_policy(DEFAULT_POLICY))
    got = port_compile_policy(PORT_DEFAULT_POLICY)
    assert got.metric_names == want.metric_names
    assert got.metric_index == want.metric_index
    assert got.weight_sum == want.weight_sum
    for name in ("sync_seconds", "active_seconds", "pred_idx", "pred_threshold",
                 "pred_active", "prio_idx", "prio_weight", "prio_active",
                 "hv_range_seconds", "hv_count"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


def test_hybrid_overrides_copy_matches_jax():
    tensors = compile_policy(DEFAULT_POLICY)
    snap = build_store(tensors, 300, seed=4).snapshot(bucket=128)
    for now in (NOW, NOW + 1.0, NOW + 181.0):
        want = jax_compute_overrides(tensors, *snap_args(snap), now, rebase_age=3.0)
        got = port_compute_overrides(port_tensors(tensors), *snap_args(snap), now, rebase_age=3.0)
        for a, b in zip(want[:3], got[:3]):
            np.testing.assert_array_equal(a, b)
        assert want[3] == got[3] and not math.isnan(float(got[3]))
