"""The port's water-filling gang solver against the JAX package on the CPU.

Same seeded inputs as tests/test_gang.py go through the JAX
``GangScheduler``, the sequential ``gang_assign_oracle`` and the port's
``GangScheduler`` (dense, sparse and combined grids, with prior counts);
K2's plain version is held against ``PallasGangScheduler._totals`` in
interpret mode, and a numpy model of the CUDA kernel's step walk and
prefix scan against K2's plain version and the JAX ``GangScheduler._totals``
(the kernel itself runs only on the card, in ``chip_smoke.py``).
Tolerance: exact equality of counts, unassigned and waterline, and of
every level total.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from crane_scheduler_tpu.scorer.pallas_gang import PallasGangScheduler
from crane_scheduler_tpu.scorer.topk import GangScheduler, gang_assign_oracle
from crane_scheduler_tpu.scorer import topk as jax_topk
from crane_scheduler_tpu_torch.scorer import topk as port_topk
from crane_scheduler_tpu_torch.scorer.gang_kernel import gang_totals
from crane_scheduler_tpu_torch.scorer.topk import GangScheduler as PortGang

DEFAULT_HV = [5, 2]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here and leaves the
    other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def random_case(seed, base):
    rng = random.Random(base + seed)
    n = rng.randint(1, 200)
    weight = rng.choice([1, 3])
    max_offset = rng.choice([0, 200])
    return dict(
        n=n, weight=weight, max_offset=max_offset,
        scores=[rng.randint(0, 100) for _ in range(n)],
        schedulable=[rng.random() > 0.2 for _ in range(n)],
        p=rng.randint(0, 150),
        hv=rng.choice([DEFAULT_HV, [1], [3, 7], []]),
        capacity=[rng.randint(0, 12) for _ in range(n)],
        offsets=[rng.randint(0, max_offset) for _ in range(n)],
        prior=[rng.randint(0, 4) for _ in range(n)],
    )


def assert_result(want, got):
    np.testing.assert_array_equal(np.asarray(want.counts), np.asarray(got.counts))
    assert int(want.unassigned) == int(got.unassigned)
    assert int(want.waterline) == int(got.waterline)


@pytest.mark.parametrize("sparse", [None, True, False], ids=["auto", "sparse", "dense"])
@pytest.mark.parametrize("seed", range(6))
def test_gang_matches_jax_and_oracle(seed, sparse):
    c = random_case(seed, 6000)
    args = (c["scores"], c["schedulable"], c["p"], c["capacity"])
    kw = dict(offsets=c["offsets"], prior=c["prior"], sparse_levels=sparse)
    want = gang_assign_oracle(
        c["scores"], c["schedulable"], c["p"], c["hv"], c["capacity"],
        offsets=c["offsets"], dynamic_weight=c["weight"],
        max_offset=c["max_offset"], prior=c["prior"],
    )
    jax_got = GangScheduler(c["hv"], c["weight"], c["max_offset"])(*args, **kw)
    port_got = PortGang(c["hv"], c["weight"], c["max_offset"], device="cpu")(*args, **kw)
    assert_result(want, port_got)
    assert_result(jax_got, port_got)


@pytest.mark.parametrize("seed", range(4))
def test_plain_burst_without_capacity_matches_jax(seed):
    """The main path's shape: plain grid, default hot-value table, no
    per-node capacity, bursts from empty to larger than the cluster."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 400))
    scores = rng.integers(0, 101, n)
    schedulable = rng.random(n) > 0.3
    for p in (0, 1, n // 3, 5 * n, 40 * n):
        want = GangScheduler(DEFAULT_HV)(scores, schedulable, p)
        got = PortGang(DEFAULT_HV, device="cpu")(scores, schedulable, p)
        assert_result(want, got)


@pytest.mark.parametrize("seed", range(4))
def test_k2_plain_version_matches_pallas_interpret(seed):
    c = random_case(seed, 6100)
    pallas = PallasGangScheduler(
        c["hv"], dynamic_weight=c["weight"], max_offset=c["max_offset"],
        interpret=True,
    )
    port = PortGang(c["hv"], c["weight"], c["max_offset"], device="cpu")
    n, p = c["n"], c["p"]
    cap = np.minimum(np.where(c["schedulable"], c["capacity"], 0), p)
    cap = np.minimum(cap, (2**31 - 1) // n).astype(np.int32)
    s = np.asarray(c["scores"], np.int32)
    offs = np.clip(np.asarray(c["offsets"], np.int32), 0, c["max_offset"])
    pri = np.asarray(c["prior"], np.int32)
    want = np.asarray(pallas._totals(
        jnp.asarray(s), jnp.asarray(offs), jnp.asarray(cap), jnp.asarray(pri)
    ))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = gang_totals(t(s), t(offs), t(cap), t(pri), port._g, port._weight, port._n_levels)
    assert got.dtype == torch.int32 and got.shape == (port._n_levels,)
    np.testing.assert_array_equal(want, got.numpy())


_MASK32 = (1 << 32) - 1


def _wrap_i32(x: int) -> int:
    x &= _MASK32
    return x - (1 << 32) if x >= 1 << 31 else x


def k2_step_walk_model(s, offs, cap, pri, g, w, n_levels):
    """Test-only numpy model of ``csrc/gang_totals.cu``, step for step: each
    node's level-0 value into bin 0, then, in closed form, the start level
    and change of each run of equal staircase index x (x_first at q = 1 down
    to x_last at q = min(s, 100)) and of the tail, into a uint32 difference
    histogram (a change at level <= 0 into bin 0, one past the grid
    dropped); then one inclusive prefix scan modulo 2^32."""
    hist = [0] * n_levels

    def add(level, before, after):
        if after != before and level < n_levels:
            b = max(level, 0)
            hist[b] = (hist[b] + after - before) & _MASK32

    for s_i, off_i, cap_i, pri_i in zip(*(map(int, a) for a in (s, offs, cap, pri))):
        value = lambda unlocked: min(cap_i, max(_wrap_i32(int(unlocked) - pri_i), 0))  # noqa: E731
        hist[0] = (hist[0] + cap_i) & _MASK32
        qmax = min(s_i, 100) if s_i > 0 else 0
        x_first = min((s_i - 1) // 10, 10) if s_i > 0 else -1
        x_last = min((s_i - qmax) // 10, 10) if s_i > 0 else 0
        steps = 2  # the level-0 value and the tail
        for x in range(10, -1, -1):
            if x_last <= x <= x_first:
                steps += 1
                q_lo = 1 if x == x_first else s_i - 10 * x - 9
                add(off_i + (q_lo - 1) * w + 1,
                    cap_i if x == x_first else value(g[x + 1]), value(g[x]))
        add(off_i + qmax * w + 1, value(g[x_last]) if x_first >= 0 else cap_i, value(0))
        assert steps <= 13, (s_i, off_i, steps)
    totals = np.cumsum(np.asarray(hist, np.uint64)) & _MASK32
    return totals.astype(np.uint32).view(np.int32)


_INF = int(port_topk._INF_TOKENS)
K2_STAIRCASES = {
    "default": port_topk.hot_penalty_steps(DEFAULT_HV),
    "no-hot-value": port_topk.hot_penalty_steps([]),  # every entry unbounded
    "partly-unbounded": np.asarray([1, 3, 3, 6, 9, _INF, _INF, _INF, _INF, _INF, _INF]),
}


def k2_edge_case(n, w, max_offset, g, seed):
    """Scores at every run boundary the walk has (0, 1, 9, 10, 99, 100),
    capacities at 0 and at the (2^31-1)//N clip, prior counts above the
    staircase, offsets at both ends of their range."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([[0, 1, 9, 10, 99, 100], rng.integers(0, 101, n - 6)])
    clip = (2**31 - 1) // n
    cap = rng.choice([0, clip, 1, 7, 40], n)
    cap[:6] = clip
    finite = [int(v) for v in g if int(v) < _INF]
    above = (max(finite) if finite else _INF) + 1
    pri = rng.choice([0, 0, 1, 3, above], n)
    offs = rng.integers(0, max_offset + 1, n)
    offs[::7] = max_offset
    offs[1::7] = 0
    return [a.astype(np.int32) for a in (s, offs, cap, pri)]


def _port_totals(s, offs, cap, pri, g, w, n_levels):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731
    return gang_totals(t(s), t(offs), t(cap), t(pri), t(g), w, n_levels).numpy()


@pytest.mark.parametrize("g_name", K2_STAIRCASES)
@pytest.mark.parametrize("max_offset", [0, 7, 220])
@pytest.mark.parametrize("w", [1, 2, 3, 5])
def test_k2_step_walk_matches_plain_and_jax(w, max_offset, g_name):
    """The CUDA kernel's step walk and scan (modelled in numpy) against
    K2's plain version and the JAX ``GangScheduler._totals``: exact."""
    g = K2_STAIRCASES[g_name]
    n = 60
    n_levels = 100 * w + max_offset + 2
    s, offs, cap, pri = k2_edge_case(n, w, max_offset, g, seed=w * 1000 + max_offset)
    want = _port_totals(s, offs, cap, pri, g, w, n_levels)
    jax_gang = GangScheduler([], w, max_offset)
    jax_gang._g_host = np.asarray(g, np.int64)  # the staircase under test
    jax_want = np.asarray(jax_gang._totals(
        jnp.asarray(s), jnp.asarray(offs), jnp.asarray(cap), jnp.asarray(pri)
    ))
    np.testing.assert_array_equal(jax_want, want)
    np.testing.assert_array_equal(k2_step_walk_model(s, offs, cap, pri, g, w, n_levels), want)


def test_k2_step_walk_one_score_and_negative_offsets():
    """Every node on one score (the kernel's worst bin contention), and
    offsets below 0, whose early steps fold into level 0."""
    g = K2_STAIRCASES["default"]
    for w, n_levels in ((1, 102), (3, 522)):
        for score in (0, 1, 55, 100):
            s = np.full(300, score, np.int32)
            offs, cap = np.zeros(300, np.int32), np.full(300, 9, np.int32)
            pri = np.zeros(300, np.int32)
            np.testing.assert_array_equal(
                k2_step_walk_model(s, offs, cap, pri, g, w, n_levels),
                _port_totals(s, offs, cap, pri, g, w, n_levels),
            )
        rng = np.random.default_rng(w)
        s = rng.integers(0, 101, 80).astype(np.int32)
        offs = rng.integers(-40, 30, 80).astype(np.int32)
        cap = rng.integers(0, 20, 80).astype(np.int32)
        pri = rng.integers(0, 3, 80).astype(np.int32)
        np.testing.assert_array_equal(
            k2_step_walk_model(s, offs, cap, pri, g, w, n_levels),
            _port_totals(s, offs, cap, pri, g, w, n_levels),
        )


_G_ENTRY = st.one_of(st.integers(0, 40), st.just(_INF))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(
    data=st.data(),
    n=st.integers(1, 40),
    w=st.integers(1, 6),
    max_offset=st.integers(0, 40),
    g=st.lists(_G_ENTRY, min_size=11, max_size=11),
)
def test_k2_step_walk_hypothesis(data, n, w, max_offset, g):
    n_levels = 100 * w + max_offset + 2
    ints = lambda lo, hi: np.asarray(  # noqa: E731
        data.draw(st.lists(st.integers(lo, hi), min_size=n, max_size=n)), np.int32
    )
    s, offs = ints(-5, 130), ints(0, max_offset)
    cap, pri = ints(0, (2**31 - 1) // n), ints(0, 50)
    np.testing.assert_array_equal(
        k2_step_walk_model(s, offs, cap, pri, g, w, n_levels),
        _port_totals(s, offs, cap, pri, g, w, n_levels),
    )


def test_numpy_helper_copies_match_jax():
    for hv in ([], [0], DEFAULT_HV, [1], [3, 7], [4, 4, 9]):
        np.testing.assert_array_equal(
            jax_topk.hot_penalty_steps(hv), port_topk.hot_penalty_steps(hv)
        )
    rng = np.random.default_rng(3)
    for w, mo in ((1, 0), (3, 200), (50, 40)):
        offs = rng.integers(0, mo + 1, 30)
        n_levels = 100 * w + mo + 2
        a = jax_topk.candidate_levels(w, mo, offs, n_levels)
        b = port_topk.candidate_levels(w, mo, offs, n_levels)
        assert (a is None and b is None) or np.array_equal(a, b)
    exact = rng.integers(0, 5, 40)
    order = rng.permutation(40)
    for rem in (0, 7, 200):
        np.testing.assert_array_equal(
            jax_topk.waterline_take(exact, rem, order),
            port_topk.waterline_take(exact, rem, order),
        )
