"""The port's water-filling gang solver against the JAX package on the CPU.

Same seeded inputs as tests/test_gang.py go through the JAX
``GangScheduler``, the sequential ``gang_assign_oracle`` and the port's
``GangScheduler`` (dense, sparse and combined grids, with prior counts);
K2's plain version is held against ``PallasGangScheduler._totals`` in
interpret mode. Tolerance: exact equality of counts, unassigned and
waterline, and of every level total.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
