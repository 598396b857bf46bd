"""The drip window replayed from a captured CUDA graph.

``DripBatchKernel`` on a CUDA device captures a shape's window when two
windows in a row have that shape and replays it after (``GraphSlot``
routes each window). On the CPU: the slot's routes, and a CPU kernel that
never captures. Tests marked ``card`` need a CUDA device and skip without
one; there a kernel's windows, eager, captured and replayed, equal a CPU
kernel's fed the same windows, bit for bit. This file imports nothing of
JAX, so on the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_drip_graph.py -q
"""

import threading

import numpy as np
import pytest
import torch

from crane_scheduler_tpu_torch.scorer import drip_batch
from crane_scheduler_tpu_torch.scorer.drip_batch import DripBatchKernel, GraphSlot

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda:0"


# -- the graph slot -----------------------------------------------------------------


def key(n=100, k=8, ties=False, dev=CPU):
    return (dev, n, k, ties)


def routes(slot, keys):
    """Each window's route, holding the key as the graph on a capture."""
    out = []
    for key_ in keys:
        out.append(slot.route(key_))
        if out[-1] == "capture":
            slot.hold(key_, key_)
    return out


def test_slot_captures_the_second_of_two_windows_in_a_row_and_replays_after():
    s = GraphSlot()
    assert s.route(key()) == "eager"
    assert s.graph is None
    assert s.route(key()) == "capture"
    s.hold(key(), "g")
    assert [s.route(key()) for _ in range(3)] == ["replay"] * 3
    assert (s.key, s.graph) == (key(), "g")
    # want_ties and the pod count are part of the key
    assert s.route(key(ties=True)) == "eager"
    assert s.route(key(k=9)) == "eager"
    assert s.route(key()) == "replay"


def test_slot_keeps_its_graph_through_shapes_that_do_not_repeat():
    """A partial window between full ones runs eagerly and evicts
    nothing; shapes that alternate never capture, so they never pay a
    capture again and again."""
    s = GraphSlot()
    full, part = key(k=32), key(k=5)
    assert routes(s, [full, full, part, full, key(k=6), full]) == [
        "eager", "capture", "eager", "replay", "eager", "replay"]
    assert s.key == full
    assert routes(s, [part, key(k=6)] * 4) == ["eager"] * 8
    assert s.key == full


def test_slot_replaces_its_graph_when_another_shape_repeats():
    s = GraphSlot()
    a, b = key(k=8), key(k=9)
    assert routes(s, [a, a, b, b, b, a, a]) == [
        "eager", "capture", "eager", "capture", "replay", "eager", "capture"]
    assert (s.key, s.graph) == (a, a)


def test_slot_takes_a_node_count_change_as_a_new_shape():
    s = GraphSlot()
    assert routes(s, [key(), key(), key(n=101), key(), key(n=101), key(n=101)]) == [
        "eager", "capture", "eager", "replay", "eager", "capture"]
    assert s.key == key(n=101)
    assert routes(s, [key()]) == ["eager"]


# -- windows ------------------------------------------------------------------------


def columns(seed, n):
    """One cluster's columns: scores in a narrow range, so windows tie."""
    rng = np.random.default_rng(seed)
    schedulable = rng.random(n) < 0.85
    weighted = rng.integers(0, 40, n).astype(np.int64)
    bounded = rng.random(n) < 0.9
    free = np.stack([rng.integers(0, 4000, n), rng.integers(0, 32 << 30, n),
                     rng.integers(0, 1 << 20, n), rng.integers(0, 110, n)],
                    axis=1).astype(np.int64)
    return schedulable, weighted, bounded, free


def requests(rng, k):
    return np.stack([rng.integers(0, 1500, k), rng.integers(0, 8 << 30, k),
                     np.zeros(k, np.int64), np.ones(k, np.int64)], axis=1).astype(np.int64)


class Cluster:
    """A host side as the scheduler keeps it: columns patched in place
    under an epoch, the fit column folded after an accepted window."""

    def __init__(self, seed, n):
        self.sched, self.weighted, self.bounded, self.free = columns(seed, n)
        self.epoch = 0
        self.dirty = {}  # epoch -> rows patched to reach it

    def patch(self, rng, rows):
        rows = np.sort(rng.choice(self.weighted.shape[0], rows, replace=False))
        self.weighted[rows] = rng.integers(0, 40, rows.shape[0])
        self.epoch += 1
        self.dirty[self.epoch] = rows

    def delta(self, held, current):
        rows = [self.dirty[e] for e in range(held + 1, current + 1)]
        return np.unique(np.concatenate(rows)) if rows else np.zeros(0, np.int64)

    def dispatch(self, kern, vecs, want_ties, accept=True):
        out = kern.dispatch(self.sched, self.weighted, self.bounded, self.free, vecs,
                            want_ties=want_ties, col_version=self.epoch,
                            col_delta=self.delta)
        if accept:
            for i, c in enumerate(out[0]):
                if c >= 0:
                    self.free[c] -= vecs[i]
            kern.mark_synced(self.free)
        else:
            kern.mark_desynced()
        return out


def scenario(device, want_ties, seed=0, n=5000, n2=4099, k=128, part=37):
    """Thirteen windows on one kernel: full and partial, a delta scatter, a
    rejected window, then a node count change. Returns each window's
    outputs, the final carry and the kernel."""
    rng = np.random.default_rng(seed + 100)
    kern = DripBatchKernel(device=device)
    host = Cluster(seed, n)
    outs = []

    def step(k, accept=True):
        outs.append(host.dispatch(kern, requests(rng, k), want_ties, accept))

    step(k)  # eager
    step(k)  # the second in a row: capture, replay
    step(part)  # partial window, eager: the full graph stays
    step(k)  # replay
    host.patch(rng, 17)  # a column-epoch delta scatter: a new device column
    step(k)
    step(k, accept=False)  # rejected: the next window re-uploads the carry
    step(k)
    step(part)
    step(part)  # the partial window captured in place of the full one
    step(part)
    host = Cluster(seed + 1, n2)  # the node count changes
    step(k)
    step(k)
    step(k)
    carry = kern._free_dev.cpu().numpy().copy()
    assert np.array_equal(carry, host.free)
    return outs, carry, kern


def assert_same_windows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.int64
            assert np.array_equal(a, b)


@pytest.mark.parametrize("want_ties", [True, False])
def test_cpu_kernel_never_captures(want_ties):
    """The CPU device runs every window eagerly; the windows equal
    ``_drip_batch`` applied to the same inputs one by one."""
    outs, _carry, kern = scenario("cpu", want_ties, n=300, n2=257, k=16, part=5)
    assert kern.graph_captures == kern.graph_replays == 0
    assert kern.eager_windows == kern.dispatches == 13
    assert kern._graphs.graph is None
    rng = np.random.default_rng(100)
    host = Cluster(0, 300)
    vecs = requests(rng, 16)
    got = DripBatchKernel(device="cpu").dispatch(host.sched, host.weighted, host.bounded,
                                                 host.free, vecs, want_ties=want_ties)
    t = [torch.from_numpy(a.copy()) for a in (host.sched, host.weighted, host.bounded,
                                              host.free, vecs)]
    plain, _free = drip_batch._drip_batch(*t, torch.ones(16, dtype=torch.bool),
                                          want_ties=want_ties)
    for a, b in zip(got, plain.numpy().T):
        assert np.array_equal(a, b)
    assert_same_windows(outs[:1], [got])


# -- on the card --------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("want_ties", [True, False])
def test_graph_replay_equals_eager(cuda_device, want_ties):
    got, carry, kern = scenario(cuda_device, want_ties)
    want, want_carry, ref = scenario("cpu", want_ties)
    assert_same_windows(got, want)
    assert np.array_equal(carry, want_carry)
    if want_ties:
        assert any((w[2] > 1).any() for w in want)  # the windows do tie
    # eager: the first full, the two partial windows that follow a full one,
    # the first after the n change; captured: the second full, the second
    # partial in a row, the second after the n change; the rest replay
    assert (kern.graph_captures, kern.graph_replays, kern.eager_windows) == (3, 9, 4)
    assert kern.dispatches == kern.graph_replays + kern.eager_windows == 13
    assert kern.free_uploads == ref.free_uploads == 3
    assert kern._graphs.key == (torch.device(cuda_device), 4099, 128, want_ties)


@pytest.mark.card
def test_two_kernels_capture_and_replay_from_two_threads(cuda_device):
    """Two kernels, as the threaded shard plane runs them on one card,
    dispatch at once: each capture is serialised against the other's
    dispatches and each equals its CPU twin."""
    seeds = (3, 4)
    want = [scenario("cpu", True, seed=s)[:2] for s in seeds]
    got = [None, None]
    errors = []
    start = threading.Barrier(2)

    def run(i):
        try:
            start.wait()
            got[i] = scenario(cuda_device, True, seed=seeds[i])
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for (g_outs, g_carry, kern), (w_outs, w_carry) in zip(got, want):
        assert_same_windows(g_outs, w_outs)
        assert np.array_equal(g_carry, w_carry)
        assert (kern.graph_captures, kern.graph_replays, kern.eager_windows) == (3, 9, 4)
