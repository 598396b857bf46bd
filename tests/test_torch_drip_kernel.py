"""The drip window's step kernel (``csrc/drip_step.cu``, launched by
``scorer.drip_step.drip_window``).

On the CPU: the launcher's checks, and a CPU ``DripBatchKernel`` that never
loads the kernel's library. Tests marked ``card`` need a CUDA device and
skip without one; there the kernel's windows, launched directly, captured
and replayed through ``DripBatchKernel``, and from two threads at once,
equal ``_drip_batch`` / ``_drip_batch_numa`` on CPU tensors bit for bit:
every output row and both folded carries. The inputs hold equal maxima in
different blocks, windows with no feasible node, inactive pods, node counts
below one block and off its multiple, one to eight zone columns,
overcommitted zones, and aware, non-aware and zero-request pods. This file
imports nothing of JAX, so on the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_drip_kernel.py -q
"""

import ctypes
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from crane_scheduler_tpu_torch.scorer import drip_batch, drip_step
from crane_scheduler_tpu_torch.scorer.drip_batch import DripBatchKernel, numa_pod_rows

NO_ZONE = -(1 << 62)  # ZoneColumns' key past a node's zones
NRT_WEIGHT = 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", torch.cuda.current_device())


# -- inputs -------------------------------------------------------------------------


def window_inputs(seed, n, k, z=0, case="random"):
    """Host inputs of one window: ``(cols, zones)`` with ``cols`` the
    plain window's six arrays and ``zones`` ``(zcols, used, pods)`` or
    None for ``z == 0``. ``case``: "random"; "infeasible" (no schedulable
    row); "tied_blocks" (the rows ``top_rows(n)``, in different blocks of
    256 where ``n`` has them, feasible for every pod at one score above
    every other row's)."""
    rng = np.random.default_rng(seed)
    sched = rng.random(n) < 0.85
    weighted = rng.integers(0, 12, n).astype(np.int64) * 3
    bounded = rng.random(n) < 0.9
    free = np.stack([rng.integers(0, 6000, n), rng.integers(0, 16 << 30, n),
                     rng.integers(0, 1 << 20, n), rng.integers(0, 6, n)], axis=1).astype(np.int64)
    vecs = np.stack([rng.choice([0, 100, 2000], k), rng.choice([0, 1 << 30], k),
                     np.zeros(k, np.int64), np.ones(k, np.int64)], axis=1).astype(np.int64)
    active = np.ones(k, dtype=bool)
    active[k - min(3, k - 1):] = False  # padded pods, as the reference pads a window
    if case == "infeasible":
        sched[:] = False
    top = top_rows(n) if case == "tied_blocks" else []
    weighted[top] = 999  # others reach at most 33 + the NRT table's 200
    sched[top] = True
    bounded[top] = False
    cols = [sched, weighted, bounded, free, vecs, active]
    if z == 0:
        return cols, None
    zones_of = rng.integers(1, z + 1, n)
    zkey = rng.integers(0, 9, (n, z)).astype(np.int64) * 1000 + rng.choice([0, 500], (n, z))
    zkey[np.arange(z)[None, :] >= zones_of[:, None]] = NO_ZONE
    zcap = np.where(zkey > NO_ZONE, zkey // 1000 * 1000, 0)
    used = rng.choice([0, 0, 1000, 2000, 12000], (n, z)).astype(np.int64)  # 12000: overcommitted
    used[zkey == NO_ZONE] = 0
    has = rng.random(n) < 0.9
    static = rng.random(n) < 0.85
    has[top] = True  # a CR that NRT leaves alone: no Filter, table entry z + 1 (0)
    static[top] = False
    naw = static & (rng.random(n) < 0.3)
    req = rng.choice([0, 1000, 2000, 4000, 7000], k)
    aware = rng.choice([-1, 0, 1], k)
    pods = numa_pod_rows(req, aware, NRT_WEIGHT, z)
    return cols, ((zkey, zcap, has, static, naw), used, pods)


def top_rows(n):
    return sorted({r for r in (n // 3 + 256, n - 1) if r < n})


def tensors(cols, zones, dev):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cols = [t(a) for a in cols]
    if zones is None:
        return cols, None
    zcols, used, pods = zones
    return cols, (tuple(t(a) for a in zcols), t(used), t(pods))


def plain_window(cols, zones, want_ties):
    """The PyTorch window on CPU tensors: outs and the folded carries."""
    c, zs = tensors(cols, zones, "cpu")
    if zs is None:
        return drip_batch._drip_batch(*c, want_ties=want_ties)
    return drip_batch._drip_batch_numa(*c, *zs, want_ties=want_ties)


def kernel_window(cols, zones, want_ties, dev, scratch):
    """The kernel's window on ``dev``: outs and the carries, folded in
    place, as CPU tensors."""
    c, zs = tensors(cols, zones, dev)
    outs = drip_step.drip_window(*c, scratch, want_ties, zones=zs)
    carries = (c[3],) if zs is None else (c[3], zs[1])
    return tuple(x.cpu() for x in (outs, *carries))


# -- on the CPU ---------------------------------------------------------------------


@pytest.fixture
def no_library(monkeypatch):
    """The step kernel's library may not be loaded (or built) meanwhile."""

    def load():
        raise AssertionError("the CUDA step kernel's library was loaded")

    monkeypatch.setattr(drip_step.KERNEL, "_function", load)
    return drip_step.KERNEL.launches


def test_cpu_kernel_never_loads_the_step_kernel(no_library):
    """A CPU ``DripBatchKernel`` runs both windows through PyTorch: the
    CUDA library stays unloaded and ``kernel_windows`` stays 0."""
    kern = DripBatchKernel(device="cpu")
    cols, _ = window_inputs(0, 300, 8)
    for _ in range(3):
        kern.dispatch(*cols[:5], want_ties=True)
    cols, (zcols, used, pods) = window_inputs(1, 300, 8, z=2)
    zones = SimpleNamespace(zkey=zcols[0], zcap=zcols[1], has=zcols[2], active=zcols[3],
                            act_naw=zcols[4], used=used, epoch=0)
    for _ in range(3):
        kern.dispatch_numa(*cols[:5], zones, pods, want_ties=False)
    assert kern.dispatches == kern.eager_windows == 6
    assert kern.kernel_windows == 0
    assert kern._scratch is None
    assert drip_step.KERNEL.launches == no_library


def _launch_args(z=0):
    cols, zones = window_inputs(2, 40, 4, z=z)
    return tensors(cols, zones, "cpu")


def _bad_dtype(c, zs):
    c[1] = c[1].to(torch.int32)  # weighted


def _bad_dtype_zone(c, zs):
    zcols, used, pods = zs
    return c, ((zcols[0], zcols[1], zcols[2].to(torch.uint8), zcols[3], zcols[4]), used, pods)


def _strided(c, zs):
    c[3] = torch.cat([c[3], c[3]], dim=1)[:, ::2]  # free, one row in two columns


def _strided_zone(c, zs):
    zcols, used, pods = zs
    return c, (zcols, torch.cat([used, used], dim=1)[:, ::2], pods)


@pytest.mark.parametrize("z, spoil, error, match", [
    (0, None, ValueError, "CUDA device"),  # valid CPU tensors
    (2, None, ValueError, "CUDA device"),
    (0, _bad_dtype, TypeError, "weighted must be torch.int64"),
    (2, _bad_dtype_zone, TypeError, "has must be torch.bool"),
    (0, _strided, ValueError, "free must be contiguous"),
    (2, _strided_zone, ValueError, "used must be contiguous"),
], ids=["cpu", "cpu-zones", "dtype", "dtype-zones", "strided", "strided-zones"])
def test_launcher_raises_before_it_launches(no_library, z, spoil, error, match):
    c, zs = _launch_args(z)
    if spoil is not None:
        got = spoil(c, zs)
        if got is not None:
            c, zs = got
    with pytest.raises(error, match=match):
        drip_step.drip_window(*c, None, True, zones=zs)
    assert drip_step.KERNEL.launches == no_library


def test_launcher_checks_shapes(no_library):
    c, zs = _launch_args(2)
    zcols, used, pods = zs
    with pytest.raises(ValueError, match="pods"):
        drip_step.drip_window(*c, None, True, zones=(zcols, used, pods[:, :-1].contiguous()))
    with pytest.raises(ValueError, match="vecs"):
        drip_step.drip_window(c[0], c[1], c[2], c[3], c[4][:, :3].contiguous(), c[5], None)


def test_args_structure_lays_pointers_then_ints():
    """``DripArgs`` matches the C structure: 16 pointers, then 3 ints."""
    fields = [f for f, _t in drip_step.DripArgs._fields_]
    assert fields[:16] == ["sched", "weighted", "bounded", "free", "vecs", "active", "outs",
                           "scratch", "ticket", "zkey", "zcap", "has", "zactive", "act_naw",
                           "used", "pods"]
    assert [f for f, _t in drip_step.DripArgs._fields_[16:]] == ["n", "z", "want_ties"]
    assert drip_step.DripArgs.n.offset == 16 * 8
    assert ctypes.sizeof(drip_step.DripArgs) == 16 * 8 + 16  # 3 ints, padded to 8 bytes


# -- on the card --------------------------------------------------------------------


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int64
        assert torch.equal(g, w)


CASES = [
    # (n, k, z, case)
    (1, 6, 0, "random"),
    (100, 16, 0, "random"),  # below one block
    (256, 16, 0, "tied_blocks"),
    (257, 16, 0, "random"),  # one past a block
    (4099, 32, 0, "tied_blocks"),
    (4099, 32, 0, "infeasible"),
    (65000, 16, 0, "random"),
    (1, 6, 1, "random"),
    (100, 16, 1, "random"),
    (257, 16, 2, "tied_blocks"),
    (4099, 32, 2, "random"),
    (4099, 32, 2, "infeasible"),
    (1000, 32, 3, "random"),
    (1000, 32, 4, "tied_blocks"),
    (777, 16, 8, "random"),
    (65000, 16, 2, "random"),
]


@pytest.mark.card
@pytest.mark.parametrize("want_ties", [True, False])
@pytest.mark.parametrize("n, k, z, case", CASES)
def test_kernel_window_equals_plain(cuda_device, n, k, z, case, want_ties):
    cols, zones = window_inputs(n * 31 + k + z, n, k, z, case)
    want = plain_window(cols, zones, want_ties)
    got = kernel_window(cols, zones, want_ties, cuda_device, drip_step.StepScratch(cuda_device))
    assert_same(got, want)
    outs = want[0]
    if case == "infeasible":
        assert (outs[:, 0] == -1).all() and (outs[:, 1] == 0).all()
    if case == "tied_blocks":
        top = top_rows(n)
        assert int(outs[0, 0]) == top[0]  # the lowest index among equal maxima
        assert int(outs[0, 2]) == (len(top) if want_ties else 1)
    if z and case == "random" and n >= 100:
        assert (outs[:, 4:] > 0).any()  # zone takes folded


@pytest.mark.card
def test_one_scratch_serves_windows_back_to_back(cuda_device):
    """The ticket returns to 0 after every launch: windows of other shapes
    and zone counts share one scratch."""
    scratch = drip_step.StepScratch(cuda_device)
    for i, (n, k, z) in enumerate([(5000, 64, 0), (300, 8, 2), (5000, 64, 3), (1, 4, 0)]):
        cols, zones = window_inputs(50 + i, n, k, z)
        assert_same(kernel_window(cols, zones, True, cuda_device, scratch),
                    plain_window(cols, zones, True))
    assert int(scratch.ticket.item()) == 0


class NumaHost:
    """A host side of the NRT window: columns, zone columns under an
    epoch, both carries folded after an accepted window."""

    def __init__(self, seed, n, z):
        cols, (zcols, used, _pods) = window_inputs(seed, n, 1, z)
        self.sched, self.weighted, self.bounded, self.free = cols[:4]
        self.zones = SimpleNamespace(zkey=zcols[0], zcap=zcols[1], has=zcols[2],
                                     active=zcols[3], act_naw=zcols[4], used=used, epoch=1)
        self.z = z

    def dispatch(self, kern, seed, k, want_ties, accept=True):
        cols, (_z, _u, pods) = window_inputs(seed, 1, k, self.z)
        vecs = cols[4]
        out = kern.dispatch_numa(self.sched, self.weighted, self.bounded, self.free, vecs,
                                 self.zones, pods, want_ties=want_ties)
        if accept:
            for i, c in enumerate(out[0]):
                if c >= 0:
                    self.free[c] -= vecs[i]
                    self.zones.used[c] += out[4][i]
            kern.mark_synced(self.free, self.zones.used)
        else:
            kern.mark_desynced()
        return out


def numa_scenario(device, want_ties, seed=0, n=4099, z=2, k=64, part=9):
    """Nine NRT windows on one kernel: eager, captured, replayed, a partial
    window, a rejected one. Returns each window's outputs, both final
    carries and the kernel."""
    kern = DripBatchKernel(device=device)
    host = NumaHost(seed, n, z)
    outs = []
    for i, (kk, accept) in enumerate([(k, True), (k, True), (k, True), (part, True),
                                      (k, True), (k, False), (k, True), (k, True),
                                      (k, True)]):
        outs.append(host.dispatch(kern, seed * 100 + i, kk, want_ties, accept))
    free = kern._free_dev.cpu().numpy().copy()
    used = kern._used_dev.cpu().numpy().copy()
    assert np.array_equal(free, host.free) and np.array_equal(used, host.zones.used)
    return outs, (free, used), kern


def assert_same_windows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.int64
            assert np.array_equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("want_ties", [True, False])
def test_numa_graph_replay_equals_cpu(cuda_device, want_ties):
    got, carries, kern = numa_scenario(cuda_device, want_ties)
    want, want_carries, ref = numa_scenario("cpu", want_ties)
    assert_same_windows(got, want)
    for a, b in zip(carries, want_carries):
        assert np.array_equal(a, b)
    assert any((w[4] > 0).any() for w in want)
    # eager: the first and the partial window; captured: the second; the
    # rest replay
    assert (kern.graph_captures, kern.graph_replays, kern.eager_windows) == (1, 7, 2)
    assert kern.kernel_windows == kern.dispatches == 9
    assert ref.kernel_windows == 0
    assert kern.free_uploads == ref.free_uploads == 2


@pytest.mark.card
def test_two_numa_kernels_from_two_threads(cuda_device):
    """Two kernels on one card, each with its own scratch, dispatch at
    once: each equals its CPU twin."""
    seeds = (3, 4)
    want = [numa_scenario("cpu", True, seed=s)[:2] for s in seeds]
    got = [None, None]
    errors = []
    start = threading.Barrier(2)

    def run(i):
        try:
            start.wait()
            got[i] = numa_scenario(cuda_device, True, seed=seeds[i])
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert not errors, errors
    for (g_outs, g_carries, kern), (w_outs, w_carries) in zip(got, want):
        assert_same_windows(g_outs, w_outs)
        for a, b in zip(g_carries, w_carries):
            assert np.array_equal(a, b)
        assert kern.kernel_windows == kern.dispatches
    assert got[0][2]._scratch is not got[1][2]._scratch
