"""A cell of a new traffic kind joins the benchmark through new files alone:
the kind's driver, its fault file, a traffic file that names the kind and
the cell's entry in the manifest. Nothing under ``portbench/`` is edited;
the harness takes the numbers compared, their limits and the control
that breaks the cell from the kind."""

import importlib
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

import portbench.kinds
import portbench.tests.kinds as fault_files
from portbench.harness import load_manifest, run_cell
from portbench.kinds import drip_backlog
from portbench.tests.kinds import FAULTS, planter

PORTBENCH = Path(__file__).resolve().parents[1]
NODES = 1500
SECONDS = 0.5
SEED = 4_000_000_321
KIND = "zoned_backlog"
CELL = "zoned-65k"

# a drip backlog that compares one more number, always 0
DRIVER = '''"""A drip backlog that compares one more number."""

from portbench.kinds.drip_backlog import Driver as Drip


class Driver(Drip):
    checks = Drip.checks + ("zone_mismatch",)

    @staticmethod
    def compare(got, want):
        return dict(Drip.compare(got, want), zone_mismatch=0)
'''
FAULT_FILE = '''"""The new kind's timed path is the drip window's."""

from portbench.tests.kinds.drip_backlog import plant  # noqa: F401
'''


def tree() -> dict:
    """Every file under ``portbench/`` but byte code, with its size and
    modification time."""
    return {p: (p.stat().st_size, p.stat().st_mtime_ns) for p in PORTBENCH.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def new_kind(tmp_path, monkeypatch):
    """A checkout in ``tmp_path`` whose manifest has one more cell, of a
    kind found beside ``portbench.kinds`` and ``portbench.tests.kinds``."""
    root = tmp_path / "checkout"
    for part in ("configs", "metrics", "traffic"):
        shutil.copytree(PORTBENCH / part, root / "portbench" / part)
    traffic = json.loads((PORTBENCH / "traffic" / "drip-backlog.json").read_text())
    (root / "portbench" / "traffic" / f"{CELL}.json").write_text(
        json.dumps(dict(traffic, kind=KIND)))
    manifest = load_manifest()
    manifest["workloads"].append({"name": CELL, "config": "fit-dynamic-65k", "traffic": CELL,
                                  "chips": 1, "why": "a drip backlog of a kind of its own"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for package, source in ((portbench.kinds, DRIVER), (fault_files, FAULT_FILE)):
        where = tmp_path / package.__name__
        where.mkdir()
        (where / f"{KIND}.py").write_text(source)
        monkeypatch.setattr(package, "__path__", [*package.__path__, str(where)])
    yield root
    for package in (portbench.kinds, fault_files):
        sys.modules.pop(f"{package.__name__}.{KIND}", None)


def test_a_new_kind_needs_no_edit(new_kind, monkeypatch):
    before = tree()
    manifest = load_manifest(new_kind)

    def run(controls=False):
        return run_cell(manifest, CELL, SEED, SECONDS, False, "cpu", time.perf_counter(),
                        root=new_kind, nodes=NODES, controls=controls)

    r = run(controls=True)
    assert r["correct"], r["checks"]
    assert list(r["checks"]) == [*drip_backlog.Driver.checks, "zone_mismatch"]
    assert r["checks"]["zone_mismatch"] == {"value": 0, "limit": 0}
    breaks = importlib.import_module(f"portbench.kinds.{KIND}").Driver.breaks
    assert any(v > 0 for v in r["controls"][breaks].values()), r["controls"]
    for fault in FAULTS:
        with monkeypatch.context() as m:
            planter(KIND)(m, fault)
            assert not run()["correct"], fault
    assert tree() == before


@pytest.mark.parametrize("how", ("undeclared", "left_out", "none_declared"))
def test_harness_refuses_checks_other_than_declared(monkeypatch, how):
    compare = drip_backlog.Driver.compare
    if how == "undeclared":
        monkeypatch.setattr(drip_backlog.Driver, "compare",
                            staticmethod(lambda got, want: dict(compare(got, want), extra=0)))
    elif how == "left_out":
        monkeypatch.setattr(drip_backlog.Driver, "compare", staticmethod(
            lambda got, want: {k: v for k, v in compare(got, want).items()
                               if k != "count_mismatch"}))
    else:
        monkeypatch.setattr(drip_backlog.Driver, "checks", ())
    error = TypeError if how == "none_declared" else ValueError
    with pytest.raises(error, match="extra" if how == "undeclared" else
                       "count_mismatch" if how == "left_out" else "no checks"):
        run_cell(load_manifest(), "drip-65k", SEED, SECONDS, False, "cpu", time.perf_counter(),
                 nodes=NODES)
