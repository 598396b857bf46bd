"""The faults each traffic kind's timed path can have, planted for the
cell tests: ``<kind>.py`` holds ``plant(monkeypatch, fault)`` for each of
``FAULTS``, found by the ``kind`` that a cell's traffic file names, as the
harness finds the kind's driver."""

import importlib

import pytest

# a step that returns its state unchanged; half of a window left out; an
# answer altered where it is produced; one node's score altered
FAULTS = ("state_unchanged", "half_left_out", "answer_altered", "score_altered")


def planter(kind: str):
    """``plant`` of ``kind``'s fault file; a missing file fails the test
    with the name of the file to add."""
    name = f"{__name__}.{kind}"
    try:
        return importlib.import_module(name).plant
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        pytest.fail(f"no fault planters for traffic kind {kind!r}: add "
                    f"portbench/tests/kinds/{kind}.py with plant(monkeypatch, fault) "
                    f"for each of {FAULTS}")
