"""A run of each cell on the CPU, past the harness's look for a card, with
the timed path broken underneath (``faults.py``): ``correct`` comes out
false for each fault a cell can have, and true without one."""

from __future__ import annotations

import os

import pytest

import vrbench.run as run
from vrbench import loop
from vrbench.tests import faults, small

CELLS = small.cells()
SEED = 2 ** 31 + 11
# long enough for the CPU to reach the seeded calls and a scene change
SECONDS = 1.5


def run_small(monkeypatch, cell: str, fault: str | None) -> dict:
    small.patch_small(monkeypatch)
    faults.plant(monkeypatch, cell, fault)
    return run.run_cell(cell, SEED, SECONDS, False, "cpu", loop.HostClock(),
                        start=0.0, info=open(os.devnull, "w"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(monkeypatch, cell):
    r = run_small(monkeypatch, cell, None)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS
                                         for f in faults.faults_of(c)])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    r = run_small(monkeypatch, cell, fault)
    assert not r["correct"], (fault, r["checks"])
