"""The cells at their own size on an NVIDIA card (marker ``cuda``; they
skip without one): a short run of each is correct; each fault that the
cell can have (``faults.py``), planted under the harness, is not; nor is
the control, the plain reference in float32 with TF32 products put in the
program's place, on three seeds.  Each test prints the numbers compared.

    python -m pytest -q -s -m cuda vrbench/tests/test_vrbench_card.py
"""

from __future__ import annotations

import json
import os

import pytest
import torch

import vrbench.run as run
from vrbench import check, gen, loop, spec
from vrbench.control import control_outputs
from vrbench.tests import faults, small

CELLS = small.cells()


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def run_on_card(cell: str, seed: int) -> dict:
    r = run.run_cell(cell, seed, 1.0, False, card(), loop.CudaClock(),
                     start=0.0, info=open(os.devnull, "w"))
    torch.cuda.empty_cache()
    return r


def show(**kw) -> None:
    print(json.dumps(kw), flush=True)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell):
    r = run_on_card(cell, 2 ** 31 + 17)
    show(cell=cell, fault=None, correct=r["correct"], checks=r["checks"])
    assert r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS
                                         for f in faults.faults_of(c)])
def test_fault_is_not_correct_on_card(monkeypatch, cell, fault):
    card()
    faults.plant(monkeypatch, cell, fault)
    r = run_on_card(cell, 2 ** 31 + 23)
    show(cell=cell, fault=fault, correct=r["correct"], checks=r["checks"])
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [101, 102, 2 ** 31 + 103])
def test_control_is_not_correct(cell, seed):
    dev = card()
    c = spec.load_cell(cell)
    pool = gen.make_pool(c.traffic, c.config, seed, dev)
    outs = control_outputs(c, pool, gen.checked_calls(c.traffic, seed))
    verdict = check.compare(outs, pool, c.config, c.traffic, c.limits)
    show(cell=cell, fault="control", seed=seed, correct=verdict["correct"],
         checks=verdict["numbers"])
    del pool, outs
    torch.cuda.empty_cache()
    assert not verdict["correct"], verdict
