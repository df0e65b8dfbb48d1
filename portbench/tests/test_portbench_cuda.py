"""On the card, at each cell's own size: the program's unit of work passes
the cell's limits and the control, the plain reference with fp8 operands,
fails one of them (portbench/checks/control.py's and train_control.py's
readings, one seed)."""

from __future__ import annotations

import pytest

from portbench.checks import control, train_control
from portbench.harness import registry
from portbench.harness.registry import Cell
from portbench.reference import model as ref


def _cells(drivers):
    return [n for n in registry.names("workloads") if Cell(n).traffic["driver"] in drivers]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _cells(("generate", "serve")))
def test_control_fails_the_limit(card, name):
    cell = Cell(name)
    drv = cell.driver
    gen = drv if hasattr(drv, "program") else drv.gen
    cfg, mix = cell.config["config"], cell.traffic
    seed = 2**35 + 17
    jen1 = gen.program(cfg, seed, card)
    unit = control._unit(drv, cfg, mix, seed, card)
    got = unit.program(jen1)
    del jen1
    models = gen.reference_weights(cfg, seed, card)
    want = unit.reference(models)
    limit = cell.limits["audio_rel_err"]
    assert unit.distance(got, want) < limit
    with ref.lower_precision():
        assert unit.distance(unit.reference(models), want) > limit


@pytest.mark.cuda
@pytest.mark.parametrize("name", _cells(("train",)))
def test_train_control_fails_a_limit(card, name):
    cell = Cell(name)
    (row,) = train_control.readings(cell, [2**35 + 19], card)
    grad, update = cell.limits["grad_leaf_gap"], cell.limits["update_leaf_gap"]
    assert row["program"][1] < grad and row["program"][2] < update
    assert row["reference_fp8"][1] > grad and row["half_batch"][1] > grad
