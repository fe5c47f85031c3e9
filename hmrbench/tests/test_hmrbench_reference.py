"""The plain reference agrees with the port at tiny widths (the port run in
float32 with the plain scene encoder, as the reference runs), and the
control, the reference one precision below the configuration, fails the
cell's limits."""
import math

import pytest
import torch
import tiny_cells

from hmrbench import control
from hmrbench.lib import common, judge

CELLS = ["egohmr-ddim5-bulk", "prohmr-flow"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell):
    res = tiny_cells.run(cell, f32=True, seed=21)
    assert res["correct"]
    for name, c in res["checks"].items():
        assert c["value"] < 1e-4, (name, c)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    readings = control.readings(cell, 23, torch.device("cpu"),
                                overrides=tiny_cells.overrides(cell))["control"]
    limits = common.cell_files(cell)["workload"]["check"]["limits"]
    checks = judge.held(readings, limits)
    assert not all(c["ok"] for c in checks), checks
    assert all(math.isfinite(c["value"]) for c in checks)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_at_the_cells_size(cell):
    """The control at the cell's own size, on the card: what the limits
    were set from (`hmrbench/control.py` reads more seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's size is the card's work")
    readings = control.readings(cell, 24, torch.device("cuda", 0))["control"]
    checks = judge.held(readings, common.cell_files(cell)["workload"]["check"]["limits"])
    assert not all(c["ok"] for c in checks), checks
