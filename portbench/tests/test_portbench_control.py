"""The lower-precision control comes out not correct, and the program
correct, on the card: the cell's configuration at its published widths,
with a shorter run of its traffic (fewer updates) so that a test run
holds it.  The readings behind the limits were taken at the cell's own
size (PERF.md)."""
import dataclasses

import pytest

from portbench.harness import runner
from portbench.harness.trace import Tracer
from portbench.tests import _tiny

SHORTER = {_tiny.FL_CELL: {"max_updates": 64, "eval_every": 32}}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SHORTER))
def test_control_fails_and_program_passes_on_the_card(cuda, name):
    import torch
    bench = _tiny.bench()
    cell = bench.cell(name)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  **SHORTER[name]))
    drv = bench.driver(cell.kind)
    seed = 2 ** 33 + 5
    state = drv.setup(cell, seed, cuda)
    drv.window(state, 2.0, Tracer(False))
    torch.cuda.synchronize()
    out = drv.release(state)
    got = runner.compare(drv.readings(out, cell, seed, cuda), cell.limits)
    assert all(c["ok"] for c in got.values()), got
    low = runner.compare(drv.control(out, cell, seed, cuda), cell.limits)
    assert not all(c["ok"] for c in low.values()), low
