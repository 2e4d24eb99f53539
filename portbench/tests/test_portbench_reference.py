"""The plain reference against the program's CPU route at tiny sizes:
the whole run (set-up, window, release, check) on the CPU."""
import numpy as np
import pytest

from portbench.tests import _tiny


@pytest.mark.parametrize("seed", [2 ** 40 + 7, 3])
def test_whole_run_on_the_cpu_is_correct(seed):
    out = _tiny.run(_tiny.fl_cell(), seed=seed)
    assert out["correct"] is True, out["compared"]
    assert list(out)[-1] == "compared"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) >= {"setup_s", "peak_mem_gib"}


def test_the_same_seed_gives_the_same_inputs():
    from portbench.drivers import fl_sweep
    cell = _tiny.fl_cell()
    ref = cell.reference
    data, tr = cell.config["data"], cell.traffic
    a = ref.client_splits(data, tr["n_total"], tr["num_clients"], 77)
    b = ref.client_splits(data, tr["n_total"], tr["num_clients"], 77)
    c = ref.client_splits(data, tr["n_total"], tr["num_clients"], 78)
    assert all(np.array_equal(x, y) for x, y in zip(_flat(a), _flat(b)))
    assert not all(np.array_equal(x, y) for x, y in zip(_flat(a), _flat(c)))
    # a seed past 32 signed bits folds into the testbed's range
    big = 2 ** 31 + 12345
    assert fl_sweep.specs(cell, big)[0].testbed.seed == fl_sweep.small_seed(
        big) < 2 ** 31
    assert [s.testbed.sigma for s in fl_sweep.specs(cell, big)] == \
        tr["sigmas"]


def _flat(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _flat(v)
    else:
        yield np.asarray(tree)
