"""The rest of a run (no look for a card) with the timed path broken
underneath: ``correct`` has to come out false, once for each fault the
cell can have.  On one card there is no exchange between chips to
leave out, and the FL cell serves no token."""
import pytest
import torch

from portbench.tests import _tiny


def _adam_unchanged(monkeypatch):
    """A local step that returns its state unchanged."""
    from repro_torch.optim import optimizers
    monkeypatch.setattr(optimizers.Adam, "update",
                        lambda self, grads, state, params: (params, state))


def _half_batch(monkeypatch):
    """Half of each batch left out of the clipped mean, the mean taken
    over the rest."""
    from repro_torch.kernels.dp_clip import ops
    real = ops.dp_clip_mean_noise_cohort

    def half(g, clip_norm, noise_stddev=None, z=None):
        return real(g[:, :g.shape[1] // 2].contiguous(), clip_norm,
                    noise_stddev, z)
    monkeypatch.setattr(ops, "dp_clip_mean_noise_cohort", half)


@pytest.mark.parametrize("fault", [_adam_unchanged, _half_batch],
                         ids=["state-unchanged", "half-batch"])
def test_fl_sweep_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = _tiny.run(_tiny.fl_cell(), seed=11)
    assert out["correct"] is False, out["compared"]


def test_sound_runs_pass_where_the_faults_fail():
    out = _tiny.run(_tiny.fl_cell(), seed=11)
    assert out["correct"] is True, out["compared"]
    assert torch.get_default_dtype() == torch.float32
