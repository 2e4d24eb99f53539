"""ROADMAP.md queue 1 item 18 on the CPU: ``optim.make_optimizer``, the
SER CNN's train-mode dropout, and the three SER examples.

* ``make_optimizer`` gives the port's ``Adam`` / ``SGD`` with the given
  hyperparameters and raises ``ValueError(name)`` on any other name, as
  the JAX package's does.
* ``ser_cnn.apply(train=True)`` with the JAX package's keep masks
  injected (``jax.random.split(rng, 3)``, one ``jax.random.bernoulli``
  per dropout site) is within 1e-5 of the JAX package's train-mode
  logits from the same params; ``train=False`` (and ``train=True`` with
  no source) is the deterministic forward.  A mask drawn from a
  ``torch.Generator`` keeps a share within binomial bounds of
  ``1 - rate``, and the same seed draws the same masks.
* ``examples/torch_quickstart.py``, ``torch_privacy_sweep.py`` and
  ``torch_fl_ser_tradeoff.py`` run their main paths on the CPU
  (``--device cpu``) at a cut depth and print the reference examples'
  lines; each carries ``--device``, default ``cuda``.
"""
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ser_cnn as r_ser
import repro.optim.optimizers as r_opt
from repro_torch.models import convert
from repro_torch.models import ser_cnn as t_ser
from repro_torch.optim import optimizers as t_opt

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
TOL = 1e-5


@pytest.mark.parametrize("name,kw,cls", [
    ("adam", {"lr": 3e-4, "b1": 0.8, "b2": 0.95, "eps": 1e-7}, "Adam"),
    ("sgd", {"lr": 0.05, "momentum": 0.9}, "SGD"),
])
def test_make_optimizer_builds_the_ported_optimizer(name, kw, cls):
    opt = t_opt.make_optimizer(name, **kw)
    assert type(opt) is getattr(t_opt, cls)
    assert all(getattr(opt, k) == v for k, v in kw.items())
    ref = r_opt.make_optimizer(name, **kw)
    assert type(ref).__name__ == cls


def test_make_optimizer_raises_on_an_unknown_name():
    with pytest.raises(ValueError) as ref:
        r_opt.make_optimizer("adagrad", lr=0.1)
    with pytest.raises(ValueError) as got:
        t_opt.make_optimizer("adagrad", lr=0.1)
    assert str(got.value) == str(ref.value) == "adagrad"


def _ser_inputs(seed=0):
    cfg = t_ser.SERConfig()
    params = t_ser.init(seed, cfg)
    x = np.random.default_rng(seed).standard_normal(
        (cfg.time_frames, cfg.n_mels)).astype(np.float32)
    r_params = jax.tree_util.tree_map(jnp.asarray,
                                      convert.params_to_numpy(params))
    return cfg, params, r_params, x


def _reference_masks(cfg, key):
    """The keep masks ``repro.models.ser_cnn.apply(train=True, rng=key)``
    draws, site by site."""
    rngs = jax.random.split(key, 3)
    t = cfg.time_frames
    shapes = [(t // 2, cfg.channels1), (t // 4, cfg.channels2),
              (cfg.fc_dim,)]
    rates = [cfg.drop1, cfg.drop2, cfg.drop_fc]
    return [np.asarray(jax.random.bernoulli(k, 1.0 - r, s))
            for k, r, s in zip(rngs, rates, shapes)]


@pytest.mark.parametrize("seed", [0, 3])
def test_train_mode_dropout_matches_the_reference_masks(seed):
    cfg, params, r_params, x = _ser_inputs(seed)
    r_cfg = r_ser.SERConfig()
    key = jax.random.PRNGKey(seed + 11)
    want = np.asarray(r_ser.apply(r_params, jnp.asarray(x), r_cfg,
                                  train=True, rng=key))
    got = t_ser.apply(params, torch.from_numpy(x), cfg, train=True,
                      masks=[torch.from_numpy(np.array(m)) for m in
                             _reference_masks(cfg, key)])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    plain = np.asarray(r_ser.apply(r_params, jnp.asarray(x), r_cfg))
    assert np.abs(want - plain).max() > 1e-3     # the masks took effect
    xt = torch.from_numpy(x)
    det = t_ser.apply(params, xt, cfg)
    for kw in ({"train": False, "rng": torch.Generator().manual_seed(1)},
               {"train": True}):
        assert torch.equal(t_ser.apply(params, xt, cfg, **kw), det)
    np.testing.assert_allclose(det.numpy(), plain, rtol=TOL, atol=TOL)


def test_drawn_masks_keep_their_share_and_repeat_by_seed():
    rate, n = 0.3, 200_000
    x = torch.ones(n)
    out = t_ser._dropout(x, rate, 0, torch.Generator().manual_seed(5))
    kept = int((out != 0).sum())
    sd = (n * rate * (1 - rate)) ** 0.5
    assert abs(kept - n * (1 - rate)) < 5 * sd
    assert torch.allclose(out[out != 0], torch.tensor(1 / (1 - rate)))
    again = t_ser._dropout(x, rate, 0, torch.Generator().manual_seed(5))
    assert torch.equal(out, again)
    cfg, params, _, xs = _ser_inputs()
    runs = [t_ser.apply(params, torch.from_numpy(xs), cfg, train=True,
                        rng=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_examples_default_to_the_card():
    for name in ("torch_quickstart", "torch_privacy_sweep",
                 "torch_fl_ser_tradeoff"):
        src = (EXAMPLES / f"{name}.py").read_text()
        assert 'add_argument("--device", default="cuda"' in src
        assert "import repro." not in src and "jax" not in src


def test_quickstart_runs_on_the_cpu(capsys, threads):
    log_avg, log_as = _example("torch_quickstart").main(
        ["--device", "cpu"], rounds=1, max_updates=5)
    out = capsys.readouterr().out
    for line in ("== FedAvg (synchronous, straggler-bound) ==",
                 "== FedAsync (alpha=0.4, staleness-aware) ==",
                 "eps (uniform):", "updates per tier:", "eps per tier:",
                 "privacy disparity (max/min eps):",
                 "Jain participation index:"):
        assert line in out
    assert set(log_avg.update_counts.values()) == {1}
    assert sum(log_as.update_counts.values()) == 5


def test_privacy_sweep_runs_on_the_cpu(capsys, threads):
    mod = _example("torch_privacy_sweep")
    eps = mod.analytic()
    from repro_torch.core.accountant import compute_epsilon
    assert eps[1.0][0] == compute_epsilon(mod.Q, 1.0, 9 * 7, mod.DELTA)
    result, session = mod.trained(2, "cpu", eval_every=1)
    out = capsys.readouterr().out
    assert "per-sigma disparity (max eps / min eps):" in out
    assert "measured sigma sweep (FedAsync alpha=0.2, 2 updates" in out
    assert out.count("  sigma=") == 3 * len(mod.SIGMAS)
    assert [p["testbed.sigma"] for p in result.points] == list(mod.SIGMAS)
    assert session.stats()["partition_builds"] == 1


def test_fl_ser_tradeoff_runs_on_the_cpu(tmp_path, capsys, threads):
    out_file = tmp_path / "tradeoff.json"
    out = _example("torch_fl_ser_tradeoff").main(
        ["--device", "cpu", "--target", "0.3", "--out", str(out_file)],
        rounds=1, max_updates=5, alphas=(0.4,))
    text = capsys.readouterr().out
    assert "[driver] FedAvg to 30% (cohort backend) ..." in text
    assert "alpha=0.4: time-to-target" in text
    saved = json.loads(out_file.read_text())
    assert set(saved["runs"]) == {"fedavg", "fedasync_a0.4"} == set(
        out["runs"])
    assert saved["backend"] == "cohort" and len(saved["sweep_table"]) == 1
