"""``python -m repro_torch.launch.train`` on the CPU: ``sim`` and ``spmd
--device cpu --reduce ...`` run and print the JAX launcher's line
formats; ``spmd`` trains (the loss falls), checkpoints a restorable
master, reruns bit-identically, runs a model axis on two gloo ranks
and refuses what is the distributed half still to port.
"""
import ast
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.launch import train
from repro_torch.pytree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the launcher's ranks compute with PyTorch's default thread count; the
# one-process run they are compared with must too
DEFAULT_THREADS = torch.get_num_threads()
SPMD = ["spmd", "--device", "cpu", "--steps", "3", "--log-every", "2",
        "--seq", "32", "--data-axis", "2", "--n-micro", "2",
        "--per-micro", "1", "--reduce", "d_model=64,n_layers=2,vocab=256"]
# the JAX launcher's f-strings (repro/launch/train.py)
SPMD_LINES = [r"\[train:spmd\] round +0 loss \d+\.\d{4}",
              r"\[train:spmd\] round +2 loss \d+\.\d{4}",
              r"\[train:spmd\] final loss \d+\.\d{4}"]
SIM_LINES = [r"\[train:sim\] fedasync: acc=\d\.\d{3} virtual_time=\d+s "
             r"updates=\{.*\}",
             r"\[train:sim\] eps=\{.*\} disparity=\d+\.\dx jain=\d\.\d{2}"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _lines(out):
    return [l for l in out.splitlines() if l.startswith("[train:")]


def test_spmd_prints_the_reference_lines_and_trains(capsys, tmp_path):
    masters = []
    for run in range(2):
        masters.append(train.run_spmd(train.build_parser().parse_args(
            SPMD + ["--ckpt-dir", str(tmp_path / f"ck{run}")])))
    lines = _lines(capsys.readouterr().out)
    assert len(lines) == 2 * (len(SPMD_LINES) + 1)
    for got, want in zip(lines, SPMD_LINES):
        assert re.fullmatch(want, got), got
    assert lines[3] == f"[train:spmd] checkpoint -> {tmp_path / 'ck0'}"
    losses = [float(l.split()[-1]) for l in lines[:3]]
    assert losses[-1] < losses[0]
    assert lines[:3] == lines[4:7]          # the rerun prints the same
    for a, b in zip(tree_leaves(masters[0]), tree_leaves(masters[1])):
        assert torch.equal(a, b)
        assert a.dtype == torch.float32     # the f32 master
    back = ckpt.restore(str(tmp_path / "ck0"), masters[0])
    for a, b in zip(tree_leaves(masters[0]), tree_leaves(back)):
        assert torch.equal(a, b)
    assert ckpt.latest_step(str(tmp_path / "ck0")) == 3


def test_spmd_on_round_sees_every_round():
    seen = []
    train.run_spmd(train.build_parser().parse_args(SPMD),
                   on_round=lambda i, m, met: seen.append(
                       (i, float(met["delta_norm"]),
                        float(met["weight_sum"]))))
    assert [s[0] for s in seen] == [0, 1, 2]
    assert all(s[1] > 0 and s[2] == pytest.approx(1.0) for s in seen)


def test_spmd_more_devices_is_the_distributed_half(tmp_path, capfd):
    """``--devices`` above ``--data-axis`` is a model axis: ``--devices 2
    --data-axis 1`` spawns two gloo ranks that train one client's model
    tensor-parallel, and its checkpoint (the master gathered whole) equals
    the one-process run's within 1e-5.  The MoE family runs on the JAX
    launcher's mesh shape, 2 clients x a model axis of 2 (olmoe at a size
    where ``2 * d_ff == d_model``, as at full width), and equals its
    one-process run within 1e-5 too.  A ``--devices`` that ``--data-axis``
    does not divide raises before any rank starts
    (``tests/test_torch_spmd.py`` runs ``--devices 2 --data-axis 2``)."""
    one_client = [a if a != "2" or SPMD[i - 1] != "--data-axis" else "1"
                  for i, a in enumerate(SPMD)]
    assert train.main(one_client + ["--devices", "2",
                                    "--ckpt-dir", str(tmp_path / "tp")]) == 0
    lines = _lines(capfd.readouterr().out)
    assert lines[0].startswith("[train:spmd] mesh {'data': 1, 'model': 2} "
                               "over 2 ranks: backend gloo, world 2")
    for got, want in zip(lines[1:], SPMD_LINES):
        assert re.fullmatch(want, got), got
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        train.main(one_client + ["--ckpt-dir", str(tmp_path / "one")])
    finally:
        torch.set_num_threads(1)
    tp, meta_tp = ckpt.load_flat(str(tmp_path / "tp"))
    one, meta_one = ckpt.load_flat(str(tmp_path / "one"))
    assert sorted(tp) == sorted(one) and len(one) > 5
    for k in one:
        np.testing.assert_allclose(tp[k], one[k], rtol=0, atol=1e-5)
    assert meta_tp["loss"] == pytest.approx(meta_one["loss"], abs=1e-5)
    moe = SPMD[:-1] + ["d_model=64,n_layers=2,vocab=256,n_heads=4,"
                       "n_kv_heads=4,d_ff=32,n_experts=8,top_k=2,"
                       "d_expert=32", "--arch", "olmoe-1b-7b"]
    capfd.readouterr()
    assert train.main(moe + ["--devices", "4",
                             "--ckpt-dir", str(tmp_path / "moe_tp")]) == 0
    assert _lines(capfd.readouterr().out)[0].startswith(
        "[train:spmd] mesh {'data': 2, 'model': 2} over 4 ranks")
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        train.main(moe + ["--ckpt-dir", str(tmp_path / "moe_one")])
    finally:
        torch.set_num_threads(1)
    tp, _ = ckpt.load_flat(str(tmp_path / "moe_tp"))
    one, _ = ckpt.load_flat(str(tmp_path / "moe_one"))
    assert sorted(tp) == sorted(one) and len(one) > 5
    for k in one:
        np.testing.assert_allclose(tp[k], one[k], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="not a multiple of --data-axis 2"):
        train.run_spmd(train.build_parser().parse_args(
            SPMD + ["--devices", "3"]))


def test_spmd_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = train.build_parser().parse_args(
        [a for a in SPMD if a not in ("--device", "cpu")])
    assert args.device is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run_spmd(args)


def test_reduce_parses_like_the_reference():
    assert train.parse_reduce("d_model=256,n_layers=4,mlp_variant=gelu") == \
        {"d_model": 256, "n_layers": 4, "mlp_variant": "gelu"}


def test_flags_are_the_reference_flags():
    """Every flag of the JAX launcher's two modes, with its default, plus
    ``--device``; ``spmd --devices`` defaults to the one device."""
    ref = (ROOT / "src" / "repro" / "launch" / "train.py").read_text()
    port = train.build_parser()
    subs = {a.dest: a for a in port._subparsers._group_actions}["mode"]
    for mode, parser in subs.choices.items():
        block = ref.split(f'{mode} = sub.add_parser(')[1].split(
            "add_parser(")[0]
        want = re.findall(r'add_argument\("(--[\w-]+)"', block)
        have = [a.option_strings[0] for a in parser._actions
                if a.option_strings and a.dest != "help"]
        assert have == want + ["--device"], mode
        for a in parser._actions:
            if not a.option_strings or a.dest in ("help", "devices",
                                                  "device"):
                continue
            m = re.search(rf'"{a.option_strings[0]}"[^)]*default=([^,)]+)',
                          block)
            assert a.default == ast.literal_eval(m.group(1)), a.dest
    assert port.parse_args(["spmd"]).devices == 1


def test_sim_runs_and_prints_the_reference_lines(tmp_path):
    log_json = tmp_path / "log.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "sim",
         "--device", "cpu", "--max-updates", "3", "--n-total", "300",
         "--batch", "16", "--eval-every", "3", "--log-json", str(log_json),
         "--ckpt-dir", str(tmp_path / "ck")],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = _lines(res.stdout)
    assert len(lines) == 3
    for got, want in zip(lines, SIM_LINES):
        assert re.fullmatch(want, got), got
    assert lines[2] == f"[train:sim] checkpoint -> {tmp_path / 'ck'}"
    log = json.loads(log_json.read_text())
    assert sum(log["updates"].values()) == 3
    assert set(log) == {"acc", "times", "eps", "updates"}
    assert np.isfinite(log["acc"]).all()
