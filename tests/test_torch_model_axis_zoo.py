"""The rest of the model axis, on gloo ranks on the CPU: the production
round (``core/fl_step.py``) of the MoE, xLSTM, Whisper and VLM families
tensor-parallel over a model axis of 2, and the cohort engine on a model
axis, reduced, in f32.

* Two meshes: 2 ranks (data 1 x model 2) and 4 ranks (data 2 x model 2),
  each rank running every case (``tests/_torch_mesh_ranks.py``).
* Each round case is two per-microbatch SGD rounds at ``server_lr=1``
  (master + Delta), clip 1, sigma 0.5, the JAX package's noise injected
  (``tests/test_torch_train_zoo.py``'s harness).  The first round within
  1e-5 of the JAX package's one-device round; each round within 1e-5 of
  the port's one-process (W = 1) round (the second from the mesh's own
  first master, as ``tests/test_torch_model_axis.py`` holds its SGD
  rounds); ``delta_norm`` within 1e-5 relative.  Which full-width
  placement (``launch/shardings.py::leaf_spec``) each case reproduces:

  - ``olmoe``: olmoe-1b-7b's.  ``d_expert == d_model`` at the reduced
    size as ``2 * d_ff == d_model`` at full width, so the norms, the
    embedding's and lm_head's columns, wo's and w_down's outputs are cut
    on d_model, w_up/w_gate on d_expert and the router on the experts;
  - ``qwen2_moe``: the reduced qwen2-moe-a2.7b, olmoe's placement with a
    shared expert, which the reduced size cuts (full width leaves it
    whole);
  - ``qwen2_moe_rows``: qwen2-moe-a2.7b's (d_expert 128, two shared
    experts): w_down cut on its d_expert rows, wo on head_dim, the
    embedding on the vocab, the norms and the shared expert whole;
  - ``xlstm``: xlstm-350m's: the mLSTM's w_up and q/k/v on their
    outputs, its gates on the heads, ln_inner and w_down's rows on
    d_inner, the sLSTM's R* on their last dim and its FFN on its width;
  - ``whisper``: whisper-large-v3's dense placement of the encoder, the
    decoder and the cross-attention, the embedding on the vocab (and
    ``pos_dec`` on its rows, which only the reduced size cuts);
  - ``phi3``: the reduced phi-3-vision, the dense placement;
  - ``phi3_quirk``: phi-3-vision-4.2b's (``n_layers == n_heads``): the
    stacked norms cut on the layer dim.
* The new block functions against the whole ones, values and gradients
  on this rank's blocks: MoE routing (its top-k experts, capacity slots
  and keep mask equal to the whole routing's), ``moe_mlp`` with w_down
  cut on d_model and on d_expert rows, the d_model-column-cut embedding
  and loss, the mLSTM block, the sLSTM scan with its R* cut, and the VLM
  loss over text positions.
* The cohort engine: ``Session.run`` of a spec on (1, 2) and (2, 2)
  meshes, RunLog and params bit for bit the run on (1, 1) and (2, 1)
  on every rank, and a (2, 2) checkpoint written by one rank that
  resumes bit for bit.
"""
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import train
from repro_torch.launch.mesh import HostMesh
from repro_torch.launch.shardings import leaf_spec
from repro_torch.models.base import get_family
from repro_torch.pytree import tree_flatten_with_path

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_mesh_ranks as M  # noqa: E402
import test_torch_train_zoo as Z  # noqa: E402

# name -> (arch, overrides of the reduced config)
ROUNDS = {
    "olmoe": ("olmoe-1b-7b", None),
    "qwen2_moe": ("qwen2-moe-a2.7b", None),
    "qwen2_moe_rows": ("qwen2-moe-a2.7b", {"d_expert": 128,
                                           "n_shared_experts": 2}),
    "xlstm": ("xlstm-350m", None),
    "whisper": ("whisper-large-v3", None),
    "phi3": ("phi-3-vision-4.2b", None),
    "phi3_quirk": ("phi-3-vision-4.2b", M.PHI3_QUIRK),
}
# the case -> the leaves (by path) that its reduced size cuts otherwise
# than the full-width config does (every other leaf is cut alike)
FULL_PLACEMENT = {
    "olmoe": set(), "qwen2_moe_rows": set(), "xlstm": set(),
    "whisper": {"pos_dec"}, "phi3_quirk": set(),
}
MESHES = {2: 1, 4: 2}          # world -> data axis (model axis 2)
# the cohort engine's mesh shapes on each world, and its resumed run
ENGINE = {2: [None, (2, 1), (1, 2)], 4: [(2, 2)]}
TOL = 1e-5
LAUNCH_RTOL = 1e-4           # the launcher's FedAdam runs (last test)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _noise(arch, overrides):
    """The JAX round's draws (``Z.reference_noise`` of key 1) at every
    (client, leaf) the round reads, as numpy."""
    _, _, r_params, _, _, _ = Z.setup_arch(arch, overrides=overrides)
    source = Z.reference_noise(jax.random.PRNGKey(1), M.G, 1, r_params)
    shapes = [tuple(l.shape) for l in jax.tree_util.tree_leaves(r_params)]
    return {f"{c}_{j}": source(c, 0, j, s)
            for c in range(M.G) for j, s in enumerate(shapes)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX noise, then both meshes' ranks (spawned side by side, in
    the background) while this process runs the JAX package's rounds
    and the port's one-process (W = 1, no mesh) rounds."""
    noise = {name: _noise(*case) for name, case in ROUNDS.items()}
    with ThreadPoolExecutor(len(MESHES)) as pool:
        spawned = {world: pool.submit(
            M.spawn, "model_axis_zoo_ranks",
            tmp_path_factory.mktemp(f"model_axis_zoo_{world}"), world=world,
            data=data, rounds=ROUNDS, noise=noise,
            engine_shapes=ENGINE[world], launcher=world == 4,
            resume_shape=(2, 2) if world == 4 else None)
            for world, data in MESHES.items()}
        # the reference master and metrics of each case
        ref = {name: Z.run_both(arch, "per_microbatch", "sgd", 1.0,
                                overrides=ov)[0:3:2]
               for name, (arch, ov) in ROUNDS.items()}
        one = {name: M.rounds_on(None, arch, "per_microbatch", "sgd", 1.0,
                                 noise[name], overrides=ov)
               for name, (arch, ov) in ROUNDS.items()}
        launched = {arch: M.leaves_np(train.run_spmd(M.launch_args(arch)))
                    for arch in ARCH_IDS}
        ranks = {world: f.result() for world, f in spawned.items()}
    return {"noise": noise, "ranks": ranks, "ref": ref, "one": one,
            "launched": launched}


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["ranks"]


@pytest.fixture(scope="module")
def one(runs):
    return runs["one"]


@pytest.fixture(scope="module")
def noise(runs):
    return runs["noise"]


def _result(ranks, world, name, rank=0):
    res = ranks[world][rank][name]
    assert "error" not in res, res["error"]
    return res


def _reduced(arch, overrides):
    return get_config(arch).reduced().replace(param_dtype="float32",
                                              ssm_chunk=M.SEQ,
                                              **(overrides or {}))


def _model_dims(cfg, mesh):
    """Per leaf path, the dim the leaf rule cuts on the model axis."""
    params = get_family(cfg.family).init_params(cfg, 0, device="meta")
    out = {}
    for path, leaf in tree_flatten_with_path(params):
        spec = leaf_spec(tuple(leaf.shape), cfg, mesh, "master")
        out[path] = spec.index("model") if "model" in spec else None
    return out


@pytest.mark.parametrize("name", sorted(FULL_PLACEMENT))
def test_reduced_cases_keep_the_full_width_placement(name):
    """Every leaf of the case is cut on the model axis on the dim the
    full-width config's leaf is cut on, but the ones the module docstring
    names."""
    arch, ov = ROUNDS[name]
    mesh = HostMesh.abstract(2, 2)
    small = _model_dims(_reduced(arch, ov), mesh)
    big = _model_dims(get_config(arch), mesh)
    assert small.keys() == big.keys()
    differ = {"/".join(p) for p in small if small[p] != big[p]}
    assert differ == FULL_PLACEMENT[name], {
        "/".join(p): (small[p], big[p]) for p in small}
    assert sum(d is not None for d in small.values()) >= 8


@pytest.mark.parametrize("world", list(MESHES))
def test_every_family_runs_on_a_model_axis(ranks, world):
    """The mesh is data x 2, rank r at (r // 2, r % 2), and
    ``require_runnable`` passes it: the production round of all six
    families and the cohort engine run on it (the cases below)."""
    for r, res in enumerate(ranks[world]):
        assert res["mesh"] == {"data": MESHES[world], "model": 2}
        assert res["coords"] == (r // 2, r % 2)
        assert res["runnable"] is True, res["runnable"]


@pytest.mark.parametrize("case", ["route", "moe_mlp", "moe_mlp_rows",
                                  "embed_cols", "loss_cols", "mlstm",
                                  "slstm", "vlm_loss"])
@pytest.mark.parametrize("world", list(MESHES))
def test_block_functions_match_the_whole_functions(ranks, world, case):
    """Each new block function on this rank's blocks against the whole
    function: the output, and the gradients of the params (this rank's
    block of the whole gradient) and of the inputs, each within 1e-5 of
    its largest entry."""
    for res in ranks[world]:
        layers = res["layers"]
        assert "error" not in layers, layers["error"]
        value, grad = layers[case]
        assert value <= TOL and grad <= TOL, (value, grad)


@pytest.mark.parametrize("world", list(MESHES))
def test_routing_decisions_equal_the_whole_routing(ranks, world):
    """The router is cut on the experts, and the top-k experts, their
    capacity slots and the keep mask equal the whole routing's exactly."""
    for res in ranks[world]:
        layers = res["layers"]
        assert "error" not in layers, layers["error"]
        assert layers["route_decisions"] is True
        cfg = _reduced("olmoe-1b-7b", None)
        assert layers["route_cut"] == (cfg.d_model, cfg.n_experts // 2)


@pytest.mark.parametrize("world", list(MESHES))
def test_blocks_are_the_placements(ranks, world):
    """The block cases ran on the placements they name: olmoe's w_down
    cut on d_model and qwen2-moe's on d_expert rows, the table on its
    d_model columns, the sLSTM's R* on their last dim, the VLM's norms
    on the layer dim."""
    layers = ranks[world][0]["layers"]
    assert "error" not in layers, layers["error"]
    assert layers["moe_mlp_shapes"]["003"] == (4, 256, 128)     # w_down
    assert layers["moe_mlp_rows_shapes"]["004"] == (4, 64, 256)
    assert layers["table_cut"] == (512, 128)
    assert layers["slstm_shapes"]["000"] == (4, 64, 32)          # Rf
    assert layers["vlm_shapes"]["004"] == (1, 256)               # ln_attn


@pytest.mark.parametrize("name", list(ROUNDS))
@pytest.mark.parametrize("world", list(MESHES))
def test_first_round_matches_the_reference_round(runs, world, name):
    """Master + Delta within 1e-5 of the JAX package's single-device round
    from the same params, batch and noise."""
    r_master, r_met = runs["ref"][name]
    ranks = runs["ranks"]
    got = _result(ranks, world, name)["rounds"][0]
    r_leaves = jax.tree_util.tree_leaves(r_master)
    assert len(r_leaves) == len(got["master"])
    for a, b in zip(r_leaves, got["master"]):
        np.testing.assert_allclose(b, np.asarray(a), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["delta_norm"], float(r_met["delta_norm"]),
                               rtol=TOL)


@pytest.mark.parametrize("name", list(ROUNDS))
@pytest.mark.parametrize("world", list(MESHES))
def test_rounds_match_the_one_process_rounds(ranks, one, noise, world,
                                             name):
    """Each round within 1e-5 of the port's round without a mesh: the
    first from the same master, the second from the mesh's own first
    master (an SGD round at ``server_lr=1`` adds its noise to the master,
    whose next gradient magnifies the first round's ~1e-8 differences)."""
    arch, ov = ROUNDS[name]
    got = _result(ranks, world, name)["rounds"]
    ref = [one[name]["rounds"][0], M.rounds_on(
        None, arch, "per_microbatch", "sgd", 1.0, noise[name], n_rounds=1,
        start=got[0]["master"], overrides=ov)["rounds"][0]]
    for g, r in zip(got, ref):
        for a, b in zip(r["master"], g["master"]):
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
        np.testing.assert_allclose(g["delta_norm"], r["delta_norm"],
                                   rtol=TOL)
        assert g["weight_sum"] == pytest.approx(r["weight_sum"], rel=TOL)


@pytest.mark.parametrize("world", list(MESHES))
def test_metrics_masters_and_whole_leaves_equal_on_every_rank(ranks, world):
    """``delta_norm``, ``weight_sum`` and the whole master equal on every
    rank; each rank holds half of every leaf the model axis cuts, and the
    ranks of one model group hold bit-identical leaves it leaves whole."""
    for name in ROUNDS:
        res = [_result(ranks, world, name, r) for r in range(world)]
        for other in res[1:]:
            for a, b in zip(res[0]["rounds"], other["rounds"]):
                assert a["delta_norm"] == b["delta_norm"]
                assert a["weight_sum"] == b["weight_sum"]
                for x, y in zip(a["master"], b["master"]):
                    assert np.array_equal(x, y)
        dims = res[0]["model_dims"]
        whole = res[0]["rounds"][-1]["master"]
        for lead in range(0, world, 2):
            a, b = res[lead], res[lead + 1]
            for j, d in enumerate(dims):
                if d is None:
                    assert np.array_equal(a["blocks"][j], b["blocks"][j])
                else:
                    assert a["blocks"][j].shape[d] * 2 == whole[j].shape[d]


@pytest.mark.parametrize("world", list(MESHES))
def test_collectives_ran_over_the_model_group(ranks, world):
    """Every round case moved data over the ranks (all-gathers and
    all-reduces, counted in ``collectives.stats()``)."""
    for name in ROUNDS:
        st = ranks[world][0][name + ":collectives"]
        assert st["all_gather"]["calls"] > 0 and st["all_reduce"]["calls"] > 0
        assert st["all_gather"]["bytes"] > 0


@pytest.mark.parametrize("world", list(MESHES))
def test_collectives_take_strided_tensors(ranks, world):
    """A strided tensor (the gradient of a chunk's view, which reaches
    ``tp_copy``'s backward in the mLSTM) is summed over the model group
    into a contiguous buffer, as NCCL requires."""
    want = (np.arange(12.0).reshape(3, 4)[:, 1:3] * 3).tolist()
    for res in ranks[world]:
        got = res["strided"]
        assert "error" not in got, got["error"]
        assert got == {"sum": want, "contiguous": True}


def _engine(ranks, world, rank):
    res = ranks[world][rank]["engine"]
    assert "error" not in res, res["error"]
    return res


def _same_run(a, b):
    assert a["log"] == b["log"]
    assert len(a["params"]) == len(b["params"]) > 5
    for x, y in zip(a["params"], b["params"]):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("world", list(MESHES))
def test_cohort_engine_on_a_model_axis_is_the_data_axis_run(ranks, world):
    """``Session.run`` on (1, 2) equals the run without a mesh, and on
    (2, 2) the run on (2, 1), bit for bit in RunLog (engine stats
    included) and params, on every rank: every model rank of a data
    coordinate trains that coordinate's members."""
    pairs = {2: [((1, 2), None)], 4: [((2, 2), (2, 1))]}[world]
    for r in range(world):
        got = _engine(ranks, world, r)
        for shape, base in pairs:
            want = (got if world == 2
                    else _engine(ranks, 2, r // 2))[base]
            assert got[shape]["mesh"] == dict(zip(("data", "model"), shape))
            assert got[shape]["coords"] == (r // 2 if shape[0] == 2 else 0,
                                            r % 2)
            _same_run(got[shape], want)


@pytest.mark.parametrize("world", [4])
def test_a_model_axis_checkpoint_has_one_writer_and_resumes(ranks, world):
    """A (2, 2) run crashed after its first snapshot and resumed equals
    the uninterrupted run on every rank; rank 0 alone wrote the
    snapshot."""
    writes = []
    for r in range(world):
        got = _engine(ranks, world, r)
        _same_run(got["resume"], got[(2, 2)])
        writes.append(got["resume"]["writes"])
    assert writes[0] == [4] and writes[1:] == [[]] * (world - 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spmd_runs_every_config_on_the_launchers_mesh(runs, arch):
    """``spmd --devices 4 --data-axis 2`` (2 clients x a model axis of 2)
    trains every zoo config at a small size, the Whisper and VLM families
    with their stub inputs: its final master on each rank finite and,
    leaf by leaf, within 1e-4 relative L2 of the one-process run's
    (``--devices 1``).  The launcher's FedAdam magnifies the rounds'
    ~1e-7 differences in its second step (largest reading 2.1e-5, on
    zamba2); a gradient that missed a rank's terms moves a leaf by its
    update, some 1e-2 of its norm."""
    want = runs["launched"][arch]
    for r in range(4):
        got = runs["ranks"][4][r]["launcher"]
        assert "error" not in got, got["error"]
        assert len(got[arch]) == len(want)
        for a, b in zip(got[arch], want):
            assert np.isfinite(a).all()
            assert np.linalg.norm(a - b) <= LAUNCH_RTOL * np.linalg.norm(b)
