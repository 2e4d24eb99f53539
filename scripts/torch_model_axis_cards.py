"""``chip_smoke.py``'s [mesh-model] phase over NCCL, a card per rank.

    python3 scripts/torch_model_axis_cards.py      # needs 4 cards

Runs zamba2-1.2b (at [train-zoo]'s flags: bf16 clients, f32 master,
FedAdam, n_micro 2, per_micro 2, seq 256) and smollm-360m (the
launcher's defaults) at ``spmd --devices 4 --data-axis 2``: 2 clients,
each model tensor-parallel over 2 cards, 2 rounds; then one round of
each other family at the launcher's defaults, full width in the
config's dtype: phi-3-vision-4.2b, whisper-large-v3 and xlstm-350m at
full depth, olmoe-1b-7b at 8 of its 16 layers and qwen2-moe-a2.7b at 4
of its 24 (``chip_smoke.DEPTH``).  Each against the W = 1 run in this process
(but those of ``NO_REFERENCE``, whose W = 1 round does not fit one card:
they keep the checks that need none), with [mesh-model]'s checks
(ssd_intra_chunk per rank as W = 1 per client
at 32 heads, equal delta norms, the leaves whole on the model axis
bit-identical in each model group, zamba2's rerun bit-identical, the f32
reduced round within 1e-5 of W = 1, the full-width gradient and update
bounds) and each rank's walls, peak memory and collectives.  Exits with
the first failed requirement's message, as ``chip_smoke.py`` does.
``python3 scripts/torch_model_axis_cards.py ARCH ...`` runs the named
configurations alone.

    python3 scripts/torch_model_axis_cards.py --serve [ARCH ...]

serves (``launch/serve.py``) zamba2-1.2b and llama3.2-3b at full width
in f32 on a model axis of 4 over NCCL (``--devices 4 --data-axis 1``, a
card per rank): a prefill of 2 x 2048 tokens and 16 decode steps
teacher-forced with W = 1's greedy tokens, each rank's logits within
1e-3 of W = 1 (this process, card 0), equal tokens, 1/4 of W = 1's cache
bytes and [serve-mesh]'s launch counts (``chip_smoke._serve_mesh_check``);
then the named training configurations, if any.
"""
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as C  # noqa: E402

CONFIGS = (
    ("zamba2-1.2b", C.TRAIN_ZOO["zamba2-1.2b"], 4, 2, True),
    ("smollm-360m", [], 4, 2, False),
    ("xlstm-350m", ["--steps", "1"], 4, 2, False),
    ("phi-3-vision-4.2b", ["--steps", "1"], 4, 2, False),
    ("olmoe-1b-7b", ["--steps", "1", C.DEPTH, "8"], 4, 2, False),
    ("qwen2-moe-a2.7b", ["--steps", "1", C.DEPTH, "4"], 4, 2, False),
    ("whisper-large-v3", ["--steps", "1"], 4, 2, False),
)
# their W = 1 round (both clients on one card, ~44 B per parameter at
# zamba2's 53 GiB) does not fit a card: no full-width W = 1 run for them
NO_REFERENCE = ("phi-3-vision-4.2b", "olmoe-1b-7b", "qwen2-moe-a2.7b",
                "whisper-large-v3")
# [serve-mesh]'s entries on four cards
SERVE_CARDS = (("zamba2-1.2b", "float32", 2, 2048, 16, True),
               ("llama3.2-3b", "float32", 2, 2048, 16, True))
CARDS = 4


def _serve_rank(rank, port, out, forced):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    device = C._rank_setup(rank, CARDS, port, "nccl")
    try:
        mesh = make_host_mesh(data=1, model=CARDS)
        t0 = time.perf_counter()
        res = {"serve": C._serve_mesh_ranks(mesh, device, forced,
                                            SERVE_CARDS),
               "serve_wall": time.perf_counter() - t0}
    finally:
        dist.destroy_process_group()
    torch.save(res, out / f"rank{rank}.pt")


def phase_serve_cards(smi):
    """The ``SERVE_CARDS`` entries over NCCL on four cards vs W = 1."""
    import torch
    refs = C._serve_mesh_refs(SERVE_CARDS)
    out = ROOT / "build" / "serve_cards"
    out.mkdir(parents=True, exist_ok=True)
    C._mesh_spawn(_serve_rank, CARDS, out, [r["tokens"] for r in refs])
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(CARDS)]
    for f in out.iterdir():
        f.unlink()
    C._serve_mesh_check(smi, refs, ranks,
                        max(r["serve_wall"] for r in ranks), SERVE_CARDS,
                        "nccl, a card per rank")


def main():
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    t0 = time.perf_counter()
    _, smi = C.phase_device()
    cards = torch.cuda.device_count()
    C.require(cards >= 4, f"[model-axis-cards] {cards} card(s): needs 4")
    named = [a for a in sys.argv[1:] if a != "--serve"]
    if "--serve" in sys.argv[1:]:
        phase_serve_cards(smi)
    elif not named:
        named = [c[0] for c in CONFIGS]
    for reference in (True, False):
        C.phase_mesh_model(smi, [
            c for c in CONFIGS if c[0] in named
            and (c[0] not in NO_REFERENCE) == reference], backend="nccl",
            reference=reference)
    C.log(f"[model-axis-cards] {time.perf_counter() - t0:.1f} s in all")
    print(smi)


if __name__ == "__main__":
    main()
