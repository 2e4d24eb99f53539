"""``chip_smoke.py``'s [mesh-model] phase over NCCL, a card per rank.

    python3 scripts/torch_model_axis_cards.py      # needs 4 cards

Runs zamba2-1.2b (at [train-zoo]'s flags: bf16 clients, f32 master,
FedAdam, n_micro 2, per_micro 2, seq 256) and smollm-360m (the
launcher's defaults) at ``spmd --devices 4 --data-axis 2``: 2 clients,
each model tensor-parallel over 2 cards, 2 rounds, against the W = 1
run in this process, with [mesh-model]'s checks (ssd_intra_chunk per
rank as W = 1 per client at 32 heads, equal delta norms, the leaves
whole on the model axis bit-identical in each model group, zamba2's
rerun bit-identical, the f32 reduced round within 1e-5 of W = 1) and
each rank's walls, peak memory and collectives.  Exits with the first
failed requirement's message, as ``chip_smoke.py`` does.
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
)


def main():
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    t0 = time.perf_counter()
    _, smi = C.phase_device()
    cards = torch.cuda.device_count()
    C.require(cards >= 4, f"[model-axis-cards] {cards} card(s): needs 4")
    C.phase_mesh_model(smi, CONFIGS, backend="nccl")
    C.log(f"[model-axis-cards] {time.perf_counter() - t0:.1f} s in all")
    print(smi)


if __name__ == "__main__":
    main()
