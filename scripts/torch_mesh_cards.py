"""``chip_smoke.py``'s [mesh] phases alone, on a machine with several cards.

    python3 scripts/torch_mesh_cards.py            # 4 cards: W = 2 and 4 over NCCL

Runs, from ``chip_smoke.py``: [main] (the one-process FedAsync the mesh
is held to), [mesh-main] (W = 1 over NCCL in this process, W = 2 as two
gloo ranks on the first card, then W = 2 and W = 4 over NCCL with a card
per rank, as many as the machine has), the W = 1 [train-zoo] runs of
zamba2-1.2b and smollm-360m, and the NCCL rows of [mesh-train]
(zamba2-1.2b at W = 2, smollm-360m at W = 4, a card per rank).  Exits
with the first failed requirement's message, as ``chip_smoke.py`` does.
On one card the NCCL rows say they were not run.
"""
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as C  # noqa: E402


def main():
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    _, smi = C.phase_device()
    _, main_runs = C.phase_main_path()
    C.phase_mesh_main(smi, main_runs)
    refs = {}
    for arch in ("zamba2-1.2b", "smollm-360m"):
        first, _, st, peak, _, _ = C._train_spmd_once(
            arch, C.TRAIN_ZOO[arch], smi)
        refs[arch] = (first, st["norms"])
        C.log(f"[mesh-cards] {arch} W=1: walls per round "
              f"{[round(w, 3) for w in st['walls']]} s, peak "
              f"{peak / 2**30:.2f} GiB")
    C.MESH_TRAIN = tuple(e for e in C.MESH_TRAIN if e[3] == "nccl")
    C.phase_mesh_train(smi, refs)
    C.log(f"[mesh-cards] {time.perf_counter() - t0:.1f} s in all")
    print(smi)


if __name__ == "__main__":
    main()
