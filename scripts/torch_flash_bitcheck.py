"""Whether two checkouts of the PyTorch port's ``flash_decode`` CUDA
kernel give the same bits, on one card.

    python scripts/torch_flash_bitcheck.py ROOT_A ROOT_B

For each root, a fresh process imports ``repro_torch`` and
``chip_smoke`` from that root, builds its kernels (each root into its own
``build/cuda/<hash>``) and runs ``flash_decode`` on every case of that
root's ``chip_smoke.FLASH_CASES`` in bf16 and f32, on the inputs
``chip_smoke._flash_inputs`` draws from seed 0.  It prints a SHA-256 of
each output; the parent process compares them case by case and exits
with 1 if any differs.  Run it with the parent commit unpacked under a
git-ignored directory (``git archive <sha> | tar -x -C build/parent``)
to show that a change kept the existing instantiations bit-identical.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path


def _child(root: str) -> dict:
    sys.path[:0] = [str(Path(root) / "src"), str(root)]
    import torch
    import chip_smoke
    from repro_torch.kernels.flash_attn import flash_attn
    dev = torch.device("cuda")
    out = {}
    for case in chip_smoke.FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, pos = chip_smoke._flash_inputs(case, dtype, dev)
            got = flash_attn.flash_decode(q, k, v, pos, window=case[5],
                                          softcap=case[6])
            data = got.float().cpu().contiguous().numpy().tobytes()
            out[f"{case[:7]} {str(dtype)[6:]}"] = \
                hashlib.sha256(data).hexdigest()[:16]
    return out


def main():
    if sys.argv[1] == "--child":
        print(json.dumps(_child(sys.argv[2])))
        return
    a, b = sys.argv[1:3]
    runs = {}
    for root in (a, b):
        res = subprocess.run([sys.executable, __file__, "--child", root],
                             capture_output=True, text=True, check=True)
        runs[root] = json.loads(res.stdout.strip().splitlines()[-1])
    same = [k for k in runs[a] if runs[a][k] == runs[b].get(k)]
    for k in runs[a]:
        print(f"{'same' if k in same else 'DIFFERS'} {k} {runs[a][k]} "
              f"{runs[b].get(k)}")
    print(f"{len(same)} of {len(runs[a])} outputs bit-identical")
    sys.exit(0 if len(same) == len(runs[a]) else 1)


if __name__ == "__main__":
    main()
